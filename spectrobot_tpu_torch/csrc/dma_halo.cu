// Fused halo accumulation over peer memory: the CUDA port of the TPU kernel
// benchmarks/dma_halo.py:_fused_kernel.  One launch per call, one shard of
// a 1-D nu ring per rank (or all n shards of the loopback ring):
//
//   out[o, p] = sum over own lines and the neighbours' lines of
//               amps[o, i] * Re w(x_ip, y_i) * [|dnu| <= cutoff]
//
// with each shard's lines as rows nu_c, scale_x, y [L] and amps [n_out, L].
// The order of work is the reference's (:124-193):
//   1. the neighbour barrier: each shard tells the shards that send to it
//      that its receive buffers are free for this call (the epoch);
//   2. the remote stores of the shard's rows, as one payload [3 + n_out, L]
//      followed by the center range of each line block, into the right
//      neighbour's recv[0] and, with more than two shards, the left one's
//      recv[1];
//   3. the line sum of the shard's own lines, while the copies fly;
//   4. the wait for the arrival of both neighbours' payloads;
//   5. the line sum of the received halos.
// Static ring degeneracies as the reference's (:140-141): one shard makes
// no exchange; two shards make one (their neighbours coincide, or the halo
// would count them twice).  The protocol is csrc/peer_ring.cuh's.
//
// The line sums are K3's loop (csrc/line_sum_item.cuh: K1's and K3's
// per-pair code and tier decision, runs of lines within reach of each
// tile, one point a thread), read through L2 alone, as a peer may have
// just stored the rows.
//
// What bounds it: the instructions K3's per-pair loop issues on the CUDA
// cores for the in-cutoff pairs (FP32 arithmetic and the loads, tests and
// loop control around it; the few sub-blocks that overlap a tile take the
// near tiers' code); the copies are a few hundred KB a call.  What held
// the first design was the walk, not the pairs: every item staged every
// line block of its source, though a tile's cutoff reaches few of them
// (the dense case: 3,219 of 24,576 block visits hold a line within reach;
// a shard's rows end in padding, and the wrapped neighbour of a ring end
// lies wholly beyond the cutoff), its segments were cut on all of those
// blocks, its items were dealt to the blocks in turn, and a second kernel
// added the partial sums.  The design:
//  * Windows found on the device.  A host cannot know its neighbours'
//    centers, so the shard that owns the rows finds each line block's
//    center range [min, max] once per call, first in the launch (a range
//    item), and sends the ranges behind its rows: received halos carry
//    their own.  An item walks only the blocks whose range reaches its
//    tile (a rounded gap against the cutoff plus 4 ulps, K1's test, exact
//    for a range as for a line: a block left out holds no pair within the
//    cutoff, sorted or not); a block left out costs two floats read.
//  * Segments cut on that work: each (shard, source, tile) finds the hull
//    of its blocks within reach and cuts it into n_seg segments, one item
//    each, and the blocks take the items as they come free (a work
//    counter), so no block runs a chain of heavy items while others idle.
//  * One launch, one kernel: each item writes its segment's partial sums,
//    and the last item of a (shard, tile) to arrive (an atomic count;
//    counters zero between calls) adds them in a fixed order, own
//    segments, then the left halo's, then the right halo's:
//    deterministic, no atomics on values.
//  * The rows, the grid and the output are read and written where the
//    caller keeps them (pointers and strides; padding in registers), so
//    the wrapper allocates and launches and does nothing else.
// A persistent, cooperative grid (every block resident, so a waiting block
// never keeps a copying block from running) takes the items from one list:
// range items, copy chunks, own items, halo items.  An item waits only on
// items before it in the list, which resident blocks have taken already:
// an own item on its shard's ranges, a halo item on every chunk flag of
// its direction; no block waits on an arrival count.  The protocol runs
// at device scope on the loopback and at system scope between ranks
// (csrc/peer_ring.cuh).
//
// Build and binding as csrc/dma_ring.cu (nvcc sm_90a, plain C interface,
// ctypes: spectrobot_tpu_torch/ops/cuda_dma.py).

#include <cuda_runtime.h>

#include "line_sum_item.cuh"
#include "peer_ring.cuh"

namespace {

constexpr int PTS = 1;                  // K3's: one grid point a thread
constexpr int THREADS = Tile<PTS>::THREADS;
constexpr int WARPS = Tile<PTS>::WARPS;
constexpr float FAR_CENTER = 1e9f;      // the partition's padding center
constexpr int RANGE_UNROLL = 4;         // line blocks a warp reduces at once
// Blocks an SM holds: ptxas fits the kernel in 64 registers (72 freely,
// whose 7 blocks an SM ran the dense case 5 % slower on an H100).
constexpr int MIN_BLOCKS = 8;

// One launch.  Shard k's rows: nuc, sx, y + k line_stride [L] and amps +
// k amp_stride [n_out, L] (rows amp_row apart); its grid nu + k P [P]; its
// output out + k out_shard, rows out_row apart [n_out, P].  scratch holds
// each shard's block ranges [n_loc, nb, 2], then the partial sums [n_loc,
// n_src n_seg, n_out, n_tiles TILE_P]; counters [n_loc n_tiles], zero
// between calls, then the work counter, zero between calls.  n_src = 1 +
// n_dirs: source 0 the own lines, 1 + d the payload received in direction
// d.
struct HaloArgs {
  const long long* table;
  const float* nu;
  const float* nuc;
  const float* sx;
  const float* y;
  const float* amps;
  float* out;
  float* scratch;
  int* counters;
  long long line_stride, amp_stride, amp_row, out_shard, out_row;
  long long cap_floats;
  u64 epoch;
  long long budget;
  int n_loc, n_out, P, L, n_dirs, n_seg, chunk, vec;
  float cutoff;
};

// The call's shapes, derived once per block.
struct Shape {
  int q, nb, n_tiles, n_src, n_rc, n_flags;
  long long n_pack;
  __device__ explicit Shape(const HaloArgs& a)
      : q(3 + a.n_out),
        nb((a.L + BLOCK_L - 1) / BLOCK_L),
        n_tiles((a.P + TILE_P - 1) / TILE_P),
        n_src(1 + a.n_dirs),
        n_rc((a.L + a.chunk - 1) / a.chunk),
        n_flags((3 + a.n_out) * n_rc + 1),
        n_pack((long long)(3 + a.n_out) * a.L) {}
};

// Row r of shard k's lines.
__device__ __forceinline__ const float* own_row(const HaloArgs& a, int k,
                                                int r) {
  const long long s = (long long)k * a.line_stride;
  return r == 0   ? a.nuc + s
         : r == 1 ? a.sx + s
         : r == 2 ? a.y + s
                  : a.amps + (long long)k * a.amp_stride +
                        (long long)(r - 3) * a.amp_row;
}

// Whether the lines of block b, centers within rg[2b, 2b + 1], can reach
// the tile.
__device__ __forceinline__ bool block_in_reach(const float* rg, int b,
                                               const TileSpan& t) {
  return !beyond_reach(__ldcg(rg + 2 * b), __ldcg(rg + 2 * b + 1), t);
}

// The blocks within reach of a tile: the first and one past the last of
// them ({0, 0}: none), and whether every block between is within reach.
struct Hull {
  int first, end;
  bool whole;
};

// The hull of the nb blocks whose ranges are rg; every warp finds the same.
__device__ __forceinline__ Hull reach_hull(const float* rg, int nb,
                                           const TileSpan& t) {
  const int lane = threadIdx.x & 31;
  int first = -1, end = 0, n_in = 0;
  for (int b = 0; b < nb; b += 32) {
    const unsigned m = __ballot_sync(
        0xffffffffu, b + lane < nb && block_in_reach(rg, b + lane, t));
    if (m != 0u) {
      if (first < 0) first = b + __ffs(m) - 1;
      end = b + 32 - __clz(m);
      n_in += __popc(m);
    }
  }
  return first < 0 ? Hull{0, 0, true} : Hull{first, end, n_in == end - first};
}

// The walk of an item: the blocks within reach among [b, b + 32) before
// b1, found by each warp alike (all of them in a whole hull).
struct InReach {
  static constexpr bool ALL = false;
  const float* rg;
  int b1;
  bool whole;
  __device__ __forceinline__ unsigned mask(int b, const TileSpan& t) const {
    if (whole) return 0xffffffffu;
    const int i = b + (threadIdx.x & 31);
    return __ballot_sync(0xffffffffu, i < b1 && block_in_reach(rg, i, t));
  }
};

// The waits a block has passed in this launch (the same in every thread):
// bit k for shard k's ranges, bit 32 + 2 k + d for its payload from
// direction d (k < 16); a wait past these bits is made each time.
struct Passed {
  unsigned long long bits = 0;
  __device__ __forceinline__ bool test(int bit) const {
    return bit < 64 && ((bits >> bit) & 1ull);
  }
  __device__ __forceinline__ void set(int bit) {
    if (bit < 64) bits |= 1ull << bit;
  }
};

// The block waits, unless it already has in this call, until the
// neighbour that shard k sends to in direction d has freed its buffer.
template <int SCOPE>
__device__ __forceinline__ void wait_free(const HaloArgs& a, int k, int d,
                                          int* ready_k) {
  const int key = k * a.n_dirs + d;
  if (*ready_k != key) {
    block_wait<SCOPE>(ws_ready(a.table[3 * k + OWN], d), a.epoch, a.budget);
    *ready_k = key;
  }
}

// Shard k's block ranges: [min, max] of the centers of each line block
// (lines at or past L left out), into scratch; then the flag that its own
// items wait on, and the ranges behind the rows of each payload it sends.
template <int SCOPE>
__device__ __forceinline__ void range_item(const HaloArgs& a, const Shape& s,
                                           int k, int* ready_k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* nuc = own_row(a, k, 0);
  float* mine = a.scratch + (size_t)k * 2 * s.nb;
  for (int b = warp; b < s.nb; b += WARPS * RANGE_UNROLL) {
    float lo[RANGE_UNROLL], hi[RANGE_UNROLL];
#pragma unroll
    for (int u = 0; u < RANGE_UNROLL; ++u) {
      lo[u] = INFINITY;
      hi[u] = -INFINITY;
#pragma unroll
      for (int j = 0; j < BLOCK_L / 32; ++j) {
        const int l = (b + u * WARPS) * BLOCK_L + j * 32 + lane;
        if (l < a.L) {
          const float c = __ldg(nuc + l);
          lo[u] = fminf(lo[u], c);
          hi[u] = fmaxf(hi[u], c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RANGE_UNROLL; ++u) {
      const float vlo = warp_min(lo[u]), vhi = warp_max(hi[u]);
      const int bb = b + u * WARPS;
      if (lane == 0 && bb < s.nb) {
        mine[2 * bb] = vlo;
        mine[2 * bb + 1] = vhi;
      }
    }
  }
  const long long* row = a.table + 3 * k;
  block_signal<GPU_SCOPE>(ws_mine(row[OWN]), a.epoch);
  for (int d = 0; d < a.n_dirs; ++d) {
    wait_free<SCOPE>(a, k, d, ready_k);
    const long long to = dst_of(row, d);
    block_copy<false, true>(ws_recv(to, d, a.cap_floats) + s.n_pack, mine, 0,
                            2 * s.nb);
    block_signal<SCOPE>(ws_arrived(to, d, a.cap_floats) + s.n_flags - 1,
                        a.epoch);
  }
}

// Copy item i: chunk c of row r of shard k's lines into its place in the
// payload of direction d, then the chunk's arrival flag.
template <int SCOPE>
__device__ __forceinline__ void send_item(const HaloArgs& a, const Shape& s,
                                          int i, int* ready_k) {
  const int c = i % s.n_rc, r = (i / s.n_rc) % s.q;
  const int d = (i / (s.n_rc * s.q)) % a.n_dirs;
  const int k = i / (s.n_rc * s.q * a.n_dirs);
  wait_free<SCOPE>(a, k, d, ready_k);
  const long long to = dst_of(a.table + 3 * k, d);
  float* dst = ws_recv(to, d, a.cap_floats) + (size_t)r * a.L;
  const float* src = own_row(a, k, r);
  const long long lo = (long long)c * a.chunk;
  const long long hi = min((long long)a.L, lo + a.chunk);
  if (a.vec)
    block_copy<true, false>(dst, src, lo, hi);
  else
    block_copy<false, false>(dst, src, lo, hi);
  block_signal<SCOPE>(ws_arrived(to, d, a.cap_floats) + r * s.n_rc + c,
                      a.epoch);
}

// Line-sum item (src, k, tile, seg): segment seg of the blocks of source
// src within reach of the tile, its partial sums, and the sum of the parts
// in the last item of (k, tile) to arrive.
template <int NOUT, int SCOPE>
__device__ __forceinline__ void sum_item(const HaloArgs& a, const Shape& s,
                                         int src, int k, int tile, int seg,
                                         Passed& passed, int* s_last) {
  // The tile first: its grid is the caller's, so no wait holds it up.
  float nu_p[PTS];
  const TileSpan t =
      tile_span<PTS>(a.nu + (size_t)k * a.P, tile, a.P - 1, a.cutoff, nu_p);
  const long long own = a.table[3 * k + OWN];
  LineRows rows;
  const float* rg;
  const int bit = src == 0 ? (k < 32 ? k : 64)
                            : (k < 16 ? 32 + 2 * k + src - 1 : 64);
  if (src == 0) {
    if (!passed.test(bit)) {
      block_wait<GPU_SCOPE>(ws_mine(own), a.epoch, a.budget);
      passed.set(bit);
    }
    rows = LineRows{own_row(a, k, 0), own_row(a, k, 1), own_row(a, k, 2),
                    nullptr,          own_row(a, k, 3), a.amp_row,
                    a.n_out,          a.L,              FAR_CENTER};
    rg = a.scratch + (size_t)k * 2 * s.nb;
  } else {
    const int d = src - 1;
    if (!passed.test(bit)) {
      block_wait_all<SCOPE>(ws_arrived(own, d, a.cap_floats), s.n_flags,
                            a.epoch, a.budget);
      passed.set(bit);
    }
    const float* p = ws_recv(own, d, a.cap_floats);
    rows = LineRows{p,       p + a.L,   p + 2 * a.L, nullptr,   p + 3 * a.L,
                    a.L,     a.n_out,   a.L,         FAR_CENTER};
    rg = p + s.n_pack;
  }
  const Hull hull = reach_hull(rg, s.nb, t);
  const int len = (hull.end - hull.first + a.n_seg - 1) / a.n_seg;
  const int b0 = min(hull.end, hull.first + seg * len);
  const int b1 = min(hull.end, b0 + len);
  float acc[NOUT][PTS];
  line_sum_walk<PTS, NOUT, false, true>(rows, nu_p, t, b0, b1, a.cutoff,
                                        InReach{rg, b1, hull.whole}, acc);

  const int n_parts = s.n_src * a.n_seg;
  float* out = a.out + (size_t)k * a.out_shard;
  if (n_parts == 1) {
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      const int p = point_of<PTS>(tile, j);
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        if (o < a.n_out && p < a.P) out[(size_t)o * a.out_row + p] = acc[o][j];
    }
    return;
  }
  // This segment's part at [k, src n_seg + seg, o, p]; every segment
  // writes one (zeros where it holds no block), so the sum needs no
  // record of which did.
  const size_t Pt = (size_t)s.n_tiles * TILE_P;
  float* parts_k = a.scratch + (size_t)a.n_loc * 2 * s.nb +
                   (size_t)k * n_parts * a.n_out * Pt;
  float* dst = parts_k + (size_t)(src * a.n_seg + seg) * a.n_out * Pt;
#pragma unroll
  for (int j = 0; j < PTS; ++j)
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
      if (o < a.n_out) dst[o * Pt + point_of<PTS>(tile, j)] = acc[o][j];
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (size_t)k * s.n_tiles + tile;
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1) == n_parts - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int p = point_of<PTS>(tile, j);
    if (p >= a.P) continue;
    for (int o = 0; o < a.n_out; ++o) {
      const float* part = parts_k + o * Pt + p;
      float v = __ldcg(part);
      for (int m = 1; m < n_parts; ++m)
        v += __ldcg(part + (size_t)m * a.n_out * Pt);
      out[(size_t)o * a.out_row + p] = v;
    }
  }
  if (threadIdx.x == 0) *counter = 0;     // ready for the next call
}

template <int NOUT, int SCOPE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dma_halo_kernel(HaloArgs a) {
  __shared__ int s_last, s_item;
  const Shape s(a);
  const int n_sends = a.n_loc * a.n_dirs * s.q * s.n_rc;
  const int per_src = a.n_loc * s.n_tiles * a.n_seg;
  const int items = a.n_loc + n_sends + s.n_src * per_src;
  int* queue = a.counters + (size_t)a.n_loc * s.n_tiles;

  // 1. The barrier.
  signal_free<SCOPE>(a.table, a.n_loc, 0, a.n_dirs, a.epoch);

  // 2-5. Range items, copy chunks, own items, halo items, in one list: block
  // b takes item b, then the next one not taken as it comes free (a work
  // counter, from gridDim.x on; the grid has no more blocks than items).
  // The takes count every item once, the last take of each block past the
  // list, so the take that returns items - 1 is the launch's last: it
  // leaves the counter zero for the next call.
  int ready_k = -1;
  Passed passed;
  for (int i = blockIdx.x; i < items; i = s_item) {
    if (i < a.n_loc) {
      range_item<SCOPE>(a, s, i, &ready_k);
    } else if (i < a.n_loc + n_sends) {
      send_item<SCOPE>(a, s, i - a.n_loc, &ready_k);
    } else {
      const int w = i - a.n_loc - n_sends;
      const int src = w / per_src, v = w % per_src;
      sum_item<NOUT, SCOPE>(a, s, src, v / (s.n_tiles * a.n_seg),
                            (v / a.n_seg) % s.n_tiles, v % a.n_seg, passed,
                            &s_last);
    }
    __syncthreads();           // the shared tiles are reused by the next item
    if (threadIdx.x == 0) {
      const int taken = atomicAdd(queue, 1);
      if (taken == items - 1) *queue = 0;
      s_item = gridDim.x + taken;
    }
    __syncthreads();
  }
}

template <int NOUT>
void* halo_kernel(bool loopback) {
  return loopback ? (void*)dma_halo_kernel<NOUT, GPU_SCOPE>
                  : (void*)dma_halo_kernel<NOUT, SYS_SCOPE>;
}

bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

}  // namespace

extern "C" {

const char* dma_halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The rows, grid and output as HaloArgs says; P and L any positive
// lengths.  n_dirs: 0 (one shard), 1 (two: send right only) or 2; n_seg:
// segments of each (shard, source, tile); scratch: 2 n_loc ceil(L / 128)
// floats, and with n_seg (1 + n_dirs) > 1 the partial sums after them
// (n_loc (1 + n_dirs) n_seg n_out ceil(P / 128) 128 floats); counters:
// n_loc ceil(P / 128) + 1 zero ints; cutoff = +inf disables the mask;
// chunk: floats per copy item of a row (a multiple of 4, at least
// MIN_CHUNK); loopback: every shard of the ring is in this launch, on this
// device (the protocol at device scope).
int dma_halo_launch(int device, const long long* table, const float* nu,
                    const float* nuc, const float* sx, const float* y,
                    const float* amps, long long line_stride,
                    long long amp_stride, long long amp_row, float* out,
                    long long out_shard,
                    long long out_row, float* scratch, int* counters,
                    long long cap_floats, int n_loc, int n_out, int P, int L,
                    int n_dirs, int n_seg, float cutoff, int chunk,
                    u64 epoch, float timeout_s, int loopback, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || P < 1 || L < 1 || n_dirs < 0 ||
      n_dirs > 2 || n_loc < 1 || n_seg < 1 || chunk < MIN_CHUNK ||
      chunk % 4 != 0 || cap_floats % MIN_CHUNK != 0 || scratch == nullptr ||
      counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long nb = (L + BLOCK_L - 1) / BLOCK_L;
  const long long n_rc = (L + chunk - 1) / chunk;
  const long long q = 3 + n_out;
  if (n_dirs > 0 && (q * L + 2 * nb > cap_floats ||
                     q * n_rc + 1 > cap_floats / MIN_CHUNK))
    return (int)cudaErrorInvalidValue;
  const long long items =
      n_loc * (1 + n_dirs * q * n_rc +
               (long long)(1 + n_dirs) * ((P + TILE_P - 1) / TILE_P) * n_seg);
  if (items > (1ll << 30)) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  HaloArgs a{table, nu, nuc, sx, y, amps, out, scratch, counters,
             line_stride, amp_stride, amp_row, out_shard, out_row,
             cap_floats, epoch,
             timeout_cycles(device, timeout_s), n_loc, n_out, P, L, n_dirs,
             n_seg, chunk, 0, cutoff};
  a.vec = aligned16(nuc) && aligned16(sx) && aligned16(y) &&
          aligned16(amps) && L % 4 == 0 && line_stride % 4 == 0 &&
          amp_stride % 4 == 0 && amp_row % 4 == 0;
  void* args[] = {&a};
  const int rows = rows_of(n_out);
  void* kern = rows == 1   ? halo_kernel<1>(loopback)
               : rows == 2 ? halo_kernel<2>(loopback)
               : rows == 4 ? halo_kernel<4>(loopback)
                           : halo_kernel<8>(loopback);
  const int grid = resident_blocks(kern, device, THREADS, items);
  cudaError_t err =
      cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
