// Fused halo accumulation over peer memory: the CUDA port of the TPU kernel
// benchmarks/dma_halo.py:_fused_kernel.  One launch per call, one shard of
// a 1-D nu ring per rank (or all n shards of the loopback ring):
//
//   out[o, p] = sum over own lines and the neighbours' lines of
//               amps[o, i] * Re w(x_ip, y_i) * [|dnu| <= cutoff]
//
// with each shard's lines packed as rows [nu_c, scale_x, y, amps_0..] x Lp.
// The order of work is the reference's (:124-193):
//   1. the neighbour barrier: each shard tells the shards that send to it
//      that its receive buffers are free for this call (the epoch);
//   2. the remote stores of the packed rows into the right neighbour's
//      recv[0] and, with more than two shards, the left one's recv[1];
//   3. the dense line sum of the shard's own lines, while the copies fly;
//   4. the wait for the arrival of both neighbours' rows;
//   5. the line sum of the received halos.
// Static ring degeneracies as the reference's (:140-141): one shard makes
// no exchange; two shards make one (their neighbours coincide, or the halo
// would count them twice).  The protocol is csrc/peer_ring.cuh's.
//
// The line sums are K3's loop (csrc/line_sum_item.cuh: K1's and K3's
// per-pair code and tier decision, runs of lines within reach of each
// tile, one point a thread), dense within the local chunk as the
// reference is (no window table); a sub-block whose lines all lie beyond
// the cutoff of the 128-point tile is skipped: exact, as every one of its
// pairs is masked.  The rows are read through L2 alone, as a peer may have
// just stored them.
//
// What bounds it: FP32 arithmetic on the CUDA cores (K3's per-pair flops on
// the in-cutoff pairs); the copies are a few hundred KB a call.  The
// design: a persistent, cooperative grid (every block resident, so a
// waiting block never keeps a copying block from running) walks the work
// items phase by phase: copy chunks, own (tile, line segment) items, halo
// items (each waits for every chunk flag of its direction).  Each item
// writes its partial sums; a second kernel adds them in a fixed order (own
// segments, then the left halo's, then the right halo's): deterministic,
// no atomics.  The protocol runs at device scope on the loopback and at
// system scope between ranks (csrc/peer_ring.cuh).
//
// Build and binding as csrc/dma_ring.cu (nvcc sm_90a, plain C interface,
// ctypes: spectrobot_tpu_torch/ops/cuda_dma.py).

#include <cuda_runtime.h>

#include "line_sum_item.cuh"
#include "peer_ring.cuh"

namespace {

constexpr int PTS = 1;                  // K3's: one grid point a thread
constexpr int THREADS = Tile<PTS>::THREADS;
constexpr int SUM_THREADS = 256;

// table [n_loc, 3]: workspace bases per shard; nu [n_loc, Pp];
// pack [n_loc, q, Lp] with q = 3 + n_out; part [n_loc, n_src * n_seg,
// n_out, Pp] with n_src = 1 + n_dirs: source 0 the own lines, 1 + d the
// rows received in direction d.
template <int NOUT, int SCOPE>
__global__ void __launch_bounds__(THREADS)
dma_halo_kernel(const long long* __restrict__ table,
                const float* __restrict__ nu, const float* pack, float* part,
                long long cap_floats, int n_loc, int n_out, int Pp, int Lp,
                int n_dirs, int n_seg, int seg_blocks, float cutoff,
                int chunk, u64 epoch, long long budget) {
  const int q = 3 + n_out;
  const long long n_pack = (long long)q * Lp;
  const int n_chunks = (int)((n_pack + chunk - 1) / chunk);
  const int n_tiles = Pp / TILE_P;
  const int n_blocks = Lp / BLOCK_L;
  const int n_src = 1 + n_dirs;
  const int per_src = n_tiles * n_seg;

  // 1. The barrier.
  signal_free<SCOPE>(table, n_loc, 0, n_dirs, epoch);

  // 2. The remote stores of the packed rows.
  const int sends = n_loc * n_dirs * n_chunks;
  int ready_k = -1;
  for (int i = blockIdx.x; i < sends; i += gridDim.x) {
    const int k = i / (n_dirs * n_chunks);
    const int d = (i / n_chunks) % n_dirs;
    const long long* row = table + 3 * k;
    const long long to = dst_of(row, d);
    send_chunk<SCOPE, true>(row, i / n_chunks, &ready_k, d,
                            pack + (size_t)k * n_pack,
                            ws_recv(to, d, cap_floats), to, n_pack,
                            i % n_chunks, chunk, cap_floats, epoch, budget);
  }

  // 3. The own lines; 4-5. the wait and the received halos.
  for (int src = 0; src < n_src; ++src) {
    const int items = n_loc * per_src;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int k = i / per_src;
      const int tile = (i % per_src) / n_seg, seg = i % n_seg;
      const int b0 = seg * seg_blocks;
      const int b1 = min(n_blocks, b0 + seg_blocks);
      const float* rows = pack + (size_t)k * n_pack;
      if (src > 0) {
        const int d = src - 1;
        const long long own = table[3 * k + OWN];
        block_wait_all<SCOPE>(ws_arrived(own, d, cap_floats), n_chunks,
                              epoch, budget);
        rows = ws_recv(own, d, cap_floats);
      }
      float acc[NOUT][PTS];
      line_sum_item<PTS, NOUT, false, true>(
          LineRows{rows, rows + Lp, rows + 2 * Lp, nullptr, rows + 3 * Lp,
                   Lp, n_out, Lp, 0.0f},
          nu + (size_t)k * Pp, tile, b0, b1, cutoff, acc);
      float* dst = part + (((size_t)k * n_src + src) * n_seg + seg) *
                              n_out * Pp;
#pragma unroll
      for (int j = 0; j < PTS; ++j)
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
          if (o < n_out)
            dst[(size_t)o * Pp + point_of<PTS>(tile, j)] = acc[o][j];
      __syncthreads();         // the shared tiles are reused by the next item
    }
  }
}

// out[k, i] = sum_j part[k, j, i] over the m partial sums of each of n_loc
// shards, in order j = 0, 1, ..; n values per shard.
__global__ void __launch_bounds__(SUM_THREADS)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int m, int n, int n_loc) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (long long)n * n_loc) return;
  const long long k = i / n, j = i % n;
  const float* src = part + (size_t)k * m * n + j;
  float acc = src[0];
  for (int s = 1; s < m; ++s) acc += src[(size_t)s * n];
  out[i] = acc;
}

template <int NOUT>
void* halo_kernel(bool loopback) {
  return loopback ? (void*)dma_halo_kernel<NOUT, GPU_SCOPE>
                  : (void*)dma_halo_kernel<NOUT, SYS_SCOPE>;
}

}  // namespace

extern "C" {

const char* dma_halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n_dirs: 0 (one shard), 1 (two: send right only) or 2; cutoff = +inf
// disables the mask; chunk: floats per copy item (a multiple of 4, at
// least MIN_CHUNK); loopback: every shard of the ring is in this launch,
// on this device (the protocol at device scope).
int dma_halo_launch(int device, const long long* table, const float* nu,
                    const float* pack, float* part, float* out,
                    long long cap_floats, int n_loc, int n_out, int Pp,
                    int Lp, int n_dirs, int n_seg, int seg_blocks,
                    float cutoff, int chunk, u64 epoch, float timeout_s,
                    int loopback, void* stream) {
  const long long n_pack = (long long)(3 + n_out) * Lp;
  if (n_out < 1 || n_out > MAX_OUT || Pp <= 0 || Pp % TILE_P != 0 ||
      Lp <= 0 || Lp % BLOCK_L != 0 || n_dirs < 0 || n_dirs > 2 ||
      n_loc < 1 || n_seg < 1 || seg_blocks < 1 || chunk < MIN_CHUNK ||
      chunk % 4 != 0 || (n_dirs > 0 && n_pack > cap_floats) ||
      (size_t)pack % 16 != 0 || cap_floats % MIN_CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int n_src = 1 + n_dirs;
  const long long n_chunks = (n_pack + chunk - 1) / chunk;
  const long long items =
      (long long)n_loc * ((long long)n_src * (Pp / TILE_P) * n_seg +
                          n_dirs * n_chunks);
  if (items > (1ll << 30)) return (int)cudaErrorInvalidValue;
  long long budget = timeout_cycles(device, timeout_s);
  void* args[] = {&table, &nu, &pack, &part, &cap_floats, &n_loc, &n_out,
                  &Pp, &Lp, &n_dirs, &n_seg, &seg_blocks, &cutoff, &chunk,
                  &epoch, &budget};
  const int rows = rows_of(n_out);
  void* kern = rows == 1   ? halo_kernel<1>(loopback)
               : rows == 2 ? halo_kernel<2>(loopback)
               : rows == 4 ? halo_kernel<4>(loopback)
                           : halo_kernel<8>(loopback);
  const int grid = resident_blocks(kern, device, THREADS, items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchCooperativeKernel(kern, dim3(grid),
                                                dim3(THREADS), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_out * Pp * n_loc;
  sum_parts_kernel<<<(unsigned)((total + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, s>>>(part, out, n_src * n_seg,
                                          n_out * Pp, n_loc);
  return (int)cudaGetLastError();
}

}  // extern "C"
