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
// The line sums are K3's work items (csrc/line_sum_item.cuh: K1's and K3's
// per-pair code and tier decision, K3's staging and ordered partial sums),
// dense within the local chunk as the reference is (no window table), but a
// 32-line sub-block whose centers all lie beyond the cutoff of the
// 128-point tile is skipped: exact, as every one of its pairs is masked.
// The rows are read through L2 alone, as a peer may have just stored them.
//
// What bounds it: FP32 arithmetic on the CUDA cores (K3's per-pair flops on
// the in-cutoff pairs); the copies are a few hundred KB a call.  The
// design: a persistent, cooperative grid (every block resident, so a
// waiting block never keeps a copying block from running) walks the work
// items phase by phase: copy chunks, own (tile, line segment) items, halo
// items.  Each item writes its partial sums; a second kernel adds them in a
// fixed order (own segments, then the left halo's, then the right halo's),
// as K3 adds its segments: deterministic, no atomics.
//
// Build and binding as csrc/dma_ring.cu (nvcc sm_90a, plain C interface,
// ctypes: spectrobot_tpu_torch/ops/cuda_dma.py).

#include <cuda_runtime.h>

#include "line_sum_item.cuh"
#include "peer_ring.cuh"

namespace {

// table [n_loc, 3]: workspace bases per shard; nu [n_loc, Pp];
// pack [n_loc, q, Lp] with q = 3 + n_out; part [n_loc, n_src * n_seg,
// n_out, Pp] with n_src = 1 + n_dirs: source 0 the own lines, 1 + d the
// rows received in direction d.
__global__ void __launch_bounds__(TILE_P)
dma_halo_kernel(const long long* __restrict__ table,
                const float* __restrict__ nu, const float* pack, float* part,
                long long cap_floats, int n_loc, int n_out, int Pp, int Lp,
                int n_dirs, int n_seg, int seg_blocks, float cutoff,
                int chunk, u64 epoch, u64 target0, u64 target1,
                long long budget) {
  const int q = 3 + n_out;
  const long long n_pack = (long long)q * Lp;
  const int n_chunks = (int)((n_pack + chunk - 1) / chunk);
  const int n_tiles = Pp / TILE_P;
  const int n_blocks = Lp / BLOCK_L;
  const int n_src = 1 + n_dirs;
  const int per_src = n_tiles * n_seg;

  // 1. The barrier.
  signal_free(table, n_loc, 0, n_dirs, epoch);

  // 2. The remote stores of the packed rows.
  const int sends = n_loc * n_dirs * n_chunks;
  for (int i = blockIdx.x; i < sends; i += gridDim.x) {
    const int k = i / (n_dirs * n_chunks);
    const int d = (i / n_chunks) % n_dirs;
    send_chunk<true>(table + 3 * k, d, pack + (size_t)k * n_pack, n_pack,
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
        block_wait(ws_arrived(own, d), d == 0 ? target0 : target1, budget);
        rows = ws_recv(own, d, cap_floats);
      }
      float* dst = part + (((size_t)k * n_src + src) * n_seg + seg) *
                              n_out * Pp;
      line_sum_item<false, true, true>(
          LineRows{rows, rows + Lp, rows + 2 * Lp, nullptr, rows + 3 * Lp},
          nu + (size_t)k * Pp, tile, b0, b1, n_out, Lp, Pp, cutoff, dst);
      __syncthreads();         // the shared tiles are reused by the next item
    }
  }
}

}  // namespace

extern "C" {

const char* dma_halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n_dirs: 0 (one shard), 1 (two: send right only) or 2; cutoff = +inf
// disables the mask; chunk: floats per copy item (a multiple of 4);
// target0/1: each receiver's arrival count in direction 0/1 once this
// call's chunks are in.
int dma_halo_launch(int device, const long long* table, const float* nu,
                    const float* pack, float* part, float* out,
                    long long cap_floats, int n_loc, int n_out, int Pp,
                    int Lp, int n_dirs, int n_seg, int seg_blocks,
                    float cutoff, int chunk, u64 epoch, u64 target0,
                    u64 target1, float timeout_s, void* stream) {
  const long long n_pack = (long long)(3 + n_out) * Lp;
  if (n_out < 1 || n_out > MAX_OUT || Pp <= 0 || Pp % TILE_P != 0 ||
      Lp <= 0 || Lp % BLOCK_L != 0 || n_dirs < 0 || n_dirs > 2 ||
      n_loc < 1 || n_seg < 1 || seg_blocks < 1 || chunk < 4 ||
      chunk % 4 != 0 ||
      (n_dirs > 0 && n_pack > cap_floats) || (size_t)pack % 16 != 0 ||
      cap_floats % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_src = 1 + n_dirs;
  const long long n_chunks = (n_pack + chunk - 1) / chunk;
  const long long items =
      (long long)n_loc * ((long long)n_src * (Pp / TILE_P) * n_seg +
                          n_dirs * n_chunks);
  if (items > (1ll << 30)) return (int)cudaErrorInvalidValue;
  long long budget = timeout_cycles(device, timeout_s);
  void* args[] = {&table, &nu, &pack, &part, &cap_floats, &n_loc, &n_out,
                  &Pp, &Lp, &n_dirs, &n_seg, &seg_blocks, &cutoff, &chunk,
                  &epoch, &target0, &target1, &budget};
  const int grid = resident_blocks((const void*)dma_halo_kernel, device,
                                   TILE_P, items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaLaunchCooperativeKernel((void*)dma_halo_kernel, dim3(grid),
                                    dim3(TILE_P), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_sum_parts(part, out, n_src * n_seg, n_out * Pp, n_loc, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
