// Single-state windowed Voigt opacity line sum: the CUDA port of the TPU
// kernel spectrobot_tpu/ops/pallas_opacity.py:_kernel (K3), reached there
// through _accumulate_padded by the nu-mesh's halo accumulation
// (parallel/halo.py:halo_accumulate_pallas_fn) and the dense bench.
//
//   out[o, p] = sum_i amps[o, i] * Re w(x_ip, y_i)
//               * exp(-chi_i * max(|dnu| - 3, 0)) * [|dnu| <= cutoff]
//   dnu = nu[p] - nu_c[i],   x_ip = dnu * sx[i],   0 <= o < n_out <= 8
//
// One state, any number of amplitude rows up to MAX_OUT, a ragged window
// table or every block (no cutoff: the dense case), optional chi.
//
// What bounds it: FP32 arithmetic on the CUDA cores, as K1 (per pair ~14
// flops far, ~55 mid, ~165 near3, ~300 near4, plus 2 per amplitude row);
// the bytes are a few floats per line and n_out + 1 per point.
//
// What the design does about it:
//  * The loop is K1's (csrc/line_sum_item.cuh, with the per-pair code of
//    csrc/voigt_primal.cuh): runs of lines within reach of the tile from a
//    warp ballot (sub-blocks beyond the cutoff are never evaluated), lines
//    staged as one float4 and one vector of the amplitude rows (1, 2, 4 or
//    8 of them, a template argument), the unpadded rows read with the
//    padding in registers; one point a thread (PTS; K1 takes two).  With
//    one segment K3 sums every pair in K1's order: K3 equals K1 at B = 1,
//    bit for bit.
//  * One state gives K1's grid of one block per (128-point tile, state)
//    only P / 128 blocks, a fraction of the card's 132 SMs.  K3's grid is
//    (tile, line segment): each tile's window of line blocks is cut into
//    segments of seg_blocks blocks, one thread block each, so a single
//    state fills the card.
//  * One launch: with several segments each block writes its partial sums
//    to a workspace, and the last block of its tile to arrive (an atomic
//    count, the only atomic) adds the segments that hold a part in segment
//    order and writes [n_out, P].  The counters live per (device, stream)
//    on the host, zero between calls (each launch leaves them zero).
//    Deterministic: no atomics on values, no TF32.
//
// Build and binding as csrc/opacity_batch.cu (nvcc sm_90a, plain C
// interface, ctypes: spectrobot_tpu_torch/ops/cuda_single.py).

#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "line_sum_item.cuh"

namespace {

// One grid point a thread: a single state gives few tiles, and K3's grid
// needs the threads more than the reuse of each staged line that two
// points a thread buy K1.
constexpr int PTS = 1;
constexpr int THREADS = Tile<PTS>::THREADS;

// grid = (Pp / TILE_P, n_seg), block = THREADS threads.
// nu [Pp] (the padded grid); nuc, sx, y, chi [L]; amps [n_out, L]; starts,
// counts [n_tiles] (window of line blocks per tile); out [n_out, P].  With
// n_seg > 1: part [n_seg, n_out, Pp] and counters [n_tiles], zero between
// calls; segment k of tile t sums the blocks starts[t] + [k seg_blocks,
// (k + 1) seg_blocks) of its window.
template <int NOUT, bool HAS_CHI>
__global__ void __launch_bounds__(THREADS)
opacity_single_kernel(const float* __restrict__ nu,
                      const float* __restrict__ nuc,
                      const float* __restrict__ sx,
                      const float* __restrict__ yv,
                      const float* __restrict__ chi,
                      const float* __restrict__ amps,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      float* __restrict__ part, int* __restrict__ counters,
                      float* __restrict__ out, int n_out, int P, int Pp,
                      int L, float far, int n_seg, int seg_blocks,
                      float cutoff) {
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int count = counts[tile];
  const int first = seg * seg_blocks;
  const int last = min(count, first + seg_blocks);
  float acc[NOUT][PTS];
  line_sum_item<PTS, NOUT, HAS_CHI, false>(
      LineRows{nuc, sx, yv, chi, amps, L, n_out, L, far}, nu, tile,
      starts[tile] + first, starts[tile] + last, cutoff, acc);
  if (n_seg == 1) {
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      const int p = point_of<PTS>(tile, j);
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        if (o < n_out && p < P) out[(size_t)o * P + p] = acc[o][j];
    }
    return;
  }
  // Partial sums of segment seg at [seg, o, p].
  if (first < count)
#pragma unroll
    for (int j = 0; j < PTS; ++j)
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        if (o < n_out)
          part[((size_t)seg * n_out + o) * Pp + point_of<PTS>(tile, j)] =
              acc[o][j];
  // The last block of this tile to arrive adds the segments that hold a
  // part, in segment order.
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counters + tile, 1) == n_seg - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n_used = (count + seg_blocks - 1) / seg_blocks;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int p = point_of<PTS>(tile, j);
    if (p >= P) continue;
    for (int o = 0; o < n_out; ++o) {
      const float* src = part + (size_t)o * Pp + p;
      float v = n_used > 0 ? __ldcg(src) : 0.0f;
      for (int s = 1; s < n_used; ++s)
        v += __ldcg(src + (size_t)s * n_out * Pp);
      out[(size_t)o * P + p] = v;
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next call
}

template <int NOUT>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* amps,
                   const int* starts, const int* counts, float* part,
                   int* counters, float* out, int n_out, int P, int Pp,
                   int L, float far, int n_seg, int seg_blocks, float cutoff,
                   cudaStream_t stream) {
  const dim3 grid(Pp / TILE_P, n_seg);
  if (chi != nullptr)
    opacity_single_kernel<NOUT, true><<<grid, THREADS, 0, stream>>>(
        nu, nuc, sx, y, chi, amps, starts, counts, part, counters, out,
        n_out, P, Pp, L, far, n_seg, seg_blocks, cutoff);
  else
    opacity_single_kernel<NOUT, false><<<grid, THREADS, 0, stream>>>(
        nu, nuc, sx, y, nullptr, amps, starts, counts, part, counters, out,
        n_out, P, Pp, L, far, n_seg, seg_blocks, cutoff);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile and block geometry and the row limit, so the host's window tables and
// checks can be held against the kernel that reads them.
int opacity_single_tile_p() { return TILE_P; }
int opacity_single_block_l() { return BLOCK_L; }
int opacity_single_max_out() { return MAX_OUT; }

const char* opacity_single_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` of `device` and returns the CUDA error of the
// launch (0 = launched).  nu is the padded grid [Pp]; the rows are
// unpadded [L] and [n_out, L], the output [n_out, P].  `far` is the center
// the window table gave padding lines.  `chi` may be null (no wing
// correction); cutoff = +inf disables the mask.  With n_seg > 1, `part`
// holds [n_seg, n_out, Pp] floats of scratch and `counters` Pp / TILE_P
// ints that are zero (each call leaves them zero); with n_seg == 1 neither
// is read and both may be null.
int opacity_single_launch(int device, const float* nu, const float* nuc,
                          const float* sx, const float* y, const float* chi,
                          const float* amps, const int* starts,
                          const int* counts, float* part, int* counters,
                          float* out, int n_out, int P, int Pp, int L,
                          float far, int n_seg, int seg_blocks, float cutoff,
                          void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || P < 0 || P > Pp || Pp <= 0 ||
      Pp % TILE_P != 0 || L < 0 || n_seg < 1 || n_seg > 65535 ||
      seg_blocks < 1 ||
      (n_seg > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rows_of(n_out)) {
    case 1:
      err = launch<1>(nu, nuc, sx, y, chi, amps, starts, counts, part,
                      counters, out, n_out, P, Pp, L, far, n_seg, seg_blocks,
                      cutoff, s);
      break;
    case 2:
      err = launch<2>(nu, nuc, sx, y, chi, amps, starts, counts, part,
                      counters, out, n_out, P, Pp, L, far, n_seg, seg_blocks,
                      cutoff, s);
      break;
    case 4:
      err = launch<4>(nu, nuc, sx, y, chi, amps, starts, counts, part,
                      counters, out, n_out, P, Pp, L, far, n_seg, seg_blocks,
                      cutoff, s);
      break;
    default:
      err = launch<8>(nu, nuc, sx, y, chi, amps, starts, counts, part,
                      counters, out, n_out, P, Pp, L, far, n_seg, seg_blocks,
                      cutoff, s);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
