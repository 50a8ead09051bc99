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
// table or every block (no cutoff: the dense case), optional chi.  The
// per-pair code and the tier decision are K1's (csrc/voigt_primal.cuh), so
// K1 and K3 agree pair for pair; the (tile, line segment) item and the
// segment pass are csrc/line_sum_item.cuh's, which the fused halo
// accumulation (dma_halo.cu) runs too.
//
// What bounds it: FP32 arithmetic on the CUDA cores, as K1 (per pair ~14
// flops far, ~55 mid, ~165 near3, ~300 near4, plus 2 per amplitude row);
// the bytes are a few floats per line and n_out + 1 per point.
//
// What the design does about it: one state gives K1's grid of one block
// per (128-point tile, state) only P / 128 blocks, a fraction of the card's
// 132 SMs.  K3's grid is (tile, line segment): each tile's window of line
// blocks is cut into segments of seg_blocks blocks, one thread block each,
// so a single state fills the card.  Each thread holds one point's n_out
// sums in registers, in line order; the [n_seg, n_out, Pp] partial sums are
// added in segment order by a second pass.  Deterministic: no atomics, no
// TF32.  With one segment the first pass writes the result directly.
//
// Build and binding as csrc/opacity_batch.cu (nvcc sm_90a, plain C
// interface, ctypes: spectrobot_tpu_torch/ops/cuda_single.py).

#include <cuda_runtime.h>

#include "line_sum_item.cuh"

namespace {

// grid = (Pp / TILE_P, n_seg), block = TILE_P threads.
// nu [Pp]; nuc, sx, y, chi [Lp]; amps [n_out, Lp]; starts, counts [n_tiles]
// (window of line blocks per tile); part [n_seg, n_out, Pp]: segment k of
// tile t sums the blocks starts[t] + [k seg_blocks, (k + 1) seg_blocks)
// of its window.
template <bool HAS_CHI>
__global__ void __launch_bounds__(TILE_P)
opacity_single_kernel(const float* __restrict__ nu,
                      const float* __restrict__ nuc,
                      const float* __restrict__ sx,
                      const float* __restrict__ yv,
                      const float* __restrict__ chi,
                      const float* __restrict__ amps,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      float* __restrict__ part, int n_out, int Pp, int Lp,
                      int seg_blocks, float cutoff) {
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int first = seg * seg_blocks;
  const int last = min(counts[tile], first + seg_blocks);
  line_sum_item<HAS_CHI, false, false>(
      LineRows{nuc, sx, yv, chi, amps}, nu, tile, starts[tile] + first,
      starts[tile] + last, n_out, Lp, Pp, cutoff,
      part + (size_t)seg * n_out * Pp);
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

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `chi` may be null (no wing correction); cutoff = +inf disables the mask.
// With n_seg > 1, `part` holds [n_seg, n_out, Pp] floats of scratch; with
// n_seg == 1 it is not read and may be null.
int opacity_single_launch(const float* nu, const float* nuc, const float* sx,
                          const float* y, const float* chi, const float* amps,
                          const int* starts, const int* counts, float* part,
                          float* out, int n_out, int Pp, int Lp, int n_seg,
                          int seg_blocks, float cutoff, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || Pp <= 0 || Pp % TILE_P != 0 ||
      Lp <= 0 || Lp % BLOCK_L != 0 || n_seg < 1 || n_seg > 65535 ||
      seg_blocks < 1 || (n_seg > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Pp / TILE_P, n_seg);
  float* dst = n_seg == 1 ? out : part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chi != nullptr)
    opacity_single_kernel<true><<<grid, TILE_P, 0, s>>>(
        nu, nuc, sx, y, chi, amps, starts, counts, dst, n_out, Pp, Lp,
        seg_blocks, cutoff);
  else
    opacity_single_kernel<false><<<grid, TILE_P, 0, s>>>(
        nu, nuc, sx, y, nullptr, amps, starts, counts, dst, n_out, Pp, Lp,
        seg_blocks, cutoff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return static_cast<int>(err);
  launch_sum_parts(part, out, n_seg, n_out * Pp, 1, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
