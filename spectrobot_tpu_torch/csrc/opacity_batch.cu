// Batched windowed Voigt opacity line sum: the CUDA port of the TPU kernel
// spectrobot_tpu/ops/pallas_opacity.py:_batch_kernel (K1).
//
//   out[b, o, p] = sum_i amps[b, o, i] * Re w(x_bip, y_bi)
//                  * exp(-chi_bi * max(|dnu| - 3, 0)) * [|dnu| <= cutoff]
//   dnu = nu[p] - nu_c[b, i],   x_bip = dnu * sx[b, i],   o in {0, 1}
//
// b runs over the (ray x layer) states, o over the absorption and emission
// depths.  Re w is Humlicek's w4 (spectrobot_tpu/ops/voigt.py).
//
// What bounds it: FP32 arithmetic on the CUDA cores.  Each (point, line)
// pair costs, by tier (the reference's bench.py TIER_FLOPS reckoning, which
// counts every region the branchless TPU evaluator computes): far ~14
// flops, mid ~55, near3 ~165, near4 ~300, plus the chi exp where it is on.
// The bytes are small beside that: a block reads its TILE_P points once and
// 6 floats per line of each window block, and writes 2 x TILE_P floats.
// In practice the loop is bound by the instructions it issues per pair
// (loads, the cutoff test, loop control) as much as by the flops.
//
// What the design does about it:
//  * Dead states are skipped: a state whose amplitudes are all zero writes
//    zeros and returns (bit-exact; about 45 % of a limb scan's states lie
//    below their ray's tangent point).  Each block finds it out itself
//    with block-wide ballots over the state's amplitudes.
//  * Line blocks outside the wing cutoff are never visited: the host window
//    table gives each tile its [start, start + count) range of BLOCK_L-line
//    blocks.  The loop over them replaces the TPU's sequential grid axis.
//  * The loop over them is csrc/line_sum_item.cuh's, which K3 and the fused
//    halo kernel run too: each 32-line sub-block cut to its run of lines
//    that can reach the tile (exact), the tier chosen once per sub-block,
//    each line staged as one float4 and one float2 and evaluated at two
//    points a thread, each point's two sums in registers as fmaf chains in
//    line order (deterministic), the unpadded [B, L] rows read with the
//    padding in registers.  Only points below P are written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_opacity.py.

#include <cuda_runtime.h>

#include "line_sum_item.cuh"

namespace {

constexpr int PTS = 2;                    // grid points per thread
constexpr int THREADS = Tile<PTS>::THREADS;

// Whether state b has a nonzero amplitude (NaN counts, as != 0 does): a
// block-wide ballot over its 2 L entries, 4 per thread per round, ending
// at the first round that finds one.
__device__ __forceinline__ bool state_is_live(const float* __restrict__ a,
                                              int n) {
  for (int i0 = 0; i0 < n; i0 += 4 * THREADS) {
    bool nz = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * THREADS + threadIdx.x;
      if (i < n) nz |= a[i] != 0.0f;
    }
    if (__syncthreads_or(nz)) return true;
  }
  return false;
}

// grid = (Pp / TILE_P, B), block = THREADS threads; thread t holds points
// tile * TILE_P + t + j * THREADS, j < PTS.
// nu [Pp] (the padded grid); nuc, sx, y, chi [B, L]; amps [B, 2, L];
// starts, counts [n_tiles] (window of line blocks per tile); out [B, 2, P].
template <bool HAS_CHI>
__global__ void __launch_bounds__(THREADS)
opacity_batch_kernel(const float* __restrict__ nu,
                     const float* __restrict__ nuc,
                     const float* __restrict__ sx,
                     const float* __restrict__ yv,
                     const float* __restrict__ chi,
                     const float* __restrict__ amps,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     float* __restrict__ out, int P, int L, float far,
                     float cutoff) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const float* a0 = amps + (size_t)b * 2 * L;
  float* out0 = out + (size_t)b * 2 * P;
  float* out1 = out0 + P;

  if (!state_is_live(a0, 2 * L)) {   // uniform over the block
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      const int p = point_of<PTS>(tile, j);
      if (p < P) out0[p] = out1[p] = 0.0f;
    }
    return;
  }

  const size_t row = (size_t)b * L;
  const int start = starts[tile];
  float acc[2][PTS];
  line_sum_item<PTS, 2, HAS_CHI, false>(
      LineRows{nuc + row, sx + row, yv + row, HAS_CHI ? chi + row : nullptr,
               a0, L, 2, L, far},
      nu, tile, start, start + counts[tile], cutoff, acc);
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const int p = point_of<PTS>(tile, j);
    if (p < P) {
      out0[p] = acc[0][j];
      out1[p] = acc[1][j];
    }
  }
}

}  // namespace

extern "C" {

// Tile and block geometry, so the host's window tables can be checked
// against the kernel that reads them.
int opacity_batch_tile_p() { return TILE_P; }
int opacity_batch_block_l() { return BLOCK_L; }
int opacity_batch_sub_l() { return SUB_L; }

const char* opacity_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// nu is the padded grid [Pp]; the line rows are [B, L] and the output
// [B, 2, P].  `far` is the center the window table gave padding lines.
// `chi` may be null (no wing correction); cutoff = +inf disables the mask.
int opacity_batch_launch(const float* nu, const float* nuc, const float* sx,
                         const float* y, const float* chi, const float* amps,
                         const int* starts, const int* counts, float* out,
                         int B, int P, int Pp, int L, float far,
                         float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || P < 0 || P > Pp || Pp <= 0 ||
      Pp % TILE_P != 0 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Pp / TILE_P, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chi != nullptr)
    opacity_batch_kernel<true><<<grid, THREADS, 0, s>>>(
        nu, nuc, sx, y, chi, amps, starts, counts, out, P, L, far, cutoff);
  else
    opacity_batch_kernel<false><<<grid, THREADS, 0, s>>>(
        nu, nuc, sx, y, nullptr, amps, starts, counts, out, P, L, far,
        cutoff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
