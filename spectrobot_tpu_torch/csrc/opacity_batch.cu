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
//
// What the design does about it:
//  * Dead states are skipped: a state whose amplitudes are all zero writes
//    zeros and returns (bit-exact; about 45 % of a limb scan's states lie
//    below their ray's tangent point).
//  * Line blocks outside the wing cutoff are never visited: the host window
//    table gives each tile its [start, start + count) range of BLOCK_L-line
//    blocks.  The loop over them replaces the TPU's sequential grid axis.
//  * The tier is chosen once per SUB_L-line sub-block from a conservative
//    bound on s = |x| + y (csrc/voigt_primal.cuh, shared with K3), so the
//    switch never diverges; in the near tiers a pair evaluates only its own
//    region.  Min and max are taken over the sub-block, so pressure shifts
//    that reorder centers do not matter.
//  * Pairs outside the cutoff skip the line shape altogether.
//  * One thread per grid point keeps both sums in registers, in line
//    order: no atomics, no shared accumulators, deterministic results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_opacity.py.

#include <cuda_runtime.h>

#include "voigt_primal.cuh"

namespace {

struct Staged {
  float nuc[BLOCK_L];
  float sx[BLOCK_L];
  float y[BLOCK_L];
  float a0[BLOCK_L];
  float a1[BLOCK_L];
  float chi[BLOCK_L];
};

template <int TIER, bool HAS_CHI>
__device__ __forceinline__ void accumulate_sub(const Staged& s, int base,
                                               float nu_p, float cutoff,
                                               float& acc0, float& acc1) {
#pragma unroll 2
  for (int i = base; i < base + SUB_L; ++i) {
    float wr;
    if (!pair_wr<TIER, HAS_CHI>(nu_p - s.nuc[i], s.sx[i], s.y[i],
                                HAS_CHI ? s.chi[i] : 0.0f, cutoff, wr))
      continue;
    acc0 = fmaf(s.a0[i], wr, acc0);
    acc1 = fmaf(s.a1[i], wr, acc1);
  }
}

// grid = (Pp / TILE_P, B), block = TILE_P threads.
// nu [Pp]; nuc, sx, y, chi [B, Lp]; amps [B, 2, Lp]; starts, counts
// [n_tiles] (window of line blocks per tile); active [B]; out [B, 2, Pp].
template <bool HAS_CHI>
__global__ void __launch_bounds__(TILE_P)
opacity_batch_kernel(const float* __restrict__ nu,
                     const float* __restrict__ nuc,
                     const float* __restrict__ sx,
                     const float* __restrict__ yv,
                     const float* __restrict__ chi,
                     const float* __restrict__ amps,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ active,
                     float* __restrict__ out, int Pp, int Lp, float cutoff) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int p = tile * TILE_P + tid;
  float* out0 = out + (size_t)b * 2 * Pp;
  float* out1 = out0 + Pp;
  if (active[b] == 0) {        // uniform over the block: all threads leave
    out0[p] = 0.0f;
    out1[p] = 0.0f;
    return;
  }

  __shared__ Staged s;
  __shared__ int s_tier[N_SUB];

  const float nu_p = nu[p];
  float tile_lo, tile_hi;
  tile_bounds(nu_p, tile_lo, tile_hi);

  const size_t row = (size_t)b * Lp;
  const float* a0 = amps + (size_t)b * 2 * Lp;
  const float* a1 = a0 + Lp;
  const int start = starts[tile];
  const int count = counts[tile];
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = 0; k < count; ++k) {
    const size_t l = (size_t)(start + k) * BLOCK_L + tid;
    const float c = nuc[row + l];
    const float sxv = sx[row + l];
    const float yy = yv[row + l];
    __syncthreads();           // everyone is done with the previous block
    s.nuc[tid] = c;
    s.sx[tid] = sxv;
    s.y[tid] = yy;
    s.a0[tid] = a0[l];
    s.a1[tid] = a1[l];
    if (HAS_CHI) s.chi[tid] = chi[row + l];
    // Warp w holds the lines of sub-block w in registers: its tier.
    const int tier = sub_block_tier(c, sxv, yy, tile_lo, tile_hi);
    if ((tid & 31) == 0) s_tier[warp] = tier;
    __syncthreads();
#pragma unroll 1
    for (int sb = 0; sb < N_SUB; ++sb) {
      const int base = sb * SUB_L;
      switch (s_tier[sb]) {
        case FAR:
          accumulate_sub<FAR, HAS_CHI>(s, base, nu_p, cutoff, acc0, acc1);
          break;
        case MID:
          accumulate_sub<MID, HAS_CHI>(s, base, nu_p, cutoff, acc0, acc1);
          break;
        case NEAR3:
          accumulate_sub<NEAR3, HAS_CHI>(s, base, nu_p, cutoff, acc0, acc1);
          break;
        default:
          accumulate_sub<NEAR4, HAS_CHI>(s, base, nu_p, cutoff, acc0, acc1);
          break;
      }
    }
  }
  out0[p] = acc0;
  out1[p] = acc1;
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
// `chi` may be null (no wing correction); cutoff = +inf disables the mask.
int opacity_batch_launch(const float* nu, const float* nuc, const float* sx,
                         const float* y, const float* chi, const float* amps,
                         const int* starts, const int* counts,
                         const int* active, float* out, int B, int Pp, int Lp,
                         float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || Pp <= 0 || Pp % TILE_P != 0 || Lp <= 0 ||
      Lp % BLOCK_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Pp / TILE_P, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chi != nullptr)
    opacity_batch_kernel<true><<<grid, TILE_P, 0, s>>>(
        nu, nuc, sx, y, chi, amps, starts, counts, active, out, Pp, Lp,
        cutoff);
  else
    opacity_batch_kernel<false><<<grid, TILE_P, 0, s>>>(
        nu, nuc, sx, y, nullptr, amps, starts, counts, active, out, Pp, Lp,
        cutoff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
