// Batched fused basis contraction of the line sum's tangent: the CUDA port of
// the TPU kernel spectrobot_tpu/ops/pallas_opacity.py:_basis_batch_kernel
// (K2), which every forward-mode Jacobian of the line sum runs.
//
//   out[b, r, p] = sum_i ( C1[b, r, i] K  + C2[b, r, i] Kx
//                        + C3[b, r, i] xKx + C4[b, r, i] Ky )
//   K = Re w(x, y) * chi * [|dnu| <= cutoff],  Kx = dK/dx,  Ky = dK/dy,
//   xKx = x Kx,   dnu = nu[p] - nu_c[b, i],   x = dnu * sx[b, i]
//
// b runs over the (ray x layer) states, i over the lines, r over the
// coefficient rows: every Jacobian column (x 2 depths) is a row, so the
// basis is evaluated once per (point, line) pair for the whole Jacobian.
// chi = exp(-chi_bi max(|dnu| - 3, 0)) scales all four basis values and is
// constant in the tangent (frozen-chi convention).  Each tier evaluates the
// closed-form derivative of the formula its primal uses (the regions of
// Humlicek's w4), so the Jacobian is the derivative of the forward kernel
// (csrc/opacity_batch.cu), tier by tier.  The per-pair basis and the tier
// decision live in voigt_basis.cuh, shared with the transpose (K5,
// basis_transpose.cu); the thread block's contraction in basis_contract.cuh,
// shared with the single-state contraction (K4, basis_single.cu).
//
// What bounds it: FP32 work on the CUDA cores.  Per live (point, line) pair
// the basis costs roughly 2.5x the forward's Voigt evaluation (far ~30
// flops, near4 ~700), and the contraction 4 FMAs per row: 264 FMAs at the
// slice's R = 66, more than the basis itself.  The contraction's operands
// come from shared memory (the coefficient rows, read as broadcasts) and
// the output tile lives in shared memory, so shared-memory instruction
// issue sits beside the FMAs.  Device-memory bytes are small: the rows are
// read once per (tile, state) and the tile written once.
//
// What the design does about it:
//  * One block per (128-point tile, state), one point per thread; the
//    [R, 128] output tile sits in shared memory and each thread touches only
//    its own column, so updates never conflict (no atomics, deterministic,
//    one fixed order: line block, sub-block, line group, line, basis row).
//  * The basis of a group of GROUP lines is evaluated once into registers
//    and then contracted against all R rows; the coefficient rows of a
//    32-line sub-block are staged in shared memory and read as float4
//    broadcasts (the same address across the warp).
//  * The tier geometry of K1: line blocks outside the wing cutoff are never
//    visited (host window table), the tier is chosen once per 32-line
//    sub-block from the true min/max of the shifted centres, far pairs run
//    the region-I derivative only, near-tier pairs evaluate only their own
//    region, pairs beyond the cutoff skip the basis.
//  * Dead states (active[b] == 0) write zeros and return.
//  * Full fp32 FMAs, no tensor cores, no TF32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_basis.py.

#include <cuda_runtime.h>

#include "basis_contract.cuh"

namespace {

// grid = (Pp / TILE_P, B), block = TILE_P threads, R * ROW_BYTES bytes of
// dynamic shared memory.  nu [Pp]; nuc, sx, y, chi [B, Lp]; c1..c4
// [B, R, Lp]; starts, counts [n_tiles]; active [B]; out [B, R, Pp].
template <bool HAS_CHI>
__global__ void __launch_bounds__(TILE_P)
basis_batch_kernel(const float* __restrict__ nu,
                   const float* __restrict__ nuc,
                   const float* __restrict__ sx,
                   const float* __restrict__ yv,
                   const float* __restrict__ chi,
                   const float* __restrict__ c1,
                   const float* __restrict__ c2,
                   const float* __restrict__ c3,
                   const float* __restrict__ c4,
                   const int* __restrict__ starts,
                   const int* __restrict__ counts,
                   const int* __restrict__ active,
                   float* __restrict__ out, int R, int Pp, int Lp,
                   float cutoff) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int p = tile * TILE_P + tid;
  float* out_b = out + (size_t)b * R * Pp;
  if (active[b] == 0) {        // uniform over the block: all threads leave
    for (int r = 0; r < R; ++r) out_b[(size_t)r * Pp + p] = 0.0f;
    return;
  }

  extern __shared__ float4 dyn[];
  float* out_s = reinterpret_cast<float*>(dyn);        // [R][TILE_P]
  float* c_s = out_s + R * TILE_P;                      // [4][R][SUB_L]
  __shared__ Shared sh;

  for (int r = 0; r < R; ++r) out_s[r * TILE_P + tid] = 0.0f;
  const float nu_p = nu[p];
  float tile_lo, tile_hi;
  tile_bounds(sh, nu_p, tile_lo, tile_hi);

  const size_t row = (size_t)b * Lp;
  const float* const cs[4] = {c1 + (size_t)b * R * Lp, c2 + (size_t)b * R * Lp,
                              c3 + (size_t)b * R * Lp, c4 + (size_t)b * R * Lp};
  const int start = starts[tile];
  const int count = counts[tile];
  for (int k = 0; k < count; ++k)
    contract_block<HAS_CHI>(sh, nuc + row, sx + row, yv + row,
                            HAS_CHI ? chi + row : nullptr, cs, c_s, out_s, R,
                            Lp, (start + k) * BLOCK_L, nu_p, tile_lo, tile_hi,
                            cutoff);
  for (int r = 0; r < R; ++r) out_b[(size_t)r * Pp + p] = out_s[r * TILE_P + tid];
}

template <bool HAS_CHI>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* c1,
                   const float* c2, const float* c3, const float* c4,
                   const int* starts, const int* counts, const int* active,
                   float* out, int B, int R, int Pp, int Lp, float cutoff,
                   cudaStream_t stream) {
  const int smem = R * ROW_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      basis_batch_kernel<HAS_CHI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Pp / TILE_P, B);
  basis_batch_kernel<HAS_CHI><<<grid, TILE_P, smem, stream>>>(
      nu, nuc, sx, y, chi, c1, c2, c3, c4, starts, counts, active, out, R, Pp,
      Lp, cutoff);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile and block geometry and the row limit, so the wrapper can check its
// window tables and its inputs against the kernel that reads them.
int basis_batch_tile_p() { return TILE_P; }
int basis_batch_block_l() { return BLOCK_L; }
int basis_batch_sub_l() { return SUB_L; }
int basis_batch_max_rows() { return MAX_ROWS; }

const char* basis_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns the CUDA error of the launch (0 =
// launched).  `chi` may be null (no wing correction); cutoff = +inf
// disables the mask.
int basis_batch_launch(const float* nu, const float* nuc, const float* sx,
                       const float* y, const float* chi, const float* c1,
                       const float* c2, const float* c3, const float* c4,
                       const int* starts, const int* counts,
                       const int* active, float* out, int B, int R, int Pp,
                       int Lp, float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || R <= 0 || R > MAX_ROWS || Pp <= 0 ||
      Pp % TILE_P != 0 || Lp <= 0 || Lp % BLOCK_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      chi != nullptr
          ? launch<true>(nu, nuc, sx, y, chi, c1, c2, c3, c4, starts, counts,
                         active, out, B, R, Pp, Lp, cutoff, s)
          : launch<false>(nu, nuc, sx, y, nullptr, c1, c2, c3, c4, starts,
                          counts, active, out, B, R, Pp, Lp, cutoff, s);
  return static_cast<int>(err);
}

}  // extern "C"
