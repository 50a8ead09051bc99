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
// What bounds it: with the contraction on the tensor cores (3xTF32,
// basis_contract.cuh) the bound is the larger of the basis's FP32 work on
// the CUDA cores (per live pair roughly 2.5x the forward's Voigt
// evaluation: far ~30 flops, near4 ~700), the three TF32 passes of the
// contraction (4 FMAs per row per pair, 264 at the slice's R = 66, at
// 495 TFLOP/s) and the bytes: the [B, R, P] output written once (0.41 ms
// of the slice's 0.44 ms of bytes).  Before, the contraction ran as FP32
// FMAs beside shared-memory traffic on the [R, 128] output tile, 94 % of
// the FP32 bound.
//
// What the design does about it (basis_contract.cuh):
//  * One block of 8 warps per (128-point tile, state), 16 points per warp;
//    each (point, line) pair's basis is evaluated once, by the lane that
//    holds it in the A fragment, and split into hi/lo TF32 in registers.
//  * The coefficient rows arrive by cp.async into a ring of staging
//    buffers, three stages ahead, and each stage's rows are split once
//    into B fragments in shared memory; 12 mma.sync per 8 lines and 8
//    rows (4 basis values x 3 passes); one barrier per stage.
//  * The sums of all R rows stay in registers (NT n-tiles of 8 rows per
//    lane, NT = 2, 9 or 28 by R) and each output is written once: no
//    output tile in shared memory, no atomics, one fixed order.
//  * The tier geometry of K1: line blocks outside the wing cutoff are never
//    visited (host window table), the tier is chosen once per 32-line
//    sub-block from the true min/max of the shifted centres, far pairs run
//    the region-I derivative only, near-tier pairs evaluate only their own
//    region, pairs beyond the cutoff skip the basis, and stages and warp
//    groups with no pair inside the cutoff skip their products.
//  * Dead states (active[b] == 0) write zeros and return.
//  * mma.sync (m16n8k8) rather than wgmma: A comes straight from the lanes
//    that evaluate the basis in the layout mma.sync takes, and B needs no
//    shared-memory descriptors; wgmma with TMA-staged rows is the next
//    step (ROADMAP item 13).
//
// Occupancy (ptxas -v, sm_90a; 4,224 bytes of static shared memory per
// block): NT = 2 80 registers, 69,632 bytes of dynamic shared memory at
// R = 10, 3 blocks of 8 warps per SM; NT = 9 128 registers (32-48 bytes
// spilled), 92,160 bytes at R = 66, 2 blocks; NT = 28 214 registers,
// 200,704 bytes at R = 223, 1 block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_basis.py.

#include <cuda_runtime.h>

#include "basis_contract.cuh"

namespace {

// grid = (Pp / TILE_P, B), block = THREADS, smem_bytes(R) of dynamic shared
// memory.  nu [Pp]; nuc, sx, y, chi [B, Lp]; c1..c4 [B, R, Lp] (16-byte
// aligned); starts, counts [n_tiles]; active [B]; out [B, R, Pp].  NT
// n-tiles of 8 rows cover R.
template <int NT, bool HAS_CHI>
__global__ void __launch_bounds__(THREADS, min_blocks(NT))
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
  float* out_b = out + (size_t)b * R * Pp;
  if (active[b] == 0) {        // uniform over the block: all threads leave
    for (int i = threadIdx.x; i < R * TILE_P; i += THREADS)
      out_b[(size_t)(i / TILE_P) * Pp + tile * TILE_P + i % TILE_P] = 0.0f;
    return;
  }

  extern __shared__ float4 dyn[];
  __shared__ Shared sh;
  const int p0 = lane_point(tile);
  const float nu0 = nu[p0], nu1 = nu[p0 + 8];
  float tile_lo, tile_hi;
  tile_bounds(sh, nu0, nu1, tile_lo, tile_hi);

  const size_t row = (size_t)b * Lp;
  const float* const cs[4] = {c1 + (size_t)b * R * Lp, c2 + (size_t)b * R * Lp,
                              c3 + (size_t)b * R * Lp, c4 + (size_t)b * R * Lp};
  float acc[NT][4] = {};
  contract_window<NT, HAS_CHI>(
      sh, reinterpret_cast<float*>(dyn), nuc + row, sx + row, yv + row,
      HAS_CHI ? chi + row : nullptr, cs, R, Lp, starts[tile] * BLOCK_L,
      counts[tile] * GROUPS_PER_BLOCK, nu0, nu1, tile_lo, tile_hi, cutoff,
      acc);
  store_rows<NT>(out_b, acc, R, Pp, p0);
}

template <bool HAS_CHI>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* c1,
                   const float* c2, const float* c3, const float* c4,
                   const int* starts, const int* counts, const int* active,
                   float* out, int B, int R, int Pp, int Lp, float cutoff,
                   cudaStream_t stream) {
  return with_width(R, [&](auto width) {
    constexpr int NT = decltype(width)::value;
    const int smem = smem_bytes(R);
    cudaError_t err = cudaFuncSetAttribute(
        basis_batch_kernel<NT, HAS_CHI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Pp / TILE_P, B);
    basis_batch_kernel<NT, HAS_CHI><<<grid, THREADS, smem, stream>>>(
        nu, nuc, sx, y, chi, c1, c2, c3, c4, starts, counts, active, out, R,
        Pp, Lp, cutoff);
    return cudaGetLastError();
  });
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
// disables the mask; c1..c4 must be 16-byte aligned (cp.async).
int basis_batch_launch(const float* nu, const float* nuc, const float* sx,
                       const float* y, const float* chi, const float* c1,
                       const float* c2, const float* c3, const float* c4,
                       const int* starts, const int* counts,
                       const int* active, float* out, int B, int R, int Pp,
                       int Lp, float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || R <= 0 || R > MAX_ROWS || Pp <= 0 ||
      Pp % TILE_P != 0 || Lp <= 0 || Lp % BLOCK_L != 0 ||
      !rows_aligned(c1, c2, c3, c4))
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
