// Batched transposed basis contraction, the reverse-mode kernel of the line
// sum: the CUDA port of the TPU kernel
// spectrobot_tpu/ops/pallas_opacity.py:_basis_transpose_kernel (K5), which
// the reference's custom-VJP line sum (analytic_jvp='rev') runs once per
// gradient.
//
//   AbK[b, r, i]   = sum_p ct[b, r, p] K(p, i)     (and likewise Kx, xKx, Ky)
//
// with the basis {K, Kx, xKx, Ky} of voigt_basis.cuh at every (point p,
// line i) pair of state b: the cotangent projections that reverse-mode AD
// contracts into the (nu_c, sx, y, amps) cotangents (a small epilogue in
// ops/opacity.py).  r runs over the cotangent rows: the two depths under
// torch.autograd.grad, 2 n_ct when torch.func.jacrev folds its n_ct
// cotangents into the rows.  The basis is evaluated by the functions K2
// (basis_batch.cu) uses, with K2's tile, block and 32-line sub-block and
// K2's tier decision, so this kernel is the exact adjoint of K2 and the
// host's tier_counts holds for it.
//
// What bounds it: FP32 work on the CUDA cores, the basis (far ~30 flops per
// pair, near4 ~700) and 4 FMAs per row per pair (8 at R = 2, the gradient;
// 264 at R = 66).  Device-memory bytes are small: the cotangent rows are
// read once per visited (line block, tile) and the [4, R, L] output written
// once.
//
// What the design does about it:
//  * One block per (128-line block, state), one line per thread: warp w
//    owns sub-block w, so the tier of each (tile, sub-block) is
//    warp-uniform and is decided from the warp's own line bounds.
//  * The block walks its tile window (host table, the transpose of K2's
//    block windows: the same visited (tile, block) pairs), staging each
//    tile's grid points and [R, 128] cotangent rows in shared memory and
//    reading the rows as float4 broadcasts (the same address across the
//    warp).  The basis of GROUP points is evaluated into registers, then
//    contracted against every row.
//  * Each line's 4R sums accumulate in fp32, in point order: in registers
//    at R <= 2, else in a shared [4R, 128] tile, one column per thread.
//    Deterministic: no atomics, no TF32, no fast math.
//  * Dead states are those whose cotangent rows are all zero (active[b] ==
//    0): they write zeros and return.  A zero-amplitude state is NOT dead
//    here: its amplitude cotangent <ct, K> is not zero.
//  * Padded grid points (p >= P) are masked like pairs beyond the cutoff.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_transpose.py.

#include <cuda_runtime.h>

#include "voigt_basis.cuh"

namespace {

constexpr int GROUP = 4;       // points whose basis is held in registers
constexpr int N_WARP = BLOCK_L / 32;
constexpr int REG_ROWS = 2;    // rows whose sums are kept in registers
static_assert(TILE_P == BLOCK_L, "each thread stages one point per tile");
static_assert(SUB_L == 32, "one warp per sub-block");
static_assert(TILE_P % GROUP == 0 && GROUP == 4, "float4 row reads");

// Dynamic shared memory per cotangent row: its staged tile row (TILE_P
// floats) and, above REG_ROWS, its four accumulator rows (4 x BLOCK_L).
constexpr int CT_ROW_BYTES = TILE_P * 4;
constexpr int ROW_BYTES = CT_ROW_BYTES + 4 * BLOCK_L * 4;
// The Hopper block limit (227 KB) less the static staging arrays.
constexpr int SMEM_LIMIT = 232448;
constexpr int STATIC_RESERVE = 4096;
constexpr int MAX_ROWS = (SMEM_LIMIT - STATIC_RESERVE) / ROW_BYTES;

// One staged tile for this thread's line: every real point of the tile, in
// order, GROUP points at a time.  ct_s: [R][TILE_P]; acc_s: [4][R][BLOCK_L]
// (REG == false) or acc (REG == true).
template <int TIER, bool HAS_CHI, bool REG>
__device__ __forceinline__ void walk_tile(const float* __restrict__ nu_s,
                                          const float* __restrict__ ct_s,
                                          float* __restrict__ acc_s,
                                          float (&acc)[4][REG_ROWS], int R,
                                          int n_valid, float nuc, float sx,
                                          float y, float chi_b, float cutoff,
                                          int tid) {
#pragma unroll 1
  for (int g = 0; g < n_valid; g += GROUP) {
    float b[4][GROUP];
    bool any = false;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (g + j < n_valid) {
        any |= pair_basis<TIER, HAS_CHI>(nu_s[g + j] - nuc, sx, y, chi_b,
                                         cutoff, b[0][j], b[1][j], b[2][j],
                                         b[3][j]);
      } else {                 // a padded point: all four values 0
        b[0][j] = b[1][j] = b[2][j] = b[3][j] = 0.0f;
      }
    }
    if (!any) continue;        // every term would add an exact zero
    if (REG) {
#pragma unroll
      for (int r = 0; r < REG_ROWS; ++r) {
        if (r >= R) break;
        const float4 c = *reinterpret_cast<const float4*>(ct_s + r * TILE_P + g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float a = acc[k][r];
          a = fmaf(c.x, b[k][0], a);
          a = fmaf(c.y, b[k][1], a);
          a = fmaf(c.z, b[k][2], a);
          a = fmaf(c.w, b[k][3], a);
          acc[k][r] = a;
        }
      }
    } else {
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float4 c = *reinterpret_cast<const float4*>(ct_s + r * TILE_P + g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* slot = acc_s + (k * R + r) * BLOCK_L + tid;
          float a = *slot;
          a = fmaf(c.x, b[k][0], a);
          a = fmaf(c.y, b[k][1], a);
          a = fmaf(c.z, b[k][2], a);
          a = fmaf(c.w, b[k][3], a);
          *slot = a;
        }
      }
    }
  }
}

// grid = (Lp / BLOCK_L, B), block = BLOCK_L threads, R * CT_ROW_BYTES
// (REG) or R * ROW_BYTES bytes of dynamic shared memory.  nu [Pp]; nuc, sx,
// y, chi [B, Lp]; ct [B, R, Pp] (zero beyond P); tstarts, tcounts
// [n_blocks]; active [B]; oK, oKx, oxKx, oKy [B, R, Lp].
template <bool HAS_CHI, bool REG>
__global__ void __launch_bounds__(BLOCK_L)
basis_transpose_kernel(const float* __restrict__ nu,
                       const float* __restrict__ nuc,
                       const float* __restrict__ sx,
                       const float* __restrict__ yv,
                       const float* __restrict__ chi,
                       const float* __restrict__ ct,
                       const int* __restrict__ tstarts,
                       const int* __restrict__ tcounts,
                       const int* __restrict__ active,
                       float* __restrict__ oK, float* __restrict__ oKx,
                       float* __restrict__ oxKx, float* __restrict__ oKy,
                       int R, int P, int Pp, int Lp, float cutoff) {
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t l = (size_t)blk * BLOCK_L + tid;
  const size_t orow = (size_t)b * R * Lp + l;
  float* const outs[4] = {oK + orow, oKx + orow, oxKx + orow, oKy + orow};
  if (active[b] == 0) {        // uniform over the block: all threads leave
    for (int r = 0; r < R; ++r)
      for (int k = 0; k < 4; ++k) outs[k][(size_t)r * Lp] = 0.0f;
    return;
  }

  extern __shared__ float4 dyn[];
  float* ct_s = reinterpret_cast<float*>(dyn);         // [R][TILE_P]
  float* acc_s = ct_s + R * TILE_P;                     // [4][R][BLOCK_L]
  __shared__ float nu_s[TILE_P];
  __shared__ float s_lo[N_WARP], s_hi[N_WARP];

  // This thread's line, and the bounds of its warp's sub-block (fixed over
  // the whole tile walk).
  const size_t row = (size_t)b * Lp + l;
  const float c = nuc[row];
  const float sxv = sx[row];
  const float yy = yv[row];
  const float chv = HAS_CHI ? chi[row] : 0.0f;
  const float c_min = warp_min(c), c_max = warp_max(c);
  const float sx_min = warp_min(sxv), y_min = warp_min(yy);

  float acc[4][REG_ROWS];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) acc[k][r] = 0.0f;
  if (!REG)
    for (int q = 0; q < 4 * R; ++q) acc_s[q * BLOCK_L + tid] = 0.0f;

  const float* ct_b = ct + (size_t)b * R * Pp;
  const int start = tstarts[blk];
  const int count = tcounts[blk];
  for (int t = 0; t < count; ++t) {
    const int p0 = (start + t) * TILE_P;
    __syncthreads();           // everyone is done with the previous tile
    const float nu_p = nu[p0 + tid];
    nu_s[tid] = nu_p;
    for (int r = 0; r < R; ++r)
      ct_s[r * TILE_P + tid] = ct_b[(size_t)r * Pp + p0 + tid];
    // The tile's true wavenumber bounds (padded points included, as K2).
    const float lo = warp_min(nu_p), hi = warp_max(nu_p);
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();
    float tile_lo = s_lo[0], tile_hi = s_hi[0];
#pragma unroll
    for (int w = 1; w < N_WARP; ++w) {
      tile_lo = fminf(tile_lo, s_lo[w]);
      tile_hi = fmaxf(tile_hi, s_hi[w]);
    }
    const int n_valid = min(TILE_P, P - p0);
    switch (sub_block_tier(c_min, c_max, sx_min, y_min, tile_lo, tile_hi)) {
      case FAR:
        walk_tile<FAR, HAS_CHI, REG>(nu_s, ct_s, acc_s, acc, R, n_valid, c,
                                     sxv, yy, chv, cutoff, tid);
        break;
      case MID:
        walk_tile<MID, HAS_CHI, REG>(nu_s, ct_s, acc_s, acc, R, n_valid, c,
                                     sxv, yy, chv, cutoff, tid);
        break;
      case NEAR3:
        walk_tile<NEAR3, HAS_CHI, REG>(nu_s, ct_s, acc_s, acc, R, n_valid, c,
                                       sxv, yy, chv, cutoff, tid);
        break;
      default:
        walk_tile<NEAR4, HAS_CHI, REG>(nu_s, ct_s, acc_s, acc, R, n_valid, c,
                                       sxv, yy, chv, cutoff, tid);
        break;
    }
  }
  if (REG) {
#pragma unroll
    for (int r = 0; r < REG_ROWS; ++r) {
      if (r >= R) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) outs[k][(size_t)r * Lp] = acc[k][r];
    }
  } else {
    for (int r = 0; r < R; ++r)
      for (int k = 0; k < 4; ++k)
        outs[k][(size_t)r * Lp] = acc_s[(k * R + r) * BLOCK_L + tid];
  }
}

template <bool HAS_CHI, bool REG>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* ct,
                   const int* tstarts, const int* tcounts, const int* active,
                   float* oK, float* oKx, float* oxKx, float* oKy, int B,
                   int R, int P, int Pp, int Lp, float cutoff,
                   cudaStream_t stream) {
  const int smem = R * (REG ? CT_ROW_BYTES : ROW_BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      basis_transpose_kernel<HAS_CHI, REG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lp / BLOCK_L, B);
  basis_transpose_kernel<HAS_CHI, REG><<<grid, BLOCK_L, smem, stream>>>(
      nu, nuc, sx, y, chi, ct, tstarts, tcounts, active, oK, oKx, oxKx, oKy,
      R, P, Pp, Lp, cutoff);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile and block geometry and the row limit, so the wrapper can check its
// window tables and its inputs against the kernel that reads them.
int basis_transpose_tile_p() { return TILE_P; }
int basis_transpose_block_l() { return BLOCK_L; }
int basis_transpose_sub_l() { return SUB_L; }
int basis_transpose_max_rows() { return MAX_ROWS; }

const char* basis_transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns the CUDA error of the launch (0 =
// launched).  `chi` may be null (no wing correction); cutoff = +inf
// disables the mask.
int basis_transpose_launch(const float* nu, const float* nuc, const float* sx,
                           const float* y, const float* chi, const float* ct,
                           const int* tstarts, const int* tcounts,
                           const int* active, float* oK, float* oKx,
                           float* oxKx, float* oKy, int B, int R, int P,
                           int Pp, int Lp, float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || R <= 0 || R > MAX_ROWS || P <= 0 || P > Pp ||
      Pp % TILE_P != 0 || Lp <= 0 || Lp % BLOCK_L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chi != nullptr)
    err = R <= REG_ROWS
              ? launch<true, true>(nu, nuc, sx, y, chi, ct, tstarts, tcounts,
                                   active, oK, oKx, oxKx, oKy, B, R, P, Pp,
                                   Lp, cutoff, s)
              : launch<true, false>(nu, nuc, sx, y, chi, ct, tstarts, tcounts,
                                    active, oK, oKx, oxKx, oKy, B, R, P, Pp,
                                    Lp, cutoff, s);
  else
    err = R <= REG_ROWS
              ? launch<false, true>(nu, nuc, sx, y, nullptr, ct, tstarts,
                                    tcounts, active, oK, oKx, oxKx, oKy, B, R,
                                    P, Pp, Lp, cutoff, s)
              : launch<false, false>(nu, nuc, sx, y, nullptr, ct, tstarts,
                                     tcounts, active, oK, oKx, oxKx, oKy, B,
                                     R, P, Pp, Lp, cutoff, s);
  return static_cast<int>(err);
}

}  // extern "C"
