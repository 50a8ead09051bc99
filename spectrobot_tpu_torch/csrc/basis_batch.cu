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
// basis_transpose.cu).
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

#include "voigt_basis.cuh"

namespace {

constexpr int GROUP = 4;       // lines whose basis is held in registers
constexpr int N_SUB = BLOCK_L / SUB_L;
constexpr int N_WARP = TILE_P / 32;
static_assert(TILE_P == BLOCK_L, "each thread stages one line");
static_assert(SUB_L == 32 && N_SUB == N_WARP,
              "warp w reduces the bounds of sub-block w");
static_assert(SUB_L % GROUP == 0 && GROUP == 4, "float4 row reads");

// Dynamic shared memory per coefficient row: its output row (TILE_P
// floats) and its four staged sub-block rows (4 x SUB_L floats).
constexpr int ROW_BYTES = (TILE_P + 4 * SUB_L) * 4;
// The Hopper block limit (227 KB) less the static staging arrays.
constexpr int SMEM_LIMIT = 232448;
constexpr int STATIC_RESERVE = 4096;
constexpr int MAX_ROWS = (SMEM_LIMIT - STATIC_RESERVE) / ROW_BYTES;

struct Staged {
  float nuc[BLOCK_L];
  float sx[BLOCK_L];
  float y[BLOCK_L];
  float chi[BLOCK_L];
};

// One 32-line sub-block of the contraction for this thread's point.
// c_s: [4][R][SUB_L] staged rows; out_s: [R][TILE_P] output tile.
template <int TIER, bool HAS_CHI>
__device__ __forceinline__ void contract_sub(const Staged& s, int base,
                                             const float* __restrict__ c_s,
                                             float* __restrict__ out_s,
                                             int R, float nu_p, float cutoff,
                                             int tid) {
#pragma unroll 1
  for (int g = 0; g < SUB_L; g += GROUP) {
    float b[4][GROUP];
    bool any = false;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int i = base + g + j;
      any |= pair_basis<TIER, HAS_CHI>(nu_p - s.nuc[i], s.sx[i], s.y[i],
                                       HAS_CHI ? s.chi[i] : 0.0f, cutoff,
                                       b[0][j], b[1][j], b[2][j], b[3][j]);
    }
    if (!any) continue;        // every term would add an exact zero
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      float acc = out_s[r * TILE_P + tid];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 c =
            *reinterpret_cast<const float4*>(c_s + (k * R + r) * SUB_L + g);
        acc = fmaf(c.x, b[k][0], acc);
        acc = fmaf(c.y, b[k][1], acc);
        acc = fmaf(c.z, b[k][2], acc);
        acc = fmaf(c.w, b[k][3], acc);
      }
      out_s[r * TILE_P + tid] = acc;
    }
  }
}

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
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = tile * TILE_P + tid;
  float* out_b = out + (size_t)b * R * Pp;
  if (active[b] == 0) {        // uniform over the block: all threads leave
    for (int r = 0; r < R; ++r) out_b[(size_t)r * Pp + p] = 0.0f;
    return;
  }

  extern __shared__ float4 dyn[];
  float* out_s = reinterpret_cast<float*>(dyn);        // [R][TILE_P]
  float* c_s = out_s + R * TILE_P;                      // [4][R][SUB_L]
  __shared__ Staged s;
  __shared__ float s_lo[N_WARP], s_hi[N_WARP];
  __shared__ int s_tier[N_SUB];

  for (int r = 0; r < R; ++r) out_s[r * TILE_P + tid] = 0.0f;

  // The tile's true wavenumber bounds.
  const float nu_p = nu[p];
  {
    const float lo = warp_min(nu_p), hi = warp_max(nu_p);
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
  }
  __syncthreads();
  float tile_lo = s_lo[0], tile_hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < N_WARP; ++w) {
    tile_lo = fminf(tile_lo, s_lo[w]);
    tile_hi = fmaxf(tile_hi, s_hi[w]);
  }

  const size_t row = (size_t)b * Lp;
  const float* const cs[4] = {c1 + (size_t)b * R * Lp, c2 + (size_t)b * R * Lp,
                              c3 + (size_t)b * R * Lp, c4 + (size_t)b * R * Lp};
  const int start = starts[tile];
  const int count = counts[tile];
  for (int k = 0; k < count; ++k) {
    const int l0 = (start + k) * BLOCK_L;
    const size_t l = (size_t)l0 + tid;
    const float c = nuc[row + l];
    const float sxv = sx[row + l];
    const float yy = yv[row + l];
    __syncthreads();           // everyone is done with the previous block
    s.nuc[tid] = c;
    s.sx[tid] = sxv;
    s.y[tid] = yy;
    if (HAS_CHI) s.chi[tid] = chi[row + l];
    // Warp w holds the lines of sub-block w: reduce its bounds and pick
    // its tier (the decision of csrc/opacity_batch.cu).
    const float c_min = warp_min(c), c_max = warp_max(c);
    const float sx_min = warp_min(sxv), y_min = warp_min(yy);
    if (lane == 0)
      s_tier[warp] = sub_block_tier(c_min, c_max, sx_min, y_min, tile_lo,
                                    tile_hi);
#pragma unroll 1
    for (int sb = 0; sb < N_SUB; ++sb) {
      __syncthreads();         // c_s free, s and s_tier written
      // Stage the sub-block's rows as [4][R][SUB_L]: warp w copies rows
      // q = w, w + N_WARP, ... of the 4R (basis, row) pairs, one line per
      // lane (128 contiguous bytes per row).
      const int lb = l0 + sb * SUB_L + lane;
      for (int q = warp; q < 4 * R; q += N_WARP) {
        const int kk = q / R;
        c_s[q * SUB_L + lane] = cs[kk][(size_t)(q - kk * R) * Lp + lb];
      }
      __syncthreads();
      const int base = sb * SUB_L;
      switch (s_tier[sb]) {
        case FAR:
          contract_sub<FAR, HAS_CHI>(s, base, c_s, out_s, R, nu_p, cutoff,
                                     tid);
          break;
        case MID:
          contract_sub<MID, HAS_CHI>(s, base, c_s, out_s, R, nu_p, cutoff,
                                     tid);
          break;
        case NEAR3:
          contract_sub<NEAR3, HAS_CHI>(s, base, c_s, out_s, R, nu_p, cutoff,
                                       tid);
          break;
        default:
          contract_sub<NEAR4, HAS_CHI>(s, base, c_s, out_s, R, nu_p, cutoff,
                                       tid);
          break;
      }
    }
  }
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
