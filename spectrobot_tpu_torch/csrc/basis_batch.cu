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
// (csrc/opacity_batch.cu), tier by tier.
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

namespace {

constexpr int TILE_P = 128;    // grid points per block = threads per block
constexpr int BLOCK_L = 128;   // lines staged per window block
constexpr int SUB_L = 32;      // lines per tier decision = one warp
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

constexpr float INV_SQRT_PI = 0.56418958354775628f;
constexpr float A2 = 1.410474f;
constexpr float CHI_DELTA1 = 3.0f;
constexpr float Y4_MIN = 0.9f;

enum Tier { FAR = 0, MID = 1, NEAR3 = 2, NEAR4 = 3 };

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Complex arithmetic on (re, im) pairs, as ops/cpx.py.
struct cf {
  float r, i;
};

__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}

__device__ __forceinline__ cf csub(cf a, cf b) { return {a.r - b.r, a.i - b.i}; }

__device__ __forceinline__ cf cscale(float s, cf a) { return {s * a.r, s * a.i}; }

// 1/b staged as conj(b) * (1/|b|^2): the largest intermediate is |b|^2.
__device__ __forceinline__ cf cinv(cf b) {
  const float inv = 1.0f / (b.r * b.r + b.i * b.i);
  return {b.r * inv, -b.i * inv};
}

// Horner evaluation at complex z of a polynomial with real coefficients
// (highest degree first).
template <int N>
__device__ __forceinline__ cf cpoly(const float (&c)[N], cf z) {
  cf p = {c[0], 0.0f};
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float r = p.r * z.r - p.i * z.i + c[k];
    p.i = p.r * z.i + p.i * z.r;
    p.r = r;
  }
  return p;
}

// Coefficients (highest degree first) of w4 regions III and IV and of their
// derivative polynomials.
__device__ __forceinline__ void region3(cf t, float& K, cf& g) {
  const float N3[5] = {0.5642236f, 3.778987f, 11.96482f, 20.20933f, 16.4955f};
  const float D3[6] = {1.0f, 6.699398f, 21.69274f, 39.27121f, 38.82363f,
                       16.4955f};
  const float dN3[4] = {4.0f * 0.5642236f, 3.0f * 3.778987f,
                        2.0f * 11.96482f, 20.20933f};
  const float dD3[5] = {5.0f * 1.0f, 4.0f * 6.699398f, 3.0f * 21.69274f,
                        2.0f * 39.27121f, 38.82363f};
  const cf invD = cinv(cpoly(D3, t));
  const cf w = cmul(cpoly(N3, t), invD);
  g = csub(cmul(cpoly(dN3, t), invD), cmul(w, cmul(cpoly(dD3, t), invD)));
  K = w.r;
}

__device__ __forceinline__ void region4(cf t, float& K, cf& g) {
  const float P4[7] = {0.56419f, -1.320522f, 35.76683f, -219.0313f,
                       1540.787f, -3321.9905f, 36183.31f};
  const float Q4[8] = {-1.0f, 1.841439f, -61.57037f, 364.2191f,
                       -2186.181f, 9022.228f, -24322.84f, 32066.6f};
  const float dP4[6] = {6.0f * 0.56419f, 5.0f * -1.320522f,
                        4.0f * 35.76683f, 3.0f * -219.0313f,
                        2.0f * 1540.787f, -3321.9905f};
  const float dQ4[7] = {7.0f * -1.0f, 6.0f * 1.841439f, 5.0f * -61.57037f,
                        4.0f * 364.2191f, 3.0f * -2186.181f,
                        2.0f * 9022.228f, -24322.84f};
  const cf u = cmul(t, t);
  const cf invQ = cinv(cpoly(Q4, u));
  const cf F = cmul(cpoly(P4, u), invQ);
  float sn, cs;
  sincosf(u.i, &sn, &cs);
  const float ex = expf(u.r);
  const cf eu = {ex * cs, ex * sn};
  const cf w = csub(eu, cmul(t, F));
  const cf dF = csub(cmul(cpoly(dP4, u), invQ),
                     cmul(F, cmul(cpoly(dQ4, u), invQ)));
  const cf tu = cmul(t, eu);
  const cf udF = cmul(u, dF);
  g = {2.0f * tu.r - (F.r + 2.0f * udF.r), 2.0f * tu.i - (F.i + 2.0f * udF.i)};
  K = w.r;
}

// Region I (s >= 15): f = c t / (0.5 + u), f' = c (0.5 - u) / (0.5 + u)^2.
__device__ __forceinline__ void region1(float x, float y, float& K, cf& g) {
  const float ur = y * y - x * x;
  const float ui = -2.0f * x * y;
  const cf den = {0.5f + ur, ui};
  const cf inv = cinv(den);
  K = INV_SQRT_PI * y * (0.5f + y * y + x * x) /
      (den.r * den.r + den.i * den.i);
  g = cmul(cscale(INV_SQRT_PI, cf{0.5f - ur, -ui}), cmul(inv, inv));
}

// Region II (s >= 5.5): f = t (a + c u) / D, D = 0.75 + u (3 + u);
// f' = Nd(u) / D^2.
__device__ __forceinline__ void region2(float x, float y, float& K, cf& g) {
  const float ND2[4] = {-INV_SQRT_PI, 3.0f * (INV_SQRT_PI - A2),
                        2.25f * INV_SQRT_PI - 3.0f * A2, 0.75f * A2};
  const cf u = {y * y - x * x, -2.0f * x * y};
  const cf den = {0.75f + (u.r * (3.0f + u.r) - u.i * u.i),
                  u.r * u.i + u.i * (3.0f + u.r)};
  const cf inv = cinv(den);
  const cf num = cmul(cf{y, -x}, cf{A2 + INV_SQRT_PI * u.r, INV_SQRT_PI * u.i});
  K = cmul(num, inv).r;
  g = cmul(cmul(cpoly(ND2, u), inv), inv);
}

// K and f' of one pair with the regions its tier allows; dK/dx = Im f',
// dK/dy = Re f'.
template <int TIER>
__device__ __forceinline__ void basis_pair(float x, float y, float& K,
                                           float& kx, float& ky) {
  cf g;
  const float s = fabsf(x) + y;
  if (TIER == FAR || s >= 15.0f) {
    region1(x, y, K, g);
  } else if (TIER == MID || s >= 5.5f) {
    region2(x, y, K, g);
  } else if (TIER == NEAR4 && y < 0.195f * fabsf(x) - 0.176f) {
    region4(cf{y, -x}, K, g);
  } else {
    region3(cf{y, -x}, K, g);
  }
  kx = g.i;
  ky = g.r;
}

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
      const float dnu = nu_p - s.nuc[i];
      b[0][j] = b[1][j] = b[2][j] = b[3][j] = 0.0f;
      if (fabsf(dnu) <= cutoff) {
        const float x = dnu * s.sx[i];
        float K, kx, ky;
        basis_pair<TIER>(x, s.y[i], K, kx, ky);
        if (HAS_CHI) {
          const float ch = expf(-s.chi[i] * fmaxf(fabsf(dnu) - CHI_DELTA1,
                                                  0.0f));
          K *= ch;
          kx *= ch;
          ky *= ch;
        }
        b[0][j] = K;
        b[1][j] = kx;
        b[2][j] = x * kx;
        b[3][j] = ky;
        any = true;
      }
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
    if (lane == 0) {
      const float gap = fmaxf(fmaxf(c_min - tile_hi, tile_lo - c_max), 0.0f);
      // __fmul_rn keeps the product out of an FMA, so the host's
      // tier_counts reproduces the decision exactly.
      const float s_min = __fmul_rn(gap, sx_min) + y_min;
      s_tier[warp] = s_min >= 15.0f  ? FAR
                     : s_min >= 5.5f ? MID
                     : y_min >= Y4_MIN ? NEAR3
                                       : NEAR4;
    }
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
