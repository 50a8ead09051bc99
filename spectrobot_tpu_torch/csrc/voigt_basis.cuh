// Device code shared by the basis contraction (K2, basis_batch.cu) and its
// transpose (K5, basis_transpose.cu): the tile geometry, the tier decision
// and the per-pair basis {K, Kx, xKx, Ky} of Humlicek's w4 with its closed-
// form derivative per region.  Both kernels evaluate every (point, line)
// pair through the same functions, so K5 is the exact adjoint of K2 and the
// host's tier_counts (ops/cuda_opacity.py) holds for both.
//
// K = Re w(x, y) * chi * [|dnu| <= cutoff],  Kx = dK/dx,  Ky = dK/dy,
// xKx = x Kx,   x = dnu * sx,   chi = exp(-chi_b max(|dnu| - 3, 0)).
// chi scales all four values and is constant in the derivative (frozen-chi
// convention).  Each tier evaluates the closed-form derivative of the
// formula its primal uses (csrc/opacity_batch.cu), tier by tier.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_P = 128;    // grid points per tile
constexpr int BLOCK_L = 128;   // lines per window block
constexpr int SUB_L = 32;      // lines per tier decision = one warp

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

// The tier of one (tile, 32-line sub-block) from the tile's true wavenumber
// bounds and the sub-block's bounds (the decision of csrc/opacity_batch.cu).
// __fmul_rn keeps the product out of an FMA, so the host's tier_counts
// reproduces the decision exactly.
__device__ __forceinline__ int sub_block_tier(float c_min, float c_max,
                                              float sx_min, float y_min,
                                              float tile_lo, float tile_hi) {
  const float gap = fmaxf(fmaxf(c_min - tile_hi, tile_lo - c_max), 0.0f);
  const float s_min = __fmul_rn(gap, sx_min) + y_min;
  return s_min >= 15.0f  ? FAR
         : s_min >= 5.5f ? MID
         : y_min >= Y4_MIN ? NEAR3
                           : NEAR4;
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

// The basis (K, Kx, xKx, Ky) of one (point, line) pair at dnu = nu - nu_c,
// with chi and the cutoff mask; all four are 0 beyond the cutoff.  Returns
// whether the pair lies within it.
template <int TIER, bool HAS_CHI>
__device__ __forceinline__ bool pair_basis(float dnu, float sx, float y,
                                           float chi_b, float cutoff,
                                           float& K, float& kx, float& xkx,
                                           float& ky) {
  K = kx = xkx = ky = 0.0f;
  if (!(fabsf(dnu) <= cutoff)) return false;
  const float x = dnu * sx;
  basis_pair<TIER>(x, y, K, kx, ky);
  if (HAS_CHI) {
    const float ch = expf(-chi_b * fmaxf(fabsf(dnu) - CHI_DELTA1, 0.0f));
    K *= ch;
    kx *= ch;
    ky *= ch;
  }
  xkx = x * kx;
  return true;
}

}  // namespace
