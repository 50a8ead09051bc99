// Device code shared by the opacity line sums: the batched one (K1,
// opacity_batch.cu), the single-state one (K3, opacity_single.cu) and the
// fused halo accumulation (dma_halo.cu), through line_sum_item.cuh.  The
// tile geometry, the tier decision and the per-pair Re w of Humlicek's w4
// (spectrobot_tpu/ops/voigt.py) live here once, so the three kernels
// evaluate every (point, line) pair alike and the host's tier_counts
// (ops/cuda_opacity.py) holds for all of them.
//
//   wr = Re w(x, y) * exp(-chi_b * max(|dnu| - 3, 0)) * [|dnu| <= cutoff]
//   x = dnu * sx,   dnu = nu[p] - nu_c[i]
//
// Every product that meets a sum is written out: fmaf where it is fused,
// __fmul_rn where it is not.  The compiler's own contraction of a * b + c
// depends on the code around it, so with plain operators the same pair
// could round differently in K1, K3 and the fused halo kernel; written out,
// each pair gives the same wr in every kernel that includes this header.
//
// The tier of a (tile, 32-line sub-block) is chosen from a conservative
// bound on s = |x| + y, uniformly for the sub-block, so the switch over
// tiers never diverges inside a warp:
//   s_min = gap * min(sx) + min(y),
//   gap   = max(min nu_c - tile_hi, tile_lo - max nu_c, 0)
// far (s_min >= 15): region-1 rational only; mid (s_min >= 5.5): region 1
// or 2 per pair; near3 (min y >= 0.9, so region IV is empty): regions I-III
// per pair; near4: all four regions per pair.  In the near tiers a pair
// evaluates only its own region.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_P = 128;    // grid points per tile
constexpr int BLOCK_L = 128;   // lines staged per window block
constexpr int SUB_L = 32;      // lines per tier decision = one warp
constexpr int N_SUB = BLOCK_L / SUB_L;
static_assert(SUB_L == 32, "a warp decides the tier of a sub-block");

constexpr float INV_SQRT_PI = 0.56418958354775628f;
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

// The tier of one (tile, sub-block), warp-wide: each lane of the warp holds
// one line (center c, scale sxv, y yy) of its sub-block; every lane gets
// the tier.  __fmul_rn keeps the product out of an FMA, so the host's
// tier_counts reproduces the decision exactly.
__device__ __forceinline__ int sub_block_tier(float c, float sxv, float yy,
                                              float tile_lo, float tile_hi) {
  const float c_min = warp_min(c), c_max = warp_max(c);
  const float sx_min = warp_min(sxv), y_min = warp_min(yy);
  const float gap = fmaxf(fmaxf(c_min - tile_hi, tile_lo - c_max), 0.0f);
  const float s_min = __fmul_rn(gap, sx_min) + y_min;
  return s_min >= 15.0f  ? FAR
         : s_min >= 5.5f ? MID
         : y_min >= Y4_MIN ? NEAR3
                           : NEAR4;
}

// Horner evaluation at complex z of a polynomial with real coefficients
// (highest degree first).
template <int N>
__device__ __forceinline__ void cpoly(const float (&c)[N], float zr, float zi,
                                      float& pr, float& pi) {
  pr = c[0];
  pi = 0.0f;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float r = fmaf(pr, zr, fmaf(-pi, zi, c[k]));
    pi = fmaf(pr, zi, __fmul_rn(pi, zr));
    pr = r;
  }
}

// Region I (s >= 15): Re w = c y (0.5 + x^2 + y^2) / |0.5 + t^2|^2.
__device__ __forceinline__ float wr_region1(float x, float y) {
  const float h = fmaf(y, y, 0.5f);
  const float a = fmaf(-x, x, h);
  const float b = 2.0f * x * y;
  return INV_SQRT_PI * y * fmaf(x, x, h) / fmaf(a, a, __fmul_rn(b, b));
}

// Region II (s >= 5.5): w = t (1.410474 + c u) / (0.75 + u (3 + u)), u = t^2.
__device__ __forceinline__ float wr_region2(float x, float y) {
  const float ur = fmaf(y, y, __fmul_rn(-x, x));
  const float ui = -2.0f * x * y;
  const float ar = fmaf(INV_SQRT_PI, ur, 1.410474f);
  const float ai = INV_SQRT_PI * ui;
  const float nr = fmaf(y, ar, __fmul_rn(x, ai));
  const float ni = fmaf(y, ai, __fmul_rn(-x, ar));
  const float br = 3.0f + ur;
  const float dr = 0.75f + fmaf(ur, br, __fmul_rn(-ui, ui));
  const float di = fmaf(ur, ui, __fmul_rn(ui, br));
  return fmaf(nr, dr, __fmul_rn(ni, di)) / fmaf(dr, dr, __fmul_rn(di, di));
}

// Region III: w = N3(t) / D3(t), t = y - i x.
__device__ __forceinline__ float wr_region3(float x, float y) {
  const float N3[5] = {0.5642236f, 3.778987f, 11.96482f, 20.20933f,
                       16.4955f};
  const float D3[6] = {1.0f, 6.699398f, 21.69274f, 39.27121f, 38.82363f,
                       16.4955f};
  float nr, ni, dr, di;
  cpoly(N3, y, -x, nr, ni);
  cpoly(D3, y, -x, dr, di);
  return fmaf(nr, dr, __fmul_rn(ni, di)) / fmaf(dr, dr, __fmul_rn(di, di));
}

// Region IV: w = exp(u) - t P4(u) / Q4(u), u = t^2.
__device__ __forceinline__ float wr_region4(float x, float y) {
  const float P4[7] = {0.56419f, -1.320522f, 35.76683f, -219.0313f,
                       1540.787f, -3321.9905f, 36183.31f};
  const float Q4[8] = {-1.0f, 1.841439f, -61.57037f, 364.2191f,
                       -2186.181f, 9022.228f, -24322.84f, 32066.6f};
  const float ur = fmaf(y, y, __fmul_rn(-x, x));
  const float ui = -2.0f * x * y;
  float pr, pi, qr, qi;
  cpoly(P4, ur, ui, pr, pi);
  cpoly(Q4, ur, ui, qr, qi);
  const float qq = fmaf(qr, qr, __fmul_rn(qi, qi));
  const float fr = fmaf(pr, qr, __fmul_rn(pi, qi)) / qq;
  const float fi = fmaf(pi, qr, __fmul_rn(-pr, qi)) / qq;
  float sn, cs;
  sincosf(ui, &sn, &cs);
  // Re(t F) with t = (y, -x): y fr + x fi.
  return fmaf(expf(ur), cs, -fmaf(y, fr, __fmul_rn(x, fi)));
}

// Pointwise w4 (the near tiers): only the pair's own region is evaluated.
template <bool WITH_REGION4>
__device__ __forceinline__ float wr_w4(float x, float y) {
  const float ax = fabsf(x);
  const float s = ax + y;
  if (s >= 15.0f) return wr_region1(x, y);
  if (s >= 5.5f) return wr_region2(x, y);
  if (WITH_REGION4 && y < fmaf(0.195f, ax, -0.176f)) return wr_region4(x, y);
  return wr_region3(x, y);
}

// wr of one (point, line) pair at dnu = nu - nu_c, with the regions its
// tier allows and chi; returns false (and leaves wr unset) beyond the
// cutoff, where the pair contributes nothing.
template <int TIER, bool HAS_CHI>
__device__ __forceinline__ bool pair_wr(float dnu, float sx, float y,
                                        float chi_b, float cutoff,
                                        float& wr) {
  if (!(fabsf(dnu) <= cutoff)) return false;
  const float x = dnu * sx;
  if (TIER == FAR) {
    wr = wr_region1(x, y);
  } else if (TIER == MID) {
    wr = (fabsf(x) + y >= 15.0f) ? wr_region1(x, y) : wr_region2(x, y);
  } else {
    wr = wr_w4<TIER == NEAR4>(x, y);
  }
  if (HAS_CHI) wr *= expf(-chi_b * fmaxf(fabsf(dnu) - CHI_DELTA1, 0.0f));
  return true;
}

}  // namespace
