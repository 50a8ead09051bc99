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
//    bound on s = |x| + y, uniformly for the whole thread block, so the
//    switch never diverges:
//      s_min = gap * min(sx) + min(y),
//      gap   = max(min nu_c - tile_hi, tile_lo - max nu_c, 0)
//    far (s_min >= 15): region-1 rational only; mid (s_min >= 5.5): region
//    1 or 2 per pair; near3 (min y >= 0.9, so region IV is empty): regions
//    I-III per pair; near4: all four regions per pair.  Min and max are
//    taken over the sub-block, so pressure shifts that reorder centers do
//    not matter.  In the near tiers a pair evaluates only its own region.
//  * Pairs outside the cutoff skip the line shape altogether.
//  * One thread per grid point keeps both sums in registers, in line
//    order: no atomics, no shared accumulators, deterministic results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_opacity.py.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_P = 128;    // grid points per block = threads per block
constexpr int BLOCK_L = 128;   // lines staged per window block
constexpr int SUB_L = 32;      // lines per tier decision = one warp
constexpr int N_SUB = BLOCK_L / SUB_L;
constexpr int N_WARP = TILE_P / 32;
static_assert(TILE_P == BLOCK_L, "each thread stages one line");
static_assert(SUB_L == 32 && N_SUB == N_WARP,
              "warp w reduces the bounds of sub-block w");

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

// Horner evaluation at complex z of a polynomial with real coefficients
// (highest degree first).
template <int N>
__device__ __forceinline__ void cpoly(const float (&c)[N], float zr, float zi,
                                      float& pr, float& pi) {
  pr = c[0];
  pi = 0.0f;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float r = pr * zr - pi * zi + c[k];
    pi = pr * zi + pi * zr;
    pr = r;
  }
}

// Region I (s >= 15): Re w = c y (0.5 + x^2 + y^2) / |0.5 + t^2|^2.
__device__ __forceinline__ float wr_region1(float x, float y) {
  const float y2 = y * y;
  const float a = 0.5f + y2 - x * x;
  const float b = 2.0f * x * y;
  return INV_SQRT_PI * y * (0.5f + y2 + x * x) / (a * a + b * b);
}

// Region II (s >= 5.5): w = t (1.410474 + c u) / (0.75 + u (3 + u)), u = t^2.
__device__ __forceinline__ float wr_region2(float x, float y) {
  const float ur = y * y - x * x;
  const float ui = -2.0f * x * y;
  const float ar = 1.410474f + INV_SQRT_PI * ur;
  const float ai = INV_SQRT_PI * ui;
  const float nr = y * ar + x * ai;
  const float ni = y * ai - x * ar;
  const float br = 3.0f + ur;
  const float dr = 0.75f + (ur * br - ui * ui);
  const float di = ur * ui + ui * br;
  return (nr * dr + ni * di) / (dr * dr + di * di);
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
  return (nr * dr + ni * di) / (dr * dr + di * di);
}

// Region IV: w = exp(u) - t P4(u) / Q4(u), u = t^2.
__device__ __forceinline__ float wr_region4(float x, float y) {
  const float P4[7] = {0.56419f, -1.320522f, 35.76683f, -219.0313f,
                       1540.787f, -3321.9905f, 36183.31f};
  const float Q4[8] = {-1.0f, 1.841439f, -61.57037f, 364.2191f,
                       -2186.181f, 9022.228f, -24322.84f, 32066.6f};
  const float ur = y * y - x * x;
  const float ui = -2.0f * x * y;
  float pr, pi, qr, qi;
  cpoly(P4, ur, ui, pr, pi);
  cpoly(Q4, ur, ui, qr, qi);
  const float qq = qr * qr + qi * qi;
  const float fr = (pr * qr + pi * qi) / qq;
  const float fi = (pi * qr - pr * qi) / qq;
  float sn, cs;
  sincosf(ui, &sn, &cs);
  // Re(t F) with t = (y, -x): y fr + x fi.
  return expf(ur) * cs - (y * fr + x * fi);
}

// Pointwise w4 (the near tiers): only the pair's own region is evaluated.
template <bool WITH_REGION4>
__device__ __forceinline__ float wr_w4(float x, float y) {
  const float ax = fabsf(x);
  const float s = ax + y;
  if (s >= 15.0f) return wr_region1(x, y);
  if (s >= 5.5f) return wr_region2(x, y);
  if (WITH_REGION4 && y < 0.195f * ax - 0.176f) return wr_region4(x, y);
  return wr_region3(x, y);
}

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
    const float dnu = nu_p - s.nuc[i];
    if (!(fabsf(dnu) <= cutoff)) continue;
    const float x = dnu * s.sx[i];
    const float y = s.y[i];
    float wr;
    if (TIER == FAR) {
      wr = wr_region1(x, y);
    } else if (TIER == MID) {
      wr = (fabsf(x) + y >= 15.0f) ? wr_region1(x, y) : wr_region2(x, y);
    } else {
      wr = wr_w4<TIER == NEAR4>(x, y);
    }
    if (HAS_CHI) wr *= expf(-s.chi[i] * fmaxf(fabsf(dnu) - CHI_DELTA1, 0.0f));
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
  const int lane = tid & 31;
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
  __shared__ float s_lo[N_WARP], s_hi[N_WARP];
  __shared__ int s_tier[N_SUB];

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
    // Warp w holds the lines of sub-block w in registers: reduce its bounds
    // and pick its tier.
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
