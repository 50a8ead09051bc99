// The thread block of the basis contraction, shared by K2 (basis_batch.cu,
// one block per (tile, state)) and K4 (basis_single.cu, one block per
// (tile, line segment) of one state): the same operations in the same
// order, so K4 with one segment equals K2 at B = 1 bit for bit.
//
// One point per thread.  Per 128-line block: the lines are staged in shared
// memory and each 32-line sub-block's tier picked from the true bounds of
// its shifted centres (the decision of voigt_basis.cuh); per sub-block the
// four coefficient rows of every row r are staged as [4][R][32] and
// contracted against the basis of GROUP lines held in registers, into the
// [R][128] output tile in shared memory, each thread its own column (no
// atomics, one fixed order: line block, sub-block, line group, line, row).

#pragma once

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

// The block's shared staging: lines, tile bounds per warp, tiers.
struct Shared {
  Staged s;
  float lo[N_WARP], hi[N_WARP];
  int tier[N_SUB];
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

// The true wavenumber bounds of the block's tile (every thread calls it).
__device__ __forceinline__ void tile_bounds(Shared& sh, float nu_p,
                                            float& tile_lo, float& tile_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    const float lo = warp_min(nu_p), hi = warp_max(nu_p);
    if (lane == 0) {
      sh.lo[warp] = lo;
      sh.hi[warp] = hi;
    }
  }
  __syncthreads();
  tile_lo = sh.lo[0];
  tile_hi = sh.hi[0];
#pragma unroll
  for (int w = 1; w < N_WARP; ++w) {
    tile_lo = fminf(tile_lo, sh.lo[w]);
    tile_hi = fmaxf(tile_hi, sh.hi[w]);
  }
}

// One 128-line block (lines [l0, l0 + BLOCK_L) of one state: nuc, sx, yv,
// chi point at the state's [Lp] rows, cs[k] at its [R, Lp] rows of Ck)
// added into out_s for this thread's point.  c_s: R * 4 * SUB_L floats.
template <bool HAS_CHI>
__device__ __forceinline__ void contract_block(
    Shared& sh, const float* __restrict__ nuc, const float* __restrict__ sx,
    const float* __restrict__ yv, const float* __restrict__ chi,
    const float* const (&cs)[4], float* __restrict__ c_s,
    float* __restrict__ out_s, int R, int Lp, int l0, float nu_p,
    float tile_lo, float tile_hi, float cutoff) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = l0 + tid;
  const float c = nuc[l];
  const float sxv = sx[l];
  const float yy = yv[l];
  __syncthreads();             // everyone is done with the previous block
  sh.s.nuc[tid] = c;
  sh.s.sx[tid] = sxv;
  sh.s.y[tid] = yy;
  if (HAS_CHI) sh.s.chi[tid] = chi[l];
  // Warp w holds the lines of sub-block w: reduce its bounds and pick its
  // tier (the decision of csrc/opacity_batch.cu).
  const float c_min = warp_min(c), c_max = warp_max(c);
  const float sx_min = warp_min(sxv), y_min = warp_min(yy);
  if (lane == 0)
    sh.tier[warp] = sub_block_tier(c_min, c_max, sx_min, y_min, tile_lo,
                                   tile_hi);
#pragma unroll 1
  for (int sb = 0; sb < N_SUB; ++sb) {
    __syncthreads();           // c_s free, the lines and tiers written
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
    switch (sh.tier[sb]) {
      case FAR:
        contract_sub<FAR, HAS_CHI>(sh.s, base, c_s, out_s, R, nu_p, cutoff,
                                   tid);
        break;
      case MID:
        contract_sub<MID, HAS_CHI>(sh.s, base, c_s, out_s, R, nu_p, cutoff,
                                   tid);
        break;
      case NEAR3:
        contract_sub<NEAR3, HAS_CHI>(sh.s, base, c_s, out_s, R, nu_p, cutoff,
                                     tid);
        break;
      default:
        contract_sub<NEAR4, HAS_CHI>(sh.s, base, c_s, out_s, R, nu_p, cutoff,
                                     tid);
        break;
    }
  }
}

}  // namespace
