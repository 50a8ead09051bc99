// The work item of the single-state line sums, shared by K3
// (opacity_single.cu) and the fused halo accumulation (dma_halo.cu): one
// (128-point tile, range of line blocks) item and the fixed-order sum of
// the items' partial sums.  Both kernels run this arithmetic, so the fused
// halo sum is K3's by construction.
//
//   dst[o, p] = sum over lines i of blocks [b0, b1) of
//               amps[o, i] * Re w(x_ip, y_i)
//               * exp(-chi_i * max(|dnu| - 3, 0)) * [|dnu| <= cutoff]
//
// Each thread holds one point's n_out sums in registers, in line order; a
// block stages 128 lines at a time in shared memory and picks each 32-line
// sub-block's tier (csrc/voigt_primal.cuh).  With SKIP_BEYOND a sub-block
// whose centers all lie beyond the cutoff of the tile is skipped: exact, as
// every one of its pairs is masked.

#pragma once

#include <cuda_runtime.h>

#include "voigt_primal.cuh"

namespace {

constexpr int MAX_OUT = 8;       // amplitude rows per call
constexpr int SUM_THREADS = 256;
constexpr int SKIP = -1;         // a sub-block beyond the cutoff

// One state's line rows, Lp lines each (a multiple of BLOCK_L): centers,
// scales, y, chi (null: none) and the amplitudes [n_out, Lp].
struct LineRows {
  const float* nuc;
  const float* sx;
  const float* y;
  const float* chi;
  const float* amps;
};

struct Staged {
  float nuc[BLOCK_L];
  float sx[BLOCK_L];
  float y[BLOCK_L];
  float chi[BLOCK_L];
  float a[MAX_OUT][BLOCK_L];
};

// A load of the line rows: through the read-only cache, or with L2_ONLY
// through L2 alone (rows that another device or block has just written).
template <bool L2_ONLY>
__device__ __forceinline__ float load_row(const float* p) {
  return L2_ONLY ? __ldcg(p) : __ldg(p);
}

template <int TIER, bool HAS_CHI>
__device__ __forceinline__ void accumulate_sub(const Staged& s, int base,
                                               float nu_p, float cutoff,
                                               int n_out,
                                               float (&acc)[MAX_OUT]) {
#pragma unroll 2
  for (int i = base; i < base + SUB_L; ++i) {
    float wr;
    if (!pair_wr<TIER, HAS_CHI>(nu_p - s.nuc[i], s.sx[i], s.y[i],
                                HAS_CHI ? s.chi[i] : 0.0f, cutoff, wr))
      continue;
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o)
      if (o < n_out) acc[o] = fmaf(s.a[o][i], wr, acc[o]);
  }
}

// One (tile, line block range) item with TILE_P threads, one point each:
// the sum over the line blocks [b0, b1) of `r` at the points of `tile` of
// nu [Pp], written to dst[o * Pp + p].  Every thread of the block calls it.
template <bool HAS_CHI, bool SKIP_BEYOND, bool L2_ONLY>
__device__ __forceinline__ void line_sum_item(const LineRows& r,
                                              const float* nu, int tile,
                                              int b0, int b1, int n_out,
                                              int Lp, int Pp, float cutoff,
                                              float* dst) {
  __shared__ Staged s;
  __shared__ int s_tier[N_SUB];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int p = tile * TILE_P + tid;
  const float nu_p = nu[p];
  float tile_lo, tile_hi;
  tile_bounds(nu_p, tile_lo, tile_hi);
  float acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const int l = b * BLOCK_L + tid;
    const float c = load_row<L2_ONLY>(r.nuc + l);
    const float sxv = load_row<L2_ONLY>(r.sx + l);
    const float yy = load_row<L2_ONLY>(r.y + l);
    __syncthreads();           // everyone is done with the previous block
    s.nuc[tid] = c;
    s.sx[tid] = sxv;
    s.y[tid] = yy;
    if (HAS_CHI) s.chi[tid] = load_row<L2_ONLY>(r.chi + l);
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o)
      if (o < n_out)
        s.a[o][tid] = load_row<L2_ONLY>(r.amps + (size_t)o * Lp + l);
    // Warp w holds the lines of sub-block w in registers: its tier.
    int tier = sub_block_tier(c, sxv, yy, tile_lo, tile_hi);
    if (SKIP_BEYOND) {
      const float gap = fmaxf(fmaxf(warp_min(c) - tile_hi,
                                    tile_lo - warp_max(c)), 0.0f);
      if (gap > cutoff) tier = SKIP;
    }
    if ((tid & 31) == 0) s_tier[warp] = tier;
    __syncthreads();
#pragma unroll 1
    for (int sb = 0; sb < N_SUB; ++sb) {
      const int base = sb * SUB_L;
      switch (s_tier[sb]) {
        case SKIP:
          break;
        case FAR:
          accumulate_sub<FAR, HAS_CHI>(s, base, nu_p, cutoff, n_out, acc);
          break;
        case MID:
          accumulate_sub<MID, HAS_CHI>(s, base, nu_p, cutoff, n_out, acc);
          break;
        case NEAR3:
          accumulate_sub<NEAR3, HAS_CHI>(s, base, nu_p, cutoff, n_out, acc);
          break;
        default:
          accumulate_sub<NEAR4, HAS_CHI>(s, base, nu_p, cutoff, n_out, acc);
          break;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o)
    if (o < n_out) dst[(size_t)o * Pp + p] = acc[o];
}

// out[k, i] = sum_j part[k, j, i] over the m partial sums of each of n_loc
// shards, in order j = 0, 1, ..; n values per shard.
__global__ void __launch_bounds__(SUM_THREADS)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int m, int n, int n_loc) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (long long)n * n_loc) return;
  const long long k = i / n, j = i % n;
  const float* src = part + (size_t)k * m * n + j;
  float acc = src[0];
  for (int s = 1; s < m; ++s) acc += src[(size_t)s * n];
  out[i] = acc;
}

inline void launch_sum_parts(const float* part, float* out, int m, int n,
                             int n_loc, cudaStream_t stream) {
  const long long total = (long long)n * n_loc;
  sum_parts_kernel<<<(unsigned)((total + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, stream>>>(part, out, m, n, n_loc);
}

}  // namespace
