// The line-sum loop of the opacity kernels: one (128-point tile, range of
// line blocks) item, shared by the batched line sum K1 (opacity_batch.cu,
// the port of spectrobot_tpu/ops/pallas_opacity.py:_batch_kernel), the
// single-state line sum K3 (opacity_single.cu, the port of :_kernel) and
// the fused halo accumulation (dma_halo.cu, the port of
// benchmarks/dma_halo.py:_fused_kernel).  All three run this loop and the
// per-pair code of voigt_primal.cuh, so they agree pair for pair.
//
//   acc[o][j] = sum over lines i of blocks [b0, b1) of
//               amps[o, i] * Re w(x_ip, y_i)
//               * exp(-chi_i * max(|dnu| - 3, 0)) * [|dnu| <= cutoff]
//   at the PTS points p = tile * TILE_P + j * (TILE_P / PTS) + threadIdx.x
//
// What bounds it: FP32 arithmetic on the CUDA cores (per pair ~14 flops
// far, ~55 mid, ~165 near3, ~300 near4, plus 2 per amplitude row), and the
// instructions the loop issues per pair around it (loads, the cutoff test,
// loop control).  The bytes are a few floats per line and per point.
//
// What the design does about it:
//  * Inside a staged block, each 32-line sub-block is cut to the run of
//    lines, from the first to the last, whose centers can reach the tile
//    (a warp ballot; lines need not be sorted), and a sub-block with no
//    such line is skipped.  Every pair left out lies beyond the cutoff for
//    every point of the tile, so the sums are those of the full loop, bit
//    for bit.
//  * The tier is chosen once per sub-block from a conservative bound on
//    s = |x| + y (voigt_primal.cuh), so the switch never diverges; min and
//    max are taken over the whole sub-block, padding included, so the
//    decision is the host's tier_counts'.
//  * Each staged line is one float4 {nu_c, sx, y, chi} and its NOUT
//    amplitudes as one vector (float, float2, float4 or two float4): two or
//    three shared-memory broadcasts per line, and each thread evaluates
//    PTS points of its tile against it (a template argument: K1 takes two,
//    K3 and the fused kernel one, whose grids of few tiles need the
//    threads more than the reuse of each staged line).
//  * Each point's NOUT sums stay in registers as fmaf chains in line
//    order: no atomics, no shared accumulators, deterministic results.
//  * The rows are read unpadded: lines at or past L take the padding (center
//    `far`, sx and y 1e6, amplitudes and chi 0) in registers.
//
// K1 and K3 walk a range of line blocks the host's window table gives
// (line_sum_item).  The fused halo kernel cannot have such a table (a
// neighbour's centers are known only once they have arrived), so it takes
// the tile's bounds first (tile_span), finds the blocks within reach from
// a center range per block, and walks them with a mask of the blocks to
// stage (line_sum_walk with a Walk other than EveryBlock).

#pragma once

#include <cfloat>
#include <climits>

#include <cuda_runtime.h>

#include "voigt_primal.cuh"

namespace {

constexpr int MAX_OUT = 8;                // amplitude rows of one call
constexpr float PAD_WIDTH = 1e6f;         // sx and y of a padding line
constexpr int SKIP_RUN = -1;              // a sub-block beyond the cutoff

// A block that evaluates PTS points a thread of a TILE_P-point tile.
template <int PTS>
struct Tile {
  static constexpr int THREADS = TILE_P / PTS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int LINES = BLOCK_L / THREADS;  // lines a thread stages
  static_assert(TILE_P % PTS == 0 && THREADS % 32 == 0, "whole warps");
  static_assert(BLOCK_L % THREADS == 0 && THREADS % SUB_L == 0,
                "each staging pass covers whole sub-blocks");
};

// The NOUT amplitudes of one staged line, aligned for vector loads.
template <int NOUT>
struct alignas(NOUT >= 4 ? 16 : 4 * NOUT) Amps {
  float v[NOUT];
};

// The rows of one state's lines: centers, scales, y and chi (null: none)
// [L], and n_out amplitude rows `stride` floats apart; lines at or past L
// are padding with center `far`.
struct LineRows {
  const float* nuc;
  const float* sx;
  const float* y;
  const float* chi;
  const float* amps;
  long long stride;
  int n_out;
  int L;
  float far;
};

// A load of the line rows: through the read-only cache, or with L2_ONLY
// through L2 alone (rows that another device or block has just written).
template <bool L2_ONLY>
__device__ __forceinline__ float load_row(const float* p) {
  return L2_ONLY ? __ldcg(p) : __ldg(p);
}

// The run of sub-block sb: its tier and its first and last line that can
// reach the tile, packed as tier | first << 8 | last << 16.
__device__ __forceinline__ int pack_run(int tier, int first, int last) {
  return tier | (first << 8) | (last << 16);
}

template <int TIER, bool HAS_CHI, int NOUT, int PTS>
__device__ __forceinline__ void accumulate_run(
    const float4* __restrict__ q, const Amps<NOUT>* __restrict__ am, int i0,
    int i1, const float (&nu_p)[PTS], float cutoff,
    float (&acc)[NOUT][PTS]) {
#pragma unroll 2
  for (int i = i0; i <= i1; ++i) {
    const float4 a = q[i];     // nu_c, sx, y, chi
    const Amps<NOUT> w = am[i];
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      float wr;
      if (!pair_wr<TIER, HAS_CHI>(nu_p[j] - a.x, a.y, a.z,
                                  HAS_CHI ? a.w : 0.0f, cutoff, wr))
        continue;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) acc[o][j] = fmaf(w.v[o], wr, acc[o][j]);
    }
  }
}

// The points of this thread in `tile`: p = tile * TILE_P + j * (TILE_P /
// PTS) + threadIdx.x, j < PTS.
template <int PTS>
__device__ __forceinline__ int point_of(int tile, int j) {
  return tile * TILE_P + j * Tile<PTS>::THREADS + threadIdx.x;
}

// A tile's wavenumber bounds and how far a center may lie from them and
// still reach one of its points.
struct TileSpan {
  float lo, hi, reach;
};

// Whether no line with a center in [c_lo, c_hi] can reach the tile: then
// every pair of such a line lies beyond the cutoff.  Exact for a range as
// for one line (c_lo == c_hi): rounding is monotone, so each line's gap is
// at least the range's.
__device__ __forceinline__ bool beyond_reach(float c_lo, float c_hi,
                                             const TileSpan& t) {
  const float gap = fmaxf(fmaxf(c_lo - t.hi, t.lo - c_hi), 0.0f);
  return gap > t.reach;
}

// This thread's PTS points of `tile` into nu_p, and the tile's span, over
// the points up to index `last` of the grid nu (a point past it reads the
// last one: the grid padded with its last point, as the host's tier_counts
// takes it).  Every thread of the block calls it.
template <int PTS>
__device__ __forceinline__ TileSpan tile_span(const float* __restrict__ nu,
                                              int tile, int last,
                                              float cutoff,
                                              float (&nu_p)[PTS]) {
  constexpr int WARPS = Tile<PTS>::WARPS;
  __shared__ float s_lo[WARPS], s_hi[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    nu_p[j] = nu[min(point_of<PTS>(tile, j), last)];
    lo = fminf(lo, nu_p[j]);
    hi = fmaxf(hi, nu_p[j]);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  float tile_lo = s_lo[0], tile_hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    tile_lo = fminf(tile_lo, s_lo[w]);
    tile_hi = fmaxf(tile_hi, s_hi[w]);
  }
  // How far a center may lie from the tile and still reach it.  Rounding
  // is monotone: for a center c >= c_min and a point nu <= tile_hi,
  // fl(c - nu) >= fl(c_min - tile_hi), so a gap beyond the cutoff puts
  // every |dnu| of the line's pairs beyond it too, and the test needs no
  // slack to be exact.  The slack of 4 ulps of cutoff + |nu| keeps it
  // exact should either difference be rounded otherwise (an FMA, another
  // order), which moves it by at most an ulp of its larger operand.
  const float reach =
      cutoff + 4.0f * FLT_EPSILON *
                   (cutoff + fmaxf(fabsf(tile_lo), fabsf(tile_hi)));
  return TileSpan{tile_lo, tile_hi, reach};
}

// The walk of K1 and K3: every block of the range.
struct EveryBlock {
  static constexpr bool ALL = true;
  __device__ __forceinline__ unsigned mask(int, const TileSpan&) const {
    return 0xffffffffu;
  }
};

// The sums over the line blocks [b0, b1) of `r` at this thread's points
// nu_p of a tile with span `t`, into acc: the blocks that `walk` marks
// (walk.mask(b, t): bit i for block b + i, the same in every thread), all
// of them with EveryBlock.  Every thread of the block calls it; a caller
// that runs several items in a row syncs the block between them.
template <int PTS, int NOUT, bool HAS_CHI, bool L2_ONLY, class Walk>
__device__ __forceinline__ void line_sum_walk(const LineRows& r,
                                              const float (&nu_p)[PTS],
                                              const TileSpan& t, int b0,
                                              int b1, float cutoff,
                                              const Walk& walk,
                                              float (&acc)[NOUT][PTS]) {
  constexpr int THREADS = Tile<PTS>::THREADS;
  __shared__ float4 s_q[BLOCK_L];
  __shared__ Amps<NOUT> s_a[BLOCK_L];
  __shared__ int s_run[N_SUB];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float tile_lo = t.lo, tile_hi = t.hi;

#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int j = 0; j < PTS; ++j) acc[o][j] = 0.0f;
  [[maybe_unused]] unsigned marked = 0xffffffffu;
  for (int b = b0; b < b1; ++b) {
    if constexpr (!Walk::ALL) {
      const int bit = (b - b0) & 31;
      if (bit == 0) marked = walk.mask(b, t);
      if (!((marked >> bit) & 1u)) continue;   // uniform: no barrier
    }
    __syncthreads();           // everyone is done with the previous block
#pragma unroll
    for (int h = 0; h < Tile<PTS>::LINES; ++h) {
      const int i = h * THREADS + tid;              // line in the block
      const int l = b * BLOCK_L + i;
      const bool real = l < r.L;
      const float c = real ? load_row<L2_ONLY>(r.nuc + l) : r.far;
      const float sxv = real ? load_row<L2_ONLY>(r.sx + l) : PAD_WIDTH;
      const float yy = real ? load_row<L2_ONLY>(r.y + l) : PAD_WIDTH;
      s_q[i] = make_float4(
          c, sxv, yy, HAS_CHI && real ? load_row<L2_ONLY>(r.chi + l) : 0.0f);
      Amps<NOUT> a;
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        a.v[o] = real && o < r.n_out
                     ? load_row<L2_ONLY>(r.amps + o * r.stride + l)
                     : 0.0f;
      s_a[i] = a;
      // Lanes of a warp hold the 32 lines of sub-block i / SUB_L: its tier
      // and its run of lines that can reach the tile.
      const int tier = sub_block_tier(c, sxv, yy, tile_lo, tile_hi);
      const unsigned in =
          __ballot_sync(0xffffffffu, real && !beyond_reach(c, c, t));
      if (lane == 0)
        s_run[i / SUB_L] = in == 0u ? SKIP_RUN
                                    : pack_run(tier, __ffs(in) - 1,
                                               31 - __clz(in));
    }
    __syncthreads();
#pragma unroll 1
    for (int sb = 0; sb < N_SUB; ++sb) {
      const int run = s_run[sb];
      if (run == SKIP_RUN) continue;
      const int i0 = sb * SUB_L + ((run >> 8) & 0xff);
      const int i1 = sb * SUB_L + (run >> 16);
      switch (run & 0xff) {
        case FAR:
          accumulate_run<FAR, HAS_CHI, NOUT, PTS>(s_q, s_a, i0, i1, nu_p,
                                                  cutoff, acc);
          break;
        case MID:
          accumulate_run<MID, HAS_CHI, NOUT, PTS>(s_q, s_a, i0, i1, nu_p,
                                                  cutoff, acc);
          break;
        case NEAR3:
          accumulate_run<NEAR3, HAS_CHI, NOUT, PTS>(s_q, s_a, i0, i1, nu_p,
                                                    cutoff, acc);
          break;
        default:
          accumulate_run<NEAR4, HAS_CHI, NOUT, PTS>(s_q, s_a, i0, i1, nu_p,
                                                    cutoff, acc);
          break;
      }
    }
  }
}

// One item of K1 or K3: the sums over the line blocks [b0, b1) of `r` at
// this thread's PTS points of `tile` of the grid nu (padded to whole
// tiles), into acc.
template <int PTS, int NOUT, bool HAS_CHI, bool L2_ONLY>
__device__ __forceinline__ void line_sum_item(const LineRows& r,
                                              const float* __restrict__ nu,
                                              int tile, int b0, int b1,
                                              float cutoff,
                                              float (&acc)[NOUT][PTS]) {
  float nu_p[PTS];
  const TileSpan t = tile_span<PTS>(nu, tile, INT_MAX, cutoff, nu_p);
  line_sum_walk<PTS, NOUT, HAS_CHI, L2_ONLY>(r, nu_p, t, b0, b1, cutoff,
                                             EveryBlock{}, acc);
}

// The amplitude rows a kernel instantiates for n_out rows (1, 2, 4 or 8:
// rows past n_out are staged as zeros and not written).
inline int rows_of(int n_out) {
  return n_out <= 1 ? 1 : n_out <= 2 ? 2 : n_out <= 4 ? 4 : 8;
}

}  // namespace
