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
// In practice the loop is bound by the instructions it issues per pair
// (loads, the cutoff test, loop control) as much as by the flops.
//
// What the design does about it:
//  * Dead states are skipped: a state whose amplitudes are all zero writes
//    zeros and returns (bit-exact; about 45 % of a limb scan's states lie
//    below their ray's tangent point).  Each block finds it out itself
//    with block-wide ballots over the state's amplitudes.
//  * Line blocks outside the wing cutoff are never visited: the host window
//    table gives each tile its [start, start + count) range of BLOCK_L-line
//    blocks.  The loop over them replaces the TPU's sequential grid axis.
//  * Inside a visited block, each 32-line sub-block is cut to the run of
//    lines, from the first to the last, whose centers can reach the tile
//    (a warp ballot; lines need not be sorted), and a sub-block with no such
//    line is skipped.  Every pair left out lies beyond the cutoff for every
//    point of the tile, so the sums are those of the full loop, bit for bit.
//  * The tier is chosen once per SUB_L-line sub-block from a conservative
//    bound on s = |x| + y (csrc/voigt_primal.cuh, shared with K3), so the
//    switch never diverges; in the near tiers a pair evaluates only its own
//    region.  Min and max are taken over the whole sub-block, padding
//    included, so the decision is the host's tier_counts'.
//  * Each staged line is one float4 {nu_c, sx, y, a0} and one float2
//    {a1, chi}: two shared-memory broadcasts per line, and each thread
//    evaluates PTS points of its tile against it.
//  * Each point's two sums stay in registers as fmaf chains in line order:
//    no atomics, no shared accumulators, deterministic results.
//  * The kernel reads the unpadded [B, L] rows: lines at or past L take the
//    padding the host used to write (center `far`, sx and y 1e6, amplitudes
//    and chi 0) in registers, and only points below P are written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: region IV needs accurate
//        expf and sincosf).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_opacity.py.

#include <cfloat>

#include <cuda_runtime.h>

#include "voigt_primal.cuh"

namespace {

constexpr int PTS = 2;                    // grid points per thread
constexpr int THREADS = TILE_P / PTS;     // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int LINES = BLOCK_L / THREADS;  // lines each thread stages
constexpr float PAD_WIDTH = 1e6f;         // sx and y of a padding line
constexpr int SKIP_RUN = -1;              // a sub-block beyond the cutoff
static_assert(TILE_P % PTS == 0 && THREADS % 32 == 0, "whole warps");
static_assert(BLOCK_L % THREADS == 0 && THREADS % SUB_L == 0,
              "each staging pass covers whole sub-blocks");

// The run of sub-block sb: its tier and its first and last line that can
// reach the tile, packed as tier | first << 8 | last << 16.
__device__ __forceinline__ int pack_run(int tier, int first, int last) {
  return tier | (first << 8) | (last << 16);
}

template <int TIER, bool HAS_CHI>
__device__ __forceinline__ void accumulate_run(const float4* __restrict__ q,
                                               const float2* __restrict__ r,
                                               int i0, int i1,
                                               const float (&nu_p)[PTS],
                                               float cutoff,
                                               float (&acc0)[PTS],
                                               float (&acc1)[PTS]) {
#pragma unroll 2
  for (int i = i0; i <= i1; ++i) {
    const float4 a = q[i];     // nu_c, sx, y, a0
    const float2 c = r[i];     // a1, chi
#pragma unroll
    for (int j = 0; j < PTS; ++j) {
      float wr;
      if (!pair_wr<TIER, HAS_CHI>(nu_p[j] - a.x, a.y, a.z,
                                  HAS_CHI ? c.y : 0.0f, cutoff, wr))
        continue;
      acc0[j] = fmaf(a.w, wr, acc0[j]);
      acc1[j] = fmaf(c.x, wr, acc1[j]);
    }
  }
}

// Whether state b has a nonzero amplitude (NaN counts, as != 0 does): a
// block-wide ballot over its 2 L entries, 4 per thread per round, ending
// at the first round that finds one.
__device__ __forceinline__ bool state_is_live(const float* __restrict__ a,
                                              int n) {
  for (int i0 = 0; i0 < n; i0 += 4 * THREADS) {
    bool nz = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * THREADS + threadIdx.x;
      if (i < n) nz |= a[i] != 0.0f;
    }
    if (__syncthreads_or(nz)) return true;
  }
  return false;
}

// grid = (Pp / TILE_P, B), block = THREADS threads; thread t holds points
// tile * TILE_P + t + j * THREADS, j < PTS.
// nu [Pp] (the padded grid); nuc, sx, y, chi [B, L]; amps [B, 2, L];
// starts, counts [n_tiles] (window of line blocks per tile); out [B, 2, P].
template <bool HAS_CHI>
__global__ void __launch_bounds__(THREADS)
opacity_batch_kernel(const float* __restrict__ nu,
                     const float* __restrict__ nuc,
                     const float* __restrict__ sx,
                     const float* __restrict__ yv,
                     const float* __restrict__ chi,
                     const float* __restrict__ amps,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     float* __restrict__ out, int P, int L, float far,
                     float cutoff) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* a0 = amps + (size_t)b * 2 * L;
  const float* a1 = a0 + L;
  float* out0 = out + (size_t)b * 2 * P;
  float* out1 = out0 + P;
  int pt[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) pt[j] = tile * TILE_P + j * THREADS + tid;

  if (!state_is_live(a0, 2 * L)) {   // uniform over the block
#pragma unroll
    for (int j = 0; j < PTS; ++j)
      if (pt[j] < P) out0[pt[j]] = out1[pt[j]] = 0.0f;
    return;
  }

  __shared__ float4 s_q[BLOCK_L];
  __shared__ float2 s_r[BLOCK_L];
  __shared__ int s_run[N_SUB];
  __shared__ float s_lo[WARPS], s_hi[WARPS];

  // The tile's true wavenumber bounds over the padded grid (as the host's
  // tier_counts takes them).
  float nu_p[PTS];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    nu_p[j] = nu[pt[j]];
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

  const size_t row = (size_t)b * L;
  const int start = starts[tile];
  const int count = counts[tile];
  float acc0[PTS], acc1[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) acc0[j] = acc1[j] = 0.0f;
  for (int k = 0; k < count; ++k) {
    __syncthreads();           // everyone is done with the previous block
#pragma unroll
    for (int h = 0; h < LINES; ++h) {
      const int i = h * THREADS + tid;              // line in the block
      const int l = (start + k) * BLOCK_L + i;
      const bool real = l < L;
      const float c = real ? nuc[row + l] : far;
      const float sxv = real ? sx[row + l] : PAD_WIDTH;
      const float yy = real ? yv[row + l] : PAD_WIDTH;
      s_q[i] = make_float4(c, sxv, yy, real ? a0[l] : 0.0f);
      s_r[i] = make_float2(real ? a1[l] : 0.0f,
                           HAS_CHI && real ? chi[row + l] : 0.0f);
      // Lanes of a warp hold the 32 lines of sub-block i / SUB_L: its tier
      // and its run of lines that can reach the tile.
      const int tier = sub_block_tier(c, sxv, yy, tile_lo, tile_hi);
      const float gap = fmaxf(fmaxf(c - tile_hi, tile_lo - c), 0.0f);
      const unsigned in = __ballot_sync(0xffffffffu, real && !(gap > reach));
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
          accumulate_run<FAR, HAS_CHI>(s_q, s_r, i0, i1, nu_p, cutoff, acc0,
                                       acc1);
          break;
        case MID:
          accumulate_run<MID, HAS_CHI>(s_q, s_r, i0, i1, nu_p, cutoff, acc0,
                                       acc1);
          break;
        case NEAR3:
          accumulate_run<NEAR3, HAS_CHI>(s_q, s_r, i0, i1, nu_p, cutoff,
                                         acc0, acc1);
          break;
        default:
          accumulate_run<NEAR4, HAS_CHI>(s_q, s_r, i0, i1, nu_p, cutoff,
                                         acc0, acc1);
          break;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    if (pt[j] < P) {
      out0[pt[j]] = acc0[j];
      out1[pt[j]] = acc1[j];
    }
  }
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
// nu is the padded grid [Pp]; the line rows are [B, L] and the output
// [B, 2, P].  `far` is the center the window table gave padding lines.
// `chi` may be null (no wing correction); cutoff = +inf disables the mask.
int opacity_batch_launch(const float* nu, const float* nuc, const float* sx,
                         const float* y, const float* chi, const float* amps,
                         const int* starts, const int* counts, float* out,
                         int B, int P, int Pp, int L, float far,
                         float cutoff, void* stream) {
  if (B <= 0 || B > 65535 || P < 0 || P > Pp || Pp <= 0 ||
      Pp % TILE_P != 0 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Pp / TILE_P, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chi != nullptr)
    opacity_batch_kernel<true><<<grid, THREADS, 0, s>>>(
        nu, nuc, sx, y, chi, amps, starts, counts, out, P, L, far, cutoff);
  else
    opacity_batch_kernel<false><<<grid, THREADS, 0, s>>>(
        nu, nuc, sx, y, nullptr, amps, starts, counts, out, P, L, far,
        cutoff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
