// The thread block of the basis contraction, shared by K2 (basis_batch.cu,
// one block per (tile, state)) and K4 (basis_single.cu, one block per
// (tile, line segment) of one state): the same operations in the same
// order, so K4 with one segment equals K2 at B = 1 bit for bit.  Both
// replace the matrix-unit contraction of the reference's basis kernels
// (spectrobot_tpu/ops/pallas_opacity.py:_basis_batch_kernel and
// _basis_kernel, jax.lax.dot_general at HIGHEST precision).
//
// The contraction runs on the tensor cores as 3xTF32 (mma.sync m16n8k8
// .tf32): for each 8-line group of a 128-point tile it is one product
//
//   D[points, rows] += A[points, 4 x 8 lines] . B[4 x 8 lines, rows]
//
// A = the basis (K, Kx, xKx, Ky) of the (point, line) pairs, B = the
// coefficient rows C_k[r, l].  Each operand is split into hi = tf32(a) and
// lo = tf32(a - hi), rounded to nearest even, and the product taken as
// lo.hi + hi.lo + hi.hi (lo.lo dropped): the counterpart of the
// reference's 3-pass precision.  No switch selects another precision.
//
// Block: 8 warps, warp w owns the 16 points [16 w, 16 w + 16) of the tile
// (one m16 tile).  The lines go by stages of SG groups of 8 (SG = 4, one
// 32-line sub-block, for R <= 16; else 1), one barrier per stage:
//  * the coefficient rows of stage u + DEPTH - 1 are copied by cp.async
//    into a ring of DEPTH buffers (4, or 2 for R > 72), so the copies of
//    three stages are in flight while one is contracted;
//  * stage u + 1's rows are split once, for the whole block, into hi/lo B
//    fragments in shared memory in fragment order (one 16-byte read per
//    lane per (basis value, 8 rows)), double-buffered;
//  * each lane evaluates the basis of the 4 pairs of a group whose
//    A-fragment elements it holds (points g, g + 8 x lines t, t + 4 with
//    g = lane / 4, t = lane % 4), once, and splits them in registers: A
//    never touches shared memory, and each pair is evaluated once for all
//    R rows;
//  * per 8 rows, the 12 products of a group (4 basis values x 3 passes)
//    chain into a fresh fragment that is then added to the running sums
//    in registers with one fp32 add: the tensor cores' truncating
//    accumulation spans 8 lines, and the sums across groups round to
//    nearest.  Every output is written once, no atomics, one fixed order:
//    line block, group, basis value, pass.
// The sums live in registers: NT n-tiles of 8 rows per lane, NT in
// {2, 9, 28} chosen by R (up to 16, 72 and MAX_ROWS rows), with
// __launch_bounds__ aiming at 3, 2 and 1 blocks per SM.
//
// Kept from the FP32 design: the window tables (TILE_P = BLOCK_L = 128,
// shared with K1 and K5), the tier per (tile, 32-line sub-block) from the
// true bounds of its shifted centres, and the per-pair basis of
// voigt_basis.cuh.  Exact zeros are skipped: a stage none of whose lines
// lies within the cutoff of the tile is neither split nor contracted, and
// a group whose 16 x 8 pairs of a warp all lie beyond the cutoff skips its
// products.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "voigt_basis.cuh"

namespace {

constexpr int N_WARP = 8;
constexpr int THREADS = 32 * N_WARP;
constexpr int WARP_P = TILE_P / N_WARP;       // points per warp: one m16 tile
constexpr int GROUP_L = 8;                    // lines per mma k-step
constexpr int N_SUB = BLOCK_L / SUB_L;
constexpr int GROUPS_PER_SUB = SUB_L / GROUP_L;
constexpr int GROUPS_PER_BLOCK = BLOCK_L / GROUP_L;
constexpr int CHUNK_NT = 3;                   // n-tiles whose chains interleave
// The widest accumulator, 28 n-tiles, holds 224 rows; the limit stays the
// 223 that callers of the shared-memory design had.
constexpr int MAX_ROWS = 223;
static_assert(WARP_P == 16, "one m16 tile of points per warp");
static_assert(TILE_P == BLOCK_L && BLOCK_L <= THREADS,
              "threads below BLOCK_L stage one line each");
static_assert(SUB_L == 32 && N_SUB <= N_WARP,
              "warp w < N_SUB reduces the bounds of sub-block w");
static_assert(SUB_L % GROUP_L == 0, "whole groups per sub-block");

// The accumulator width (n-tiles of 8 rows) for R rows; the groups of 8
// lines staged at once (a stage: one barrier, one split); the depth of the
// ring of staged rows (DEPTH - 1 stages in flight while one is
// contracted).  Narrow rows stage a whole sub-block at a time.
__host__ __device__ constexpr int width(int R) {
  return R <= 16 ? 2 : R <= 72 ? 9 : (MAX_ROWS + 7) / 8;
}
__host__ __device__ constexpr int stage_groups(int NT) {
  return NT <= 2 ? GROUPS_PER_SUB : 1;
}
__host__ __device__ constexpr int depth(int NT) { return NT > 9 ? 2 : 4; }
// Blocks per SM the register budget aims at (__launch_bounds__).
__host__ __device__ constexpr int min_blocks(int NT) {
  return NT <= 2 ? 3 : NT <= 9 ? 2 : 1;
}
// Floats per staged coefficient row: the stage's lines and 4 of padding,
// so that the split's reads (8 rows x 4 lines per warp) hit 32 distinct
// banks (a row stride of 4 x an odd number).
__host__ __device__ constexpr int raw_stride(int SG) {
  return SG * GROUP_L + 4;
}

// Dynamic shared memory for R rows (n_used = ceil(R / 8) n-tiles, NT =
// width(R), SG = stage_groups(NT)): two B fragment buffers
// [SG][4][n_used][32] float4 and a ring of depth(NT) staging buffers
// [4][8 n_used][raw_stride(SG)] floats.
__host__ __device__ constexpr int fragment_floats(int SG, int n_used) {
  return SG * 4 * n_used * 32 * 4;
}
__host__ __device__ constexpr int staging_floats(int SG, int n_used) {
  return 4 * 8 * n_used * raw_stride(SG);
}
__host__ __device__ constexpr int smem_bytes(int R) {
  return 4 * (2 * fragment_floats(stage_groups(width(R)), (R + 7) / 8) +
              depth(width(R)) *
                  staging_floats(stage_groups(width(R)), (R + 7) / 8));
}
static_assert(smem_bytes(MAX_ROWS) <= 232448 - 8192 &&
                  smem_bytes(16) <= 232448 - 8192,
              "the Hopper block limit less the static staging arrays");

struct Staged {
  float nuc[BLOCK_L];
  float sx[BLOCK_L];
  float y[BLOCK_L];
  float chi[BLOCK_L];
};

// The block's shared staging: the lines, tiers and live groups of two
// line blocks (the next one is staged while the last stage of the current
// one runs), tile bounds per warp.
struct Shared {
  Staged s[2];
  int tier[2][N_SUB];
  unsigned char live[2][GROUPS_PER_BLOCK];
  float lo[N_WARP], hi[N_WARP];
};

// Round to TF32 (10 mantissa bits), to nearest even, as a 32-bit pattern
// with the low 13 bits zero (finite inputs).
__device__ __forceinline__ uint32_t tf32_rne(float a) {
  uint32_t u = __float_as_uint(a);
  u += 0x0fffu + ((u >> 13) & 1u);
  return u & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rne(a);
  lo = tf32_rne(__fsub_rn(a, __uint_as_float(hi)));
}

// d += a . b on the tensor cores: a the 16 x 8 A fragment, (b0, b1) the
// 8 x 8 B fragment, d the 16 x 8 fp32 fragment.  Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The true wavenumber bounds of the block's tile from each lane's two
// points (every thread calls it).
__device__ __forceinline__ void tile_bounds(Shared& sh, float nu0, float nu1,
                                            float& tile_lo, float& tile_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    const float lo = warp_min(fminf(nu0, nu1));
    const float hi = warp_max(fmaxf(nu0, nu1));
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

// Stage the 128 lines [l0, l0 + BLOCK_L) (one per thread below BLOCK_L)
// into buffer `buf` and pick each 32-line sub-block's tier (the decision
// of K1).
// A group is live where one of its lines lies within the cutoff of a
// point of the tile: with nu - c rounded as pair_basis rounds it (monotone
// in nu), no pair of a dead group is within the cutoff, so skipping it
// skips exact zeros.
template <bool HAS_CHI>
__device__ __forceinline__ void stage_lines(
    Shared& sh, int buf, const float* __restrict__ nuc,
    const float* __restrict__ sx, const float* __restrict__ yv,
    const float* __restrict__ chi, int l0, float tile_lo, float tile_hi,
    float cutoff) {
  const int tid = threadIdx.x;
  if (tid >= BLOCK_L) return;            // whole warps
  const int lane = tid & 31, warp = tid >> 5;
  const int l = l0 + tid;
  const float c = nuc[l];
  const float sxv = sx[l];
  const float yy = yv[l];
  Staged& s = sh.s[buf];
  s.nuc[tid] = c;
  s.sx[tid] = sxv;
  s.y[tid] = yy;
  if (HAS_CHI) s.chi[tid] = chi[l];
  const float c_min = warp_min(c), c_max = warp_max(c);
  const float sx_min = warp_min(sxv), y_min = warp_min(yy);
  if (lane == 0)
    sh.tier[buf][warp] = sub_block_tier(c_min, c_max, sx_min, y_min, tile_lo,
                                        tile_hi);
  const unsigned live = __ballot_sync(
      0xffffffffu, !(tile_hi - c < -cutoff || tile_lo - c > cutoff));
  if (lane < GROUPS_PER_SUB)
    sh.live[buf][warp * GROUPS_PER_SUB + lane] =
        (live >> (lane * GROUP_L)) & 0xffu ? 1 : 0;
}

// Start the copies of the R coefficient rows of the SG groups of lines
// [l, l + 8 SG) of each basis value into raw [4][8 n_used][raw_stride(SG)]
// (16-byte copies; rows R .. 8 n_used - 1 are never written).
template <int SG>
__device__ __forceinline__ void stage_rows(float* __restrict__ raw,
                                           const float* const (&cs)[4], int R,
                                           int n_used, int Lp, int l) {
  constexpr int CHUNKS = 2 * SG;       // 16-byte copies per row
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* dst = raw + k * 8 * n_used * raw_stride(SG);
    const float* src = cs[k] + l;
    for (int q = threadIdx.x; q < CHUNKS * R; q += THREADS) {
      const int r = q / CHUNKS, c = 4 * (q % CHUNKS);
      cp_async16(dst + r * raw_stride(SG) + c, src + (size_t)r * Lp + c);
    }
  }
}

// Zero the padding rows R .. 8 n_used - 1 of each basis value in the n
// staging buffers at raw (the split reads them as rows of zeros).
template <int SG>
__device__ __forceinline__ void zero_padding_rows(float* __restrict__ raw,
                                                  int n, int R, int n_used) {
  constexpr int RS = raw_stride(SG);
  const int pad = 8 * n_used - R;
  for (int i = threadIdx.x; i < n * 4 * pad * RS; i += THREADS) {
    const int f = i % RS, kr = i / RS;
    const int row = (kr / pad) * 8 * n_used + R + kr % pad;   // (slot, k)
    raw[row * RS + f] = 0.0f;
  }
}

// Split the staged rows of SG groups into hi/lo B fragments,
// frag[((s 4 + k) n_used + nt) 32 + lane] = {hi(b0), hi(b1), lo(b0),
// lo(b1)} with b0 = C_k[8 nt + g][8 s + t], b1 = C_k[8 nt + g][8 s + t + 4]
// (g = lane / 4, t = lane % 4): the staged row of item i of a group is
// 8 (i / 32) + g.
template <int SG>
__device__ __forceinline__ void split_rows(float4* __restrict__ frag,
                                           const float* __restrict__ raw,
                                           int n_used) {
  const int n = 4 * n_used * 32;
#pragma unroll
  for (int sg = 0; sg < SG; ++sg) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int lane = i & 31;
      const float* row = raw + (8 * (i >> 5) + (lane >> 2)) * raw_stride(SG) +
                         sg * GROUP_L + (lane & 3);
      uint32_t h0, l0, h1, l1;
      split_tf32(row[0], h0, l0);
      split_tf32(row[4], h1, l1);
      frag[sg * n + i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                     __uint_as_float(l0), __uint_as_float(l1));
    }
  }
}

// The basis of this lane's 4 pairs of one 8-line group (lines base + t and
// base + t + 4 of the staged block, points nu0 and nu1), split into the
// A fragments of the 4 basis values: element j is point (j & 1 ? nu1 :
// nu0), line t + 4 (j >> 1).  Returns whether a pair lies within the
// cutoff.
template <int TIER, bool HAS_CHI>
__device__ __forceinline__ bool group_basis(const Staged& s, int base,
                                            float nu0, float nu1,
                                            float cutoff,
                                            uint32_t (&ahi)[4][4],
                                            uint32_t (&alo)[4][4]) {
  const int t = threadIdx.x & 3;
  bool any = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = base + t + 4 * (j >> 1);
    float b[4];
    any |= pair_basis<TIER, HAS_CHI>((j & 1 ? nu1 : nu0) - s.nuc[i], s.sx[i],
                                     s.y[i], HAS_CHI ? s.chi[i] : 0.0f,
                                     cutoff, b[0], b[1], b[2], b[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) split_tf32(b[k], ahi[k][j], alo[k][j]);
  }
  return any;
}

// One group's products into the running sums: per n-tile a fresh chain of
// the 12 products (basis value k, passes lo.hi, hi.lo, hi.hi), then one
// fp32 add per element.  The chains of CHUNK_NT n-tiles are issued side by
// side, so consecutive products are independent.
template <int NT>
__device__ __forceinline__ void contract_group(const float4* __restrict__ frag,
                                               int n_used,
                                               const uint32_t (&ahi)[4][4],
                                               const uint32_t (&alo)[4][4],
                                               float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NT; c += CHUNK_NT) {
    if (c >= n_used) break;              // uniform over the block
    constexpr int W = NT < CHUNK_NT ? NT : CHUNK_NT;
    float d[W][4] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 b[W];
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (c + i < NT && c + i < n_used)
          b[i] = frag[(k * n_used + c + i) * 32 + lane];
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (c + i < NT && c + i < n_used)
          mma_tf32(d[i], alo[k], __float_as_uint(b[i].x),
                   __float_as_uint(b[i].y));
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (c + i < NT && c + i < n_used)
          mma_tf32(d[i], ahi[k], __float_as_uint(b[i].z),
                   __float_as_uint(b[i].w));
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (c + i < NT && c + i < n_used)
          mma_tf32(d[i], ahi[k], __float_as_uint(b[i].x),
                   __float_as_uint(b[i].y));
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (c + i < NT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c + i][e] += d[i][e];
      }
    }
  }
}

// The window [l_first, l_first + 8 n_groups) of one state (l_first at a
// line block; nuc, sx, yv, chi point at the state's [Lp] rows, cs[k] at its
// [R, Lp] rows of C_k) added into acc for this lane's points nu0, nu1.
// smem: smem_bytes(R) of dynamic shared memory.  One barrier per stage of
// SG groups: the rows of stage u + DEPTH - 1 are copied, the lines of the
// next line block staged and stage u + 1's fragments split while stage u
// is evaluated and contracted.  A stage with no live group is skipped.
template <int NT, bool HAS_CHI>
__device__ __forceinline__ void contract_window(
    Shared& sh, float* __restrict__ smem, const float* __restrict__ nuc,
    const float* __restrict__ sx, const float* __restrict__ yv,
    const float* __restrict__ chi, const float* const (&cs)[4], int R,
    int Lp, int l_first, int n_groups, float nu0, float nu1, float tile_lo,
    float tile_hi, float cutoff, float (&acc)[NT][4]) {
  if (n_groups == 0) return;
  constexpr int DEPTH = depth(NT), SG = stage_groups(NT);
  constexpr int STAGES_PER_BLOCK = GROUPS_PER_BLOCK / SG;
  constexpr int STAGE_L = SG * GROUP_L;
  const int n_used = (R + 7) / 8;
  const int n_stages = n_groups / SG;
  const int frag_n = fragment_floats(SG, n_used) / 4;   // float4 per buffer
  const int group_n = frag_n / SG;
  const int stage = staging_floats(SG, n_used);
  float4* frag = reinterpret_cast<float4*>(smem);       // [2][frag_n]
  float* raw = smem + 2 * fragment_floats(SG, n_used);  // [DEPTH][stage]
  const auto rows_of = [&](int u) { return raw + (u % DEPTH) * stage; };
  const auto stage_live = [&](int u) {
    const unsigned char* live =
        sh.live[(u / STAGES_PER_BLOCK) & 1] + (u % STAGES_PER_BLOCK) * SG;
    bool any = false;
#pragma unroll
    for (int j = 0; j < SG; ++j) any |= live[j] != 0;
    return any;
  };
  stage_lines<HAS_CHI>(sh, 0, nuc, sx, yv, chi, l_first, tile_lo, tile_hi,
                       cutoff);
  zero_padding_rows<SG>(raw, DEPTH, R, n_used);
#pragma unroll
  for (int u = 0; u < DEPTH - 1; ++u) {
    if (u < n_stages)
      stage_rows<SG>(rows_of(u), cs, R, n_used, Lp, l_first + u * STAGE_L);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 2>();
  __syncthreads();
  if (stage_live(0)) split_rows<SG>(frag, rows_of(0), n_used);
#pragma unroll 1
  for (int u = 0; u < n_stages; ++u) {
    const int lu = u % STAGES_PER_BLOCK, blk = u / STAGES_PER_BLOCK;
    const int ahead = u + DEPTH - 1;
    if (ahead < n_stages)
      stage_rows<SG>(rows_of(ahead), cs, R, n_used, Lp,
                     l_first + ahead * STAGE_L);
    cp_async_commit();
    if (lu == STAGES_PER_BLOCK - 1 && u + 1 < n_stages)
      stage_lines<HAS_CHI>(sh, (blk + 1) & 1, nuc, sx, yv, chi,
                           l_first + (u + 1) * STAGE_L, tile_lo, tile_hi,
                           cutoff);
    cp_async_wait<DEPTH - 2>();
    // Rows of stage u + 1 landed; fragments of stage u written; every
    // warp is done with stage u - 1 (its fragment buffer and ring slot).
    __syncthreads();
    if (u + 1 < n_stages && stage_live(u + 1))
      split_rows<SG>(frag + ((u + 1) & 1) * frag_n, rows_of(u + 1), n_used);
    if (!stage_live(u)) continue;        // uniform over the block
    const Staged& s = sh.s[blk & 1];
#pragma unroll 1
    for (int sg = 0; sg < SG; ++sg) {
      const int lg = lu * SG + sg;
      uint32_t ahi[4][4], alo[4][4];
      bool any;
      const int base = lg * GROUP_L;
      switch (sh.tier[blk & 1][lg / GROUPS_PER_SUB]) {
        case FAR:
          any = group_basis<FAR, HAS_CHI>(s, base, nu0, nu1, cutoff, ahi,
                                          alo);
          break;
        case MID:
          any = group_basis<MID, HAS_CHI>(s, base, nu0, nu1, cutoff, ahi,
                                          alo);
          break;
        case NEAR3:
          any = group_basis<NEAR3, HAS_CHI>(s, base, nu0, nu1, cutoff, ahi,
                                            alo);
          break;
        default:
          any = group_basis<NEAR4, HAS_CHI>(s, base, nu0, nu1, cutoff, ahi,
                                            alo);
          break;
      }
      if (__any_sync(0xffffffffu, any))
        contract_group<NT>(frag + (u & 1) * frag_n + sg * group_n, n_used,
                           ahi, alo, acc);
    }
  }
}

// Write this lane's sums: rows 8 nt + 2t (+1) at points p0 and p0 + 8 of
// out [R, Pp].
template <int NT>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[NT][4], int R,
                                           int Pp, int p0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = nt * 8 + 2 * t;
    if (r < R) {
      out[(size_t)r * Pp + p0] = acc[nt][0];
      out[(size_t)r * Pp + p0 + 8] = acc[nt][2];
    }
    if (r + 1 < R) {
      out[(size_t)(r + 1) * Pp + p0] = acc[nt][1];
      out[(size_t)(r + 1) * Pp + p0 + 8] = acc[nt][3];
    }
  }
}

// This lane's first point in the block's tile.
__device__ __forceinline__ int lane_point(int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return tile * TILE_P + warp * WARP_P + (lane >> 2);
}

// Whether the coefficient rows can be copied 16 bytes at a time.
__host__ inline bool rows_aligned(const float* c1, const float* c2,
                                  const float* c3, const float* c4) {
  return ((reinterpret_cast<uintptr_t>(c1) | reinterpret_cast<uintptr_t>(c2) |
           reinterpret_cast<uintptr_t>(c3) | reinterpret_cast<uintptr_t>(c4)) &
          15u) == 0;
}

// Launch fn<NT>() with the accumulator width for R rows.
template <typename F>
__host__ cudaError_t with_width(int R, F&& fn) {
  if (width(R) == width(16)) return fn(std::integral_constant<int, width(16)>());
  if (width(R) == width(72)) return fn(std::integral_constant<int, width(72)>());
  return fn(std::integral_constant<int, width(MAX_ROWS)>());
}

}  // namespace
