// Batched transposed basis contraction, the reverse-mode kernel of the line
// sum: the CUDA port of the TPU kernel
// spectrobot_tpu/ops/pallas_opacity.py:_basis_transpose_kernel (K5), which
// the reference's custom-VJP line sum (analytic_jvp='rev') runs once per
// gradient.
//
//   AbK[b, r, i]   = sum_p ct[b, r, p] K(p, i)     (and likewise Kx, xKx, Ky)
//
// with the basis {K, Kx, xKx, Ky} of voigt_basis.cuh at every (point p,
// line i) pair of state b: the cotangent projections that reverse-mode AD
// contracts into the (nu_c, sx, y, amps) cotangents (a small epilogue in
// ops/opacity.py).  r runs over the cotangent rows: the two depths under
// torch.autograd.grad, 2 n_ct when torch.func.jacrev folds its n_ct
// cotangents into the rows.  The basis is evaluated by the functions K2
// (basis_batch.cu) uses, with K2's tile, block and 32-line sub-block and
// K2's tier decision, so this kernel is the exact adjoint of K2 and the
// host's tier_counts holds for it.
//
// What bounds it: FP32 work on the CUDA cores, the basis (far ~30 flops per
// pair, near4 ~700) and 4 FMAs per row per pair (8 at R = 2, the gradient;
// 264 at R = 66).  Device-memory bytes are small: the cotangent rows are
// read once per visited (line block, tile) and the [4, R, L] output written
// once.
//
// What the design does about it:
//  * One block per (128-line block, state, segment, row chunk), one line
//    per thread: warp w owns sub-block w, so the tier of each (tile,
//    sub-block) is warp-uniform and is decided from the warp's own line
//    bounds.
//  * Each line block's tile window (host table, the transpose of K2's
//    block windows: the same visited (tile, block) pairs) is cut into
//    n_seg segments of seg_tiles tiles, one thread block each (the host
//    picks n_seg so that a call makes a few thousand blocks: a limb
//    gradient has one line block per state, one state a handful of line
//    blocks).  Each block stages its tiles' grid points and cotangent rows
//    in shared memory and reads the rows as float4 broadcasts (the same
//    address across the warp).  The basis of GROUP points is evaluated
//    into registers, then contracted against every row.
//  * Each line's sums stay in registers, in point order: all 4R of them
//    at R <= 2 (the gradient), else 4 x 8 for a chunk of 8 rows, one block
//    per chunk.  Each chunk evaluates the basis again, which costs less
//    than keeping 4R sums per line in shared memory (on an H100 a folded
//    jacrev at R = 66 spent 93 % of its time on their read-modify-writes).
//  * A warp skips a tile that lies beyond the cutoff of all its lines, and
//    the block skips a tile whose cotangent rows are all zero (so a state
//    with no nonzero row, dead for this kernel, does no work and writes
//    zeros).  Both are exact: every term left out is a product with a pair
//    masked by the cutoff, or with a zero.
//  * With one segment the block writes its sums; with several, each block
//    writes its partial sums to a workspace and the last block of its
//    (line block, state, row chunk) to arrive (an atomic count, the only
//    atomic) adds the segments in segment order.  Deterministic: no
//    atomics on values, no TF32, no fast math.
//  * The kernel reads the unpadded [B, L] rows and [B, R, P] cotangents:
//    lines at or past L take the host's old padding in registers (for the
//    tier decision) and are not written; points at or past P count as
//    zero cotangents.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).  Bound through ctypes by
//        spectrobot_tpu_torch/ops/cuda_transpose.py.

#include <cfloat>

#include <cuda_runtime.h>

#include "voigt_basis.cuh"

namespace {

constexpr int GROUP = 4;       // points whose basis is held in registers
constexpr int N_WARP = BLOCK_L / 32;
constexpr int REG_ROWS = 2;    // rows of a block at R <= REG_ROWS
constexpr int CHUNK_ROWS = 8;  // rows of a block above
// The most rows one call takes (ops.opacity.BasisTranspose splits a folded
// jacrev batch into calls of at most this many).
constexpr int MAX_ROWS = 89;
constexpr float PAD_WIDTH = 1e6f;  // sx and y of a padding line
static_assert(TILE_P == BLOCK_L, "each thread stages one point per tile");
static_assert(SUB_L == 32, "one warp per sub-block");
static_assert(TILE_P % GROUP == 0 && GROUP == 4, "float4 row reads");

// One staged tile for this thread's line: every real point of the tile, in
// order, GROUP points at a time, against the first n_rows of the RR staged
// rows ct_s [RR][TILE_P].
template <int TIER, bool HAS_CHI, int RR>
__device__ __forceinline__ void walk_tile(const float* __restrict__ nu_s,
                                          const float* __restrict__ ct_s,
                                          float (&acc)[4][RR], int n_rows,
                                          int n_valid, float nuc, float sx,
                                          float y, float chi_b,
                                          float cutoff) {
#pragma unroll 1
  for (int g = 0; g < n_valid; g += GROUP) {
    float b[4][GROUP];
    bool any = false;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (g + j < n_valid) {
        any |= pair_basis<TIER, HAS_CHI>(nu_s[g + j] - nuc, sx, y, chi_b,
                                         cutoff, b[0][j], b[1][j], b[2][j],
                                         b[3][j]);
      } else {                 // a padded point: all four values 0
        b[0][j] = b[1][j] = b[2][j] = b[3][j] = 0.0f;
      }
    }
    if (!any) continue;        // every term would add an exact zero
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      if (r >= n_rows) break;
      const float4 c = *reinterpret_cast<const float4*>(ct_s + r * TILE_P + g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a = acc[k][r];
        a = fmaf(c.x, b[k][0], a);
        a = fmaf(c.y, b[k][1], a);
        a = fmaf(c.z, b[k][2], a);
        a = fmaf(c.w, b[k][3], a);
        acc[k][r] = a;
      }
    }
  }
}

// grid = (n_lblk, B, n_seg * n_chunks), block = BLOCK_L threads; block z
// is segment z % n_seg of row chunk z / n_seg (rows [RR c, RR c + RR)).
// nu [Pp] (the padded grid); nuc, sx, y, chi [B, L]; ct [B, R, P];
// tstarts, tcounts [n_lblk]; oK, oKx, oxKx, oKy [B, R, L].  With
// n_seg > 1: part [n_seg, B, 4R, n_lblk * BLOCK_L] and counters
// [B, n_lblk, n_chunks], zero between calls.
template <bool HAS_CHI, int RR>
__global__ void __launch_bounds__(BLOCK_L)
basis_transpose_kernel(const float* __restrict__ nu,
                       const float* __restrict__ nuc,
                       const float* __restrict__ sx,
                       const float* __restrict__ yv,
                       const float* __restrict__ chi,
                       const float* __restrict__ ct,
                       const int* __restrict__ tstarts,
                       const int* __restrict__ tcounts,
                       float* __restrict__ part, int* __restrict__ counters,
                       float* __restrict__ oK, float* __restrict__ oKx,
                       float* __restrict__ oxKx, float* __restrict__ oKy,
                       int R, int P, int L, float far, int n_seg,
                       int seg_tiles, float cutoff) {
  const int blk = blockIdx.x, n_lblk = gridDim.x;
  const int b = blockIdx.y, B = gridDim.y;
  const int seg = blockIdx.z % n_seg, chunk = blockIdx.z / n_seg;
  const int r0 = chunk * RR, n_rows = min(RR, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = blk * BLOCK_L + tid;
  const bool real = l < L;

  __shared__ float4 ct_s4[RR * TILE_P / 4];
  float* const ct_s = reinterpret_cast<float*>(ct_s4);  // [RR][TILE_P]
  __shared__ float nu_s[TILE_P];
  __shared__ float s_lo[N_WARP], s_hi[N_WARP];
  __shared__ int s_last;

  // This thread's line, and the bounds of its warp's sub-block (fixed over
  // the whole tile walk): the tier's over every lane, padding included (as
  // the host's tier_counts), the skip's over the real lines.
  const size_t row = (size_t)b * L + l;
  const float c = real ? nuc[row] : far;
  const float sxv = real ? sx[row] : PAD_WIDTH;
  const float yy = real ? yv[row] : PAD_WIDTH;
  const float chv = HAS_CHI && real ? chi[row] : 0.0f;
  const float c_min = warp_min(c), c_max = warp_max(c);
  const float sx_min = warp_min(sxv), y_min = warp_min(yy);
  const float r_min = warp_min(real ? c : INFINITY);
  const float r_max = warp_max(real ? c : -INFINITY);

  float acc[4][RR];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < RR; ++r) acc[k][r] = 0.0f;

  const float* ct_b = ct + ((size_t)b * R + r0) * P;
  const int start = tstarts[blk];
  const int count = tcounts[blk];
  const int t0 = seg * seg_tiles;
  const int t1 = min(count, t0 + seg_tiles);
  for (int t = t0; t < t1; ++t) {
    const int p0 = (start + t) * TILE_P;
    __syncthreads();           // everyone is done with the previous tile
    const float nu_p = nu[p0 + tid];
    nu_s[tid] = nu_p;
    const bool on_grid = p0 + tid < P;
    bool nz = false;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const float v = r < n_rows && on_grid ? ct_b[(size_t)r * P + p0 + tid]
                                            : 0.0f;
      ct_s[r * TILE_P + tid] = v;
      nz |= v != 0.0f;
    }
    // The tile's true wavenumber bounds (padded points included, as K2).
    const float lo = warp_min(nu_p), hi = warp_max(nu_p);
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    if (!__syncthreads_or(nz)) continue;     // every row zero on this tile
    float tile_lo = s_lo[0], tile_hi = s_hi[0];
#pragma unroll
    for (int w = 1; w < N_WARP; ++w) {
      tile_lo = fminf(tile_lo, s_lo[w]);
      tile_hi = fmaxf(tile_hi, s_hi[w]);
    }
    // As K1's run test (opacity_batch.cu): rounding is monotone, so a gap
    // beyond the cutoff leaves every pair of the warp's lines beyond it;
    // the slack of 4 ulps of cutoff + |nu| covers a difference rounded
    // otherwise.
    const float reach =
        cutoff + 4.0f * FLT_EPSILON *
                     (cutoff + fmaxf(fabsf(tile_lo), fabsf(tile_hi)));
    const float gap = fmaxf(fmaxf(r_min - tile_hi, tile_lo - r_max), 0.0f);
    if (gap > reach) continue;               // uniform over the warp
    const int n_valid = min(TILE_P, P - p0);
    switch (sub_block_tier(c_min, c_max, sx_min, y_min, tile_lo, tile_hi)) {
      case FAR:
        walk_tile<FAR, HAS_CHI, RR>(nu_s, ct_s, acc, n_rows, n_valid, c, sxv,
                                    yy, chv, cutoff);
        break;
      case MID:
        walk_tile<MID, HAS_CHI, RR>(nu_s, ct_s, acc, n_rows, n_valid, c, sxv,
                                    yy, chv, cutoff);
        break;
      case NEAR3:
        walk_tile<NEAR3, HAS_CHI, RR>(nu_s, ct_s, acc, n_rows, n_valid, c,
                                      sxv, yy, chv, cutoff);
        break;
      default:
        walk_tile<NEAR4, HAS_CHI, RR>(nu_s, ct_s, acc, n_rows, n_valid, c,
                                      sxv, yy, chv, cutoff);
        break;
    }
  }

  float* const outs[4] = {oK, oKx, oxKx, oKy};
  const size_t orow = ((size_t)b * R + r0) * L + l;
  if (n_seg == 1) {
    if (real)
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        if (r >= n_rows) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) outs[k][orow + (size_t)r * L] = acc[k][r];
      }
    return;
  }
  // Partial sums q = k R + r of every row r, segment by segment.
  const size_t lpad = (size_t)n_lblk * BLOCK_L;
  const size_t seg_stride = (size_t)B * 4 * R * lpad;
  float* const mine = part + ((size_t)b * 4 * R + r0) * lpad + l;
  if (t0 < count)
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      if (r >= n_rows) break;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        mine[seg * seg_stride + (size_t)(k * R + r) * lpad] = acc[k][r];
    }
  // The last block of this (line block, state, row chunk) to arrive adds
  // the segments that hold a part, in segment order.
  __threadfence();
  __syncthreads();
  int* const arrived =
      counters + ((size_t)b * n_lblk + blk) * (gridDim.z / n_seg) + chunk;
  if (tid == 0) s_last = atomicAdd(arrived, 1) == n_seg - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n_used = count > 0 ? (count + seg_tiles - 1) / seg_tiles : 0;
  if (real)
    for (int r = 0; r < n_rows; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* src = mine + (size_t)(k * R + r) * lpad;
        float v = n_used > 0 ? __ldcg(src) : 0.0f;
        for (int s = 1; s < n_used; ++s) v += __ldcg(src + s * seg_stride);
        outs[k][orow + (size_t)r * L] = v;
      }
  if (tid == 0) *arrived = 0;  // ready for the next call
}

template <bool HAS_CHI, int RR>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* ct,
                   const int* tstarts, const int* tcounts, float* part,
                   int* counters, float* oK, float* oKx, float* oxKx,
                   float* oKy, int B, int R, int P, int L, int n_lblk,
                   int n_seg, int seg_tiles, float far, float cutoff,
                   cudaStream_t stream) {
  const dim3 grid(n_lblk, B, n_seg * ((R + RR - 1) / RR));
  basis_transpose_kernel<HAS_CHI, RR><<<grid, BLOCK_L, 0, stream>>>(
      nu, nuc, sx, y, chi, ct, tstarts, tcounts, part, counters, oK, oKx,
      oxKx, oKy, R, P, L, far, n_seg, seg_tiles, cutoff);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile and block geometry, the rows of a block and the row limit, so the
// wrapper can check its window tables, its segments and its inputs
// against the kernel that reads them.
int basis_transpose_tile_p() { return TILE_P; }
int basis_transpose_block_l() { return BLOCK_L; }
int basis_transpose_sub_l() { return SUB_L; }
int basis_transpose_reg_rows() { return REG_ROWS; }
int basis_transpose_chunk_rows() { return CHUNK_ROWS; }
int basis_transpose_max_rows() { return MAX_ROWS; }

const char* basis_transpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns the CUDA error of the launch (0 =
// launched).  nu is the padded grid [Pp] over n_lblk line blocks of the
// window table; the rows are unpadded.  `far` is the center the window
// table gave padding lines.  `chi` may be null (no wing correction);
// cutoff = +inf disables the mask.  A block takes R rows at R <= REG_ROWS,
// else CHUNK_ROWS (n_chunks blocks per segment).  With n_seg > 1, `part`
// holds [n_seg, B, 4R, n_lblk * BLOCK_L] floats of scratch and `counters`
// B * n_lblk * n_chunks ints that are zero (each call leaves them zero);
// with n_seg == 1 neither is read and both may be null.
int basis_transpose_launch(const float* nu, const float* nuc, const float* sx,
                           const float* y, const float* chi, const float* ct,
                           const int* tstarts, const int* tcounts,
                           float* part, int* counters, float* oK, float* oKx,
                           float* oxKx, float* oKy, int B, int R, int P,
                           int Pp, int L, int n_lblk, int n_seg,
                           int seg_tiles, float far, float cutoff,
                           void* stream) {
  const int rr = R <= REG_ROWS ? REG_ROWS : CHUNK_ROWS;
  if (B <= 0 || B > 65535 || R <= 0 || R > MAX_ROWS || P < 0 || P > Pp ||
      Pp <= 0 || Pp % TILE_P != 0 || L < 0 || n_lblk <= 0 ||
      (long long)n_lblk * BLOCK_L < L || n_seg < 1 || seg_tiles < 1 ||
      (long long)n_seg * ((R + rr - 1) / rr) > 65535 ||
      (n_seg > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chi != nullptr)
    err = R <= REG_ROWS
              ? launch<true, REG_ROWS>(nu, nuc, sx, y, chi, ct, tstarts,
                                       tcounts, part, counters, oK, oKx,
                                       oxKx, oKy, B, R, P, L, n_lblk, n_seg,
                                       seg_tiles, far, cutoff, s)
              : launch<true, CHUNK_ROWS>(nu, nuc, sx, y, chi, ct, tstarts,
                                         tcounts, part, counters, oK, oKx,
                                         oxKx, oKy, B, R, P, L, n_lblk,
                                         n_seg, seg_tiles, far, cutoff, s);
  else
    err = R <= REG_ROWS
              ? launch<false, REG_ROWS>(nu, nuc, sx, y, nullptr, ct, tstarts,
                                        tcounts, part, counters, oK, oKx,
                                        oxKx, oKy, B, R, P, L, n_lblk, n_seg,
                                        seg_tiles, far, cutoff, s)
              : launch<false, CHUNK_ROWS>(nu, nuc, sx, y, nullptr, ct,
                                          tstarts, tcounts, part, counters,
                                          oK, oKx, oxKx, oKy, B, R, P, L,
                                          n_lblk, n_seg, seg_tiles, far,
                                          cutoff, s);
  return static_cast<int>(err);
}

}  // extern "C"
