// Single-state fused basis contraction of the line sum's tangent: the CUDA
// port of the TPU kernel spectrobot_tpu/ops/pallas_opacity.py:_basis_kernel
// (K4), which the single-state line sum's forward-mode derivatives run
// (make_accumulate_op at one state: jvp, and jacfwd with every Jacobian
// column folded into the rows).
//
//   out[r, p] = sum_i ( C1[r, i] K  + C2[r, i] Kx
//                     + C3[r, i] xKx + C4[r, i] Ky )
//   K = Re w(x, y) * chi * [|dnu| <= cutoff],  Kx = dK/dx,  Ky = dK/dy,
//   xKx = x Kx,   dnu = nu[p] - nu_c[i],   x = dnu * sx[i]
//
// One state, any number of coefficient rows R.  chi scales all four basis
// values and is constant in the tangent (frozen-chi convention).  The
// thread block is K2's (basis_contract.cuh, with the per-pair basis and the
// tier decision of voigt_basis.cuh), so K4 and K2 agree pair for pair.
//
// What bounds it: as K2, the larger of the basis's FP32 work on the CUDA
// cores (per live pair roughly 2.5x the forward's Voigt evaluation), the
// three TF32 passes of the contraction on the tensor cores (4 FMAs per row
// per pair) and the bytes ([R, P] written once, or n_seg partials).
//
// What the design does about it: one state gives K2's grid of one block per
// (128-point tile, state) only P / 128 blocks.  K4 takes K3's grid instead
// (csrc/opacity_single.cu): each tile's window of line blocks is cut into
// segments of seg_blocks blocks, one thread block each, so a single state
// fills the card.  Within a segment a block runs K2's block
// (basis_contract.cuh): 8 warps of 16 points, each pair's basis evaluated
// once straight into the A fragments, the rows staged by cp.async and
// split once into B fragments, 3xTF32 mma.sync with the sums of every row
// in registers.  The [n_seg, R, Pp] partial sums are added in segment
// order by a second pass: deterministic, no atomics.  With one segment the
// first pass writes the result directly and equals K2 at B = 1 bit for bit.
// Occupancy as K2 (basis_batch.cu): ptxas -v gives 80, 122-123 and 210
// registers at NT = 2, 9 and 28 (8-20 bytes spilled), 3, 2 and 1 blocks
// of 8 warps per SM.
//
// Up to MAX_ROWS rows the basis is evaluated once per pair for all of
// them.  More rows than the registers hold are split into row groups, a
// third grid axis, each of which evaluates the basis of its segment anew.
//
// Build and binding as csrc/basis_batch.cu (nvcc sm_90a, plain C
// interface, ctypes: spectrobot_tpu_torch/ops/cuda_basis_single.py).

#include <cuda_runtime.h>

#include "basis_contract.cuh"

namespace {

constexpr int SUM_THREADS = 256;

// grid = (Pp / TILE_P, n_seg, n_grp), block = THREADS, smem_bytes(G) of
// dynamic shared memory.  nu [Pp]; nuc, sx, y, chi [Lp]; c1..c4 [R, Lp]
// (16-byte aligned); starts, counts [n_tiles] (window of line blocks per
// tile); part [n_seg, R, Pp]: segment k of tile t sums the blocks
// starts[t] + [k seg_blocks, (k + 1) seg_blocks) of its window, for the
// rows [g G, min((g + 1) G, R)) of row group g.  NT n-tiles of 8 rows
// cover G.
template <int NT, bool HAS_CHI>
__global__ void __launch_bounds__(THREADS, min_blocks(NT))
basis_single_kernel(const float* __restrict__ nu,
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
                    float* __restrict__ part, int R, int G, int Pp, int Lp,
                    int seg_blocks, float cutoff) {
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int r0 = blockIdx.z * G;
  const int Rg = min(G, R - r0);

  extern __shared__ float4 dyn[];
  __shared__ Shared sh;
  const int p0 = lane_point(tile);
  const float nu0 = nu[p0], nu1 = nu[p0 + 8];
  float tile_lo, tile_hi;
  tile_bounds(sh, nu0, nu1, tile_lo, tile_hi);

  const float* const cs[4] = {c1 + (size_t)r0 * Lp, c2 + (size_t)r0 * Lp,
                              c3 + (size_t)r0 * Lp, c4 + (size_t)r0 * Lp};
  const int first = seg * seg_blocks;
  const int last = min(counts[tile], first + seg_blocks);
  float acc[NT][4] = {};
  contract_window<NT, HAS_CHI>(
      sh, reinterpret_cast<float*>(dyn), nuc, sx, yv, chi, cs, Rg, Lp,
      (starts[tile] + first) * BLOCK_L,
      max(last - first, 0) * GROUPS_PER_BLOCK, nu0, nu1, tile_lo, tile_hi,
      cutoff, acc);
  store_rows<NT>(part + ((size_t)seg * R + r0) * Pp, acc, Rg, Pp, p0);
}

// out[i] = sum_k part[k, i] over the n_seg segments, in segment order.
__global__ void __launch_bounds__(SUM_THREADS)
sum_segments_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n_seg, size_t n) {
  const size_t i = (size_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n) return;
  float acc = part[i];
  for (int k = 1; k < n_seg; ++k) acc += part[(size_t)k * n + i];
  out[i] = acc;
}

template <bool HAS_CHI>
cudaError_t launch(const float* nu, const float* nuc, const float* sx,
                   const float* y, const float* chi, const float* c1,
                   const float* c2, const float* c3, const float* c4,
                   const int* starts, const int* counts, float* dst, int R,
                   int G, int n_grp, int Pp, int Lp, int n_seg,
                   int seg_blocks, float cutoff, cudaStream_t stream) {
  return with_width(G, [&](auto width) {
    constexpr int NT = decltype(width)::value;
    const int smem = smem_bytes(G);
    cudaError_t err = cudaFuncSetAttribute(
        basis_single_kernel<NT, HAS_CHI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Pp / TILE_P, n_seg, n_grp);
    basis_single_kernel<NT, HAS_CHI><<<grid, THREADS, smem, stream>>>(
        nu, nuc, sx, y, chi, c1, c2, c3, c4, starts, counts, dst, R, G, Pp,
        Lp, seg_blocks, cutoff);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Tile and block geometry and the rows of one group, so the wrapper can
// check its window tables and split its rows against the kernel.
int basis_single_tile_p() { return TILE_P; }
int basis_single_block_l() { return BLOCK_L; }
int basis_single_sub_l() { return SUB_L; }
int basis_single_max_rows() { return MAX_ROWS; }

const char* basis_single_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns the CUDA error of the launches (0 =
// launched).  `chi` may be null (no wing correction); cutoff = +inf
// disables the mask; c1..c4 must be 16-byte aligned (cp.async).  R rows
// in n_grp groups of at most G <= MAX_ROWS.
// With n_seg > 1, `part` holds [n_seg, R, Pp] floats of scratch; with
// n_seg == 1 it is not read and may be null.
int basis_single_launch(const float* nu, const float* nuc, const float* sx,
                        const float* y, const float* chi, const float* c1,
                        const float* c2, const float* c3, const float* c4,
                        const int* starts, const int* counts, float* part,
                        float* out, int R, int G, int Pp, int Lp, int n_seg,
                        int seg_blocks, float cutoff, void* stream) {
  if (R <= 0 || G <= 0 || G > MAX_ROWS || Pp <= 0 || Pp % TILE_P != 0 ||
      Lp <= 0 || Lp % BLOCK_L != 0 || n_seg < 1 || n_seg > 65535 ||
      seg_blocks < 1 || (n_seg > 1 && part == nullptr) ||
      !rows_aligned(c1, c2, c3, c4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_grp = (R + G - 1) / G;
  if (n_grp > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* dst = n_seg == 1 ? out : part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      chi != nullptr
          ? launch<true>(nu, nuc, sx, y, chi, c1, c2, c3, c4, starts, counts,
                         dst, R, G, n_grp, Pp, Lp, n_seg, seg_blocks, cutoff,
                         s)
          : launch<false>(nu, nuc, sx, y, nullptr, c1, c2, c3, c4, starts,
                          counts, dst, R, G, n_grp, Pp, Lp, n_seg, seg_blocks,
                          cutoff, s);
  if (err != cudaSuccess || n_seg == 1) return static_cast<int>(err);
  const size_t n = (size_t)R * Pp;
  sum_segments_kernel<<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS),
                        SUM_THREADS, 0, s>>>(part, out, n_seg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
