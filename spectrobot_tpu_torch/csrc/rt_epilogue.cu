// The RT epilogue of a limb or black-surface ray set, fused: the source
// assembly S_l = B_nu(T_l) k_em / k_abs (forward/limb.py:optics_from_tau)
// and the layer-path integral of forward/rt.py:layer_path_radiance,
//
//   I = sum_k S_l(k) (t_k - t_{k+1}) + I_bg t_end,   t_k = exp(-c_{k-1}),
//
// for the primal (one launch) and for every forward-mode tangent column
// of a Jacobian (one launch for all of them).  No TPU kernel is replaced:
// the JAX package leaves the epilogue to XLA, which fuses it
// (spectrobot_tpu/forward/limb.py); the port ran it as some fifteen
// PyTorch ops, each writing and reading a [n_t, R, NL or n_seg, P]
// temporary under jacfwd's vmap.
//
// What bounds it on an H100: the bytes of the depth tangents, n_t x R x NL
// x P values of each row read (one row in LTE, two in non-LTE); the
// arithmetic is a few FMAs a value.
//
// What the design does about it: the tangent is linear in the three
// tangent inputs, so each (ray, point) first computes, from the primal
// alone, one coefficient a layer for each of them,
//
//   dI = sum_l dT_l a_l + d_em_l b_l + d_tau_l g_l  + d_bg t_end,
//   a_l = dB/dT q W_l,  b_l = B W_l / tau_l (0 where tau_l <= tiny),
//   g_l = G_l - q b_l,  W_l = sum over l's crossings of t_k - t_{k+1},
//   G_l = sum over l's crossings of (S_l t_{k+1} - R_k),
//
// (R_k = I - the emission up to and including crossing k: what reaches
// the observer from beyond it), and then contracts every tangent column
// with them.  So each tangent value is read once, whatever the number of
// crossings of its layer, in place (strides; K2's unfolded output is
// never copied).  A block owns one ray and TILE_P grid points: all its
// threads stage the layers' depths and sources in shared memory, one
// warp pair walks the segments observer first (a thread a point), all
// threads turn the walk's sums into the coefficients, and the block's
// COL_GROUPS x TILE_P threads take the columns, one at a time each (a
// warp reads 32 consecutive points of one (column, layer) row: 128
// bytes).
// IEEE exp/expm1 (no fast math).  Two types, as the composed ops promote
// them: TD, the depths' (the path sums and transmittances, the ratio and
// its threshold), and TS, the sources' (T_air's, or wider: Planck, the
// emission and every sum a source enters, the output).  Instances: float
// and float, double and double, and float depths under a float64
// atmosphere (the CLI forward's).
//
// Build and binding as csrc/opacity_batch.cu (nvcc sm_90a, plain C
// interface, ctypes: spectrobot_tpu_torch/ops/cuda_epilogue.py).

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int TILE_P = 64;      // grid points a block
constexpr int COL_GROUPS = 4;   // thread rows a block in tangent mode
constexpr int THREADS = TILE_P * COL_GROUPS;
constexpr int SMEM_MAX = 232448;

struct Dims {
  int R, NL, P, n_seg, n_t;
};

// Element strides of every tensor: the primal's and the tangents' (j the
// tangent column).
struct Strides {
  long long nu_p, T_r, T_l;
  long long tau_r, tau_l, tau_p, em_r, em_l, em_p, bg_r, bg_p;
  long long dT_j, dT_r, dT_l;
  long long dd_j, dd_r, dd_l, dd_p;
  long long de_j, de_r, de_l, de_p;
  long long db_j, db_r, db_p;
};

template <typename TD, typename TS>
struct Ptrs {
  const TD* nu;
  const TS* T_air;
  const TD* tau;
  const TD* tau_em;    // null in LTE: the ratio is 1
  const long long* seg;
  const TS* bg;
  const TS* dT;
  const TD* d_tau;
  const TD* d_em;
  const TS* d_bg;
  TS* out;
};

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float expm1_(float v) { return expm1f(v); }
__device__ __forceinline__ double expm1_(double v) { return expm1(v); }

// optics_from_tau's ratio threshold: dtau^2 stays in normal range.
template <typename T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return 1e-16f; }
template <>
__device__ __forceinline__ double tiny<double>() { return 1e-150; }

// B_nu(T) = c1 nu^3 / expm1(c2 nu / T) as ops/planck.py orders it, and
// with `slope` also dB/dT = B (e + 1) / e x / T (e = expm1(x), x = c2 nu
// / T).
template <typename T>
__device__ __forceinline__ T planck(T nu, T temp, T c1, T c2, T* slope) {
  const T x = c2 * nu / temp;
  const T e = expm1_(x);
  const T B = c1 * (nu * nu * nu) / e;
  if (slope) *slope = B * ((e + T(1)) / e) * (x / temp);
  return B;
}

template <typename TS>
size_t shared_bytes(int NL, int n_seg, bool tangent) {
  return (static_cast<size_t>(tangent ? 4 : 2) * NL + 2) * TILE_P * sizeof(TS) +
         static_cast<size_t>(n_seg + NL) * sizeof(int);
}

// The tangent launch after the walk: the crossing counts, the
// coefficients from the walk's sums (in place) and the contraction of
// every column with them.
template <typename TD, typename TS, bool EM>
__device__ __forceinline__ void tangent_tail(
    const Ptrs<TD, TS>& a, const Dims& d, const Strides& s, TS c1, TS c2,
    TS* tau_s, TS* src_s, TS* W_s, TS* H_s, const TS* I_s, const TS* tend_s,
    const int* seg_s, int* cnt_s, int tid, int nthreads) {
  const int NL = d.NL;
  const int r = blockIdx.y;
  const int p0 = blockIdx.x * TILE_P;
  const int x = threadIdx.x;
  const int p = p0 + x;
  const TS zero = TS(0);
  for (int l = tid; l < NL; l += nthreads) {
    int n = 0;
    for (int k = 0; k < d.n_seg; ++k) n += seg_s[k] == l;
    cnt_s[l] = n;
  }
  __syncthreads();

  // The walk's sums -> the coefficients, in place.
  for (int i = tid; i < NL * TILE_P; i += nthreads) {
    const int l = i / TILE_P, xi = i - l * TILE_P, pi = p0 + xi;
    if (pi >= d.P) continue;
    TS slope;
    const TS B = planck(static_cast<TS>(a.nu[pi * s.nu_p]),
                        a.T_air[r * s.T_r + l * s.T_l], c1, c2, &slope);
    const TS W = W_s[i];
    const TS G = H_s[i] - static_cast<TS>(cnt_s[l]) * I_s[xi];
    if (EM) {
      const TD tau = static_cast<TD>(tau_s[i]);
      const bool ok = tau > tiny<TD>();
      const TS q = ok ? static_cast<TS>(
                            a.tau_em[r * s.em_r + l * s.em_l + pi * s.em_p] /
                            tau)
                      : TS(1);
      const TS b = ok ? B * (W / static_cast<TS>(tau)) : zero;
      tau_s[i] = slope * q * W;
      src_s[i] = b;
      H_s[i] = G - q * b;
    } else {
      tau_s[i] = slope * W;
      H_s[i] = G;
    }
  }
  __syncthreads();
  if (p >= d.P) return;

  // The contraction: a column at a time, its layers in order.
  const TS t_end = tend_s[x];
  const long long out_j = static_cast<long long>(d.R) * d.P;
  for (int j = threadIdx.y; j < d.n_t; j += COL_GROUPS) {
    const TS* dT = a.dT + j * s.dT_j + r * s.dT_r;
    const TD* dd = a.d_tau + j * s.dd_j + r * s.dd_r + p * s.dd_p;
    const TD* de =
        EM ? a.d_em + j * s.de_j + r * s.de_r + p * s.de_p : nullptr;
    TS acc = zero;
#pragma unroll 8
    for (int l = 0; l < NL; ++l) {
      const int i = l * TILE_P + x;
      acc += dT[l * s.dT_l] * tau_s[i];
      if (EM) acc += static_cast<TS>(de[l * s.de_l]) * src_s[i];
      acc += static_cast<TS>(dd[l * s.dd_l]) * H_s[i];
    }
    acc += a.d_bg[j * s.db_j + r * s.db_r + p * s.db_p] * t_end;
    a.out[j * out_j + static_cast<long long>(r) * d.P + p] = acc;
  }
}

template <typename TD, typename TS, bool EM, bool TANGENT>
__global__ void __launch_bounds__(THREADS)
    rt_epilogue_kernel(Ptrs<TD, TS> a, Dims d, Strides s, TS c1, TS c2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NL = d.NL;
  const int r = blockIdx.y;
  const int p0 = blockIdx.x * TILE_P;
  const int x = threadIdx.x;
  const int tid = threadIdx.y * TILE_P + x;
  const int nthreads = TILE_P * blockDim.y;
  // [NL][TILE_P] each, in TS (a depth converts exactly): the depth, then
  // a_l; the source, then b_l; (tangent mode) W_l; H_l = sum (S t_{k+1} +
  // E_k), then g_l.
  TS* tau_s = reinterpret_cast<TS*>(smem);
  TS* src_s = tau_s + NL * TILE_P;
  TS* W_s = src_s + NL * TILE_P;
  TS* H_s = W_s + NL * TILE_P;
  TS* I_s = TANGENT ? H_s + NL * TILE_P : W_s;
  TS* tend_s = I_s + TILE_P;
  int* seg_s = reinterpret_cast<int*>(tend_s + TILE_P);
  int* cnt_s = seg_s + d.n_seg;

  for (int k = tid; k < d.n_seg; k += nthreads)
    seg_s[k] = static_cast<int>(a.seg[k]);
  const TS zero = TS(0);
  for (int i = tid; i < NL * TILE_P; i += nthreads) {
    const int l = i / TILE_P, xi = i - l * TILE_P, p = p0 + xi;
    TD tau = TD(0);
    TS S = zero;
    if (p < d.P) {
      tau = a.tau[r * s.tau_r + l * s.tau_l + p * s.tau_p];
      S = planck(static_cast<TS>(a.nu[p * s.nu_p]),
                 a.T_air[r * s.T_r + l * s.T_l], c1, c2,
                 static_cast<TS*>(nullptr));
      if (EM && tau > tiny<TD>())
        S *= static_cast<TS>(a.tau_em[r * s.em_r + l * s.em_l + p * s.em_p] /
                             tau);
    }
    tau_s[i] = tau;
    src_s[i] = S;
    if (TANGENT) W_s[i] = H_s[i] = zero;
  }
  __syncthreads();

  const int p = p0 + x;
  if (threadIdx.y == 0) {   // the walk, observer first: a thread a point
    TD c = TD(0), tb = TD(1);
    TS E = zero;
    for (int k = 0; k < d.n_seg; ++k) {
      const int l = seg_s[k];
      if (static_cast<unsigned>(l) >= static_cast<unsigned>(NL)) continue;
      const int i = l * TILE_P + x;
      const TS S = src_s[i];
      c += static_cast<TD>(tau_s[i]);
      const TD ta = exp_(-c);
      const TD w = tb - ta;
      E += S * static_cast<TS>(w);
      if (TANGENT) {
        W_s[i] += w;
        H_s[i] += S * static_cast<TS>(ta) + E;
      }
      tb = ta;
    }
    const TS bg = p < d.P ? a.bg[r * s.bg_r + p * s.bg_p] : zero;
    const TS I = E + bg * static_cast<TS>(tb);
    if (!TANGENT) {
      if (p < d.P) a.out[static_cast<long long>(r) * d.P + p] = I;
      return;
    }
    I_s[x] = I;
    tend_s[x] = tb;
  }
  if (TANGENT)   // a primal block ends with the walk
    tangent_tail<TD, TS, EM>(a, d, s, c1, c2, tau_s, src_s, W_s, H_s, I_s,
                             tend_s, seg_s, cnt_s, tid, nthreads);
}

template <typename TD, typename TS, bool EM, bool TANGENT>
cudaError_t launch(const Ptrs<TD, TS>& a, const Dims& d, const Strides& s,
                   double c1, double c2, cudaStream_t stream) {
  const size_t smem = shared_bytes<TS>(d.NL, d.n_seg, TANGENT);
  if (smem > static_cast<size_t>(SMEM_MAX)) return cudaErrorInvalidValue;
  auto kernel = rt_epilogue_kernel<TD, TS, EM, TANGENT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((d.P + TILE_P - 1) / TILE_P, d.R);
  dim3 block(TILE_P, TANGENT ? COL_GROUPS : 1);
  kernel<<<grid, block, smem, stream>>>(a, d, s, static_cast<TS>(c1),
                                        static_cast<TS>(c2));
  return cudaGetLastError();
}

template <typename TD, typename TS>
int dispatch(int tangent, const void* const* ptrs, const Dims& d,
             const Strides& s, double c1, double c2, cudaStream_t stream) {
  Ptrs<TD, TS> a{static_cast<const TD*>(ptrs[0]),
                 static_cast<const TS*>(ptrs[1]),
                 static_cast<const TD*>(ptrs[2]),
                 static_cast<const TD*>(ptrs[3]),
                 static_cast<const long long*>(ptrs[4]),
                 static_cast<const TS*>(ptrs[5]),
                 static_cast<const TS*>(ptrs[6]),
                 static_cast<const TD*>(ptrs[7]),
                 static_cast<const TD*>(ptrs[8]),
                 static_cast<const TS*>(ptrs[9]),
                 static_cast<TS*>(const_cast<void*>(ptrs[10]))};
  const bool em = a.tau_em != nullptr;
  if (tangent && em != (a.d_em != nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (tangent)
    err = em ? launch<TD, TS, true, true>(a, d, s, c1, c2, stream)
             : launch<TD, TS, false, true>(a, d, s, c1, c2, stream);
  else
    err = em ? launch<TD, TS, true, false>(a, d, s, c1, c2, stream)
             : launch<TD, TS, false, false>(a, d, s, c1, c2, stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int rt_epilogue_tile_p() { return TILE_P; }
int rt_epilogue_col_groups() { return COL_GROUPS; }
int rt_epilogue_shared_max() { return SMEM_MAX; }

const char* rt_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` of `device` and returns the CUDA error of the
// launch (0 = launched).  ptrs: nu, T_air, tau, tau_em (null: LTE), seg
// (int64), bg, dT, d_tau, d_em (null with tau_em null), d_bg, out; in
// primal mode (tangent 0) the four tangent pointers are unused.  dims: R,
// NL, P, n_seg, n_t; strides: the Strides struct's 25 values in order.
// types: 0 float depths and sources, 1 double and double, 2 float depths
// and double sources (T_air, bg, dT, d_bg and out double).
int rt_epilogue_launch(int device, int types, int tangent,
                       const void* const* ptrs, const long long* dims,
                       const long long* strides, double c1, double c2,
                       void* stream) {
  Dims d{static_cast<int>(dims[0]), static_cast<int>(dims[1]),
         static_cast<int>(dims[2]), static_cast<int>(dims[3]),
         static_cast<int>(dims[4])};
  if (d.R < 1 || d.R > 65535 || d.NL < 1 || d.P < 1 || d.n_seg < 0 ||
      d.n_t < 0 || (tangent && d.n_t < 1) || types < 0 || types > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s;
  long long* dst = reinterpret_cast<long long*>(&s);
  for (int k = 0; k < static_cast<int>(sizeof(Strides) / sizeof(long long));
       ++k)
    dst[k] = strides[k];
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (types) {
    case 0:
      return dispatch<float, float>(tangent, ptrs, d, s, c1, c2, st);
    case 1:
      return dispatch<double, double>(tangent, ptrs, d, s, c1, c2, st);
    default:
      return dispatch<float, double>(tangent, ptrs, d, s, c1, c2, st);
  }
}

}  // extern "C"
