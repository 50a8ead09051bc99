// An empirical FP32 FMA ceiling of the card: a measurement kernel, not the
// port of a TPU kernel.  The counterpart of the reference bench's measured
// elementwise ceiling (bench.py:bench_roofline, K-deep chains x = x a + b
// that XLA fused into one kernel); in eager PyTorch each `x * a + b` is a
// pass over memory, so the chain lives in registers here instead.
//
//   out[i] = f^K(x[i]),   f(v) = fmaf(v, a, b),   K = depth
//
// What bounds it: FP32 FMA issue on the CUDA cores once K is deep enough
// (2 K flops for 8 bytes an element: K = 256 is 64 flops a byte, above the
// H100's 20 flops a byte of FP32 over HBM; K = 64 is 16, near the line).
//
// What the design does about it: each thread loads one float4 and runs
// its four elements' chains side by side (four independent FMAs in flight
// a thread, which with many resident warps covers the FMA latency); K is a
// template argument, so the chain is unrolled and nothing but the FMAs
// and one load and store an element remain.  a and b are arguments: the
// compiler cannot fold the chain.
//
// Build and binding as csrc/opacity_batch.cu (nvcc sm_90a, plain C
// interface, ctypes: spectrobot_tpu_torch/ops/cuda_fma.py).

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;

// grid-stride over n4 float4 elements of x and out.
template <int K>
__global__ void __launch_bounds__(THREADS)
    fma_chain_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                     float a, float b, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * THREADS) {
    float4 v = x[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v.x = fmaf(v.x, a, b);
      v.y = fmaf(v.y, a, b);
      v.z = fmaf(v.z, a, b);
      v.w = fmaf(v.w, a, b);
    }
    out[i] = v;
  }
}

template <int K>
cudaError_t launch(const float* x, float* out, float a, float b,
                   long long n, cudaStream_t s) {
  long long n4 = n / 4;
  long long blocks = (n4 + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  fma_chain_kernel<K><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), a,
      b, n4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fma_peak_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` of `device` and returns the CUDA error of the
// launch (0 = launched).  x and out hold n floats, n a positive multiple of
// 4, both 16-byte aligned; depth is 8, 64 or 256.
int fma_peak_launch(int device, const float* x, float* out, float a,
                    float b, long long n, int depth, void* stream) {
  if (n <= 0 || n % 4 != 0 ||
      reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 8:
      return static_cast<int>(launch<8>(x, out, a, b, n, s));
    case 64:
      return static_cast<int>(launch<64>(x, out, a, b, n, s));
    case 256:
      return static_cast<int>(launch<256>(x, out, a, b, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
