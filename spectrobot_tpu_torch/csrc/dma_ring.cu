// Ring exchange over peer memory: the CUDA port of the TPU kernel
// benchmarks/dma_halo.py:_ring_kernel (a device-initiated remote copy of
// each shard's block to its neighbour on a 1-D nu ring, with send and
// receive semaphores).
//
//   out[k] = x[k - direction]   (k over the shards of the ring, mod n)
//
// Each shard stores its block into the recv[d] buffer of the neighbour at
// `direction` (d = 0 for +1, 1 for -1), then waits for its own block from
// the other side and copies it into its output: a roll of the blocks over
// the shards, bit-exact.  The protocol (barrier, release, acquire, bounded
// waits) is csrc/peer_ring.cuh's.  One launch covers every shard this
// process holds: one on a ring of ranks (its neighbours' workspaces mapped
// through CUDA IPC), all n on the loopback ring of one device.
//
// What bounds it: bytes.  Each block is read once and written twice (into
// the peer's buffer, then from the own buffer into the output) and read
// once more; over NVLink the peer stores run at the link's 450 GB/s each
// way, on one card at the 3.35 TB/s of device memory.  The design: 32 KB
// chunks (the host's CHUNK_FLOATS, parallel/peer.py) as work items of a
// persistent, cooperative grid, 16-byte accesses where the block allows
// them, loads of the received buffer through L2.
//
// This file also holds the workspace's host functions (cudaMalloc, CUDA
// IPC), called by spectrobot_tpu_torch/parallel/peer.py through ctypes.
// Build: nvcc sm_90a, plain C interface (kernels/build.py).

#include <cuda_runtime.h>

#include "peer_ring.cuh"

namespace {

// table [n_loc, 3]: workspace bases per shard; x, out [n_loc, n] floats.
template <bool VEC>
__global__ void __launch_bounds__(RING_THREADS)
dma_ring_kernel(const long long* __restrict__ table, const float* x,
                float* out, long long n, long long cap_floats, int n_loc,
                int d, int chunk, int n_chunks, u64 epoch, u64 target,
                long long budget) {
  signal_free(table, n_loc, d, 1, epoch);
  const int items = n_loc * n_chunks;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int k = i / n_chunks;
    send_chunk<VEC>(table + 3 * k, d, x + (size_t)k * n, n, i % n_chunks,
                    chunk, cap_floats, epoch, budget);
  }
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int k = i / n_chunks, c = i % n_chunks;
    const long long own = table[3 * k + OWN];
    block_wait(ws_arrived(own, d), target, budget);
    const long long lo = (long long)c * chunk;
    const long long hi = lo + chunk < n ? lo + chunk : n;
    block_copy<VEC>(out + (size_t)k * n, ws_recv(own, d, cap_floats), lo,
                    hi);
  }
}

}  // namespace

extern "C" {

int dma_ws_header_bytes() { return WS_HEADER; }
int dma_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

const char* dma_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A zeroed workspace of `bytes` on `device` (its own allocation, so that an
// IPC handle maps exactly it).
int dma_ws_alloc(int device, long long bytes, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(out, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*out, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

int dma_ws_free(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(p);
  return (int)err;
}

int dma_ipc_get(int device, void* p, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), p);
  return (int)err;
}

int dma_ipc_open(int device, const void* handle, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(
        out, *static_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

int dma_ipc_close(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(p);
  return (int)err;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// n floats per shard, at most cap_floats; d = 0 (direction +1) or 1 (-1);
// chunk: floats per copy item (a multiple of 4); target: the receiver's
// arrival count once this call's chunks are in.
int dma_ring_launch(int device, const long long* table, const float* x,
                    float* out, long long n, long long cap_floats, int n_loc,
                    int d, int chunk, u64 epoch, u64 target, float timeout_s,
                    void* stream) {
  if (n <= 0 || n > cap_floats || n_loc < 1 || (d != 0 && d != 1) ||
      chunk < 4 || chunk % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (n + chunk - 1) / chunk;
  if (chunks * n_loc > (1ll << 30)) return (int)cudaErrorInvalidValue;
  int n_chunks = (int)chunks;
  long long budget = timeout_cycles(device, timeout_s);
  const bool vec = n % 4 == 0 && ((size_t)x % 16) == 0 &&
                   ((size_t)out % 16) == 0 && cap_floats % 4 == 0;
  void* args[] = {&table, &x, &out, &n, &cap_floats, &n_loc, &d, &chunk,
                  &n_chunks, &epoch, &target, &budget};
  void* kern = vec ? (void*)dma_ring_kernel<true>
                   : (void*)dma_ring_kernel<false>;
  const int grid = resident_blocks(kern, device, RING_THREADS,
                                   chunks * n_loc);
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(RING_THREADS),
                                    args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
