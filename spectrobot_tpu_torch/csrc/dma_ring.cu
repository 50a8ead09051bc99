// Ring exchange over peer memory: the CUDA port of the TPU kernel
// benchmarks/dma_halo.py:_ring_kernel (a device-initiated remote copy of
// each shard's block to its neighbour on a 1-D nu ring, with send and
// receive semaphores).
//
//   out[k] = x[k - direction]   (k over the shards of the ring, mod n)
//
// Bit-exact: a roll of the blocks over the shards.  The protocol (barrier,
// per-chunk release and acquire, bounded waits) is csrc/peer_ring.cuh's.
// One launch covers every shard this process holds: one on a ring of
// ranks (its neighbours' workspaces mapped through CUDA IPC), all n on the
// loopback ring of one device.
//
// What bounds it: bytes.  Each block read once and written once is the
// least; over NVLink the peer stores run at the link's 450 GB/s each way,
// on one card at the 3.35 TB/s of device memory.  At the sizes of a halo
// (a few hundred KB) the launch and the host's issue of it bound it.
//
// What the design does about it:
//  * On the loopback every shard's output is this launch's: each shard
//    stores its block straight into its receiver's slot of `out` (read
//    once, written once, the TPU kernel's traffic), with the protocol at
//    device scope (.gpu release and acquire, __threadfence).  The barrier
//    and a release store per chunk remain, and each receiver acquires all
//    of its chunk flags before the kernel ends: the one-card rehearsal of
//    the protocol.
//  * Between ranks the output is not addressable from the peer (a new
//    tensor each call), so a chunk lands in the receiver's recv buffer and
//    is copied out.  Each chunk has its own arrival flag and each item is
//    (send chunk c, then receive chunk c): the receiver copies a chunk out
//    as soon as it has landed, while the NVLink stores of the others are
//    in flight.  System scope (.sys, __threadfence_system).
//  * Items of a few KB (the host's chunk size, MIN_CHUNK up to
//    CHUNK_FLOATS, so that a small block still spreads over the SMs), 256
//    threads a block with COPY_UNROLL 16-byte loads in flight a thread, a
//    persistent cooperative grid, and a short poll (POLL_NS).
//  * The host passes one argument struct that the workspace keeps between
//    calls (parallel/peer.py: RingArgs): the wrapper sets the pointers,
//    the epoch and the stream, and makes one ctypes call.
//
// This file also holds the workspace's host functions (cudaMalloc, CUDA
// IPC), called by spectrobot_tpu_torch/parallel/peer.py through ctypes.
// Build: nvcc sm_90a, plain C interface (kernels/build.py).

#include <cuda_runtime.h>

#include "peer_ring.cuh"

// One call, as the host passes it (parallel/peer.py: RingArgs, the same
// layout): table [n_loc, 3] of workspace bases; x, out [n_loc, n] floats;
// d = 0 (direction +1) or 1 (-1); chunk: floats per copy item; loopback:
// every shard of the ring is in this launch, on this device.
struct RingArgs {
  const long long* table;
  const float* x;
  float* out;
  long long n;
  long long cap_floats;
  unsigned long long epoch;
  int n_loc;
  int d;
  int chunk;
  int device;
  int loopback;
  float timeout_s;
  void* stream;
};

namespace {

// TWO_PASS: through the receivers' recv buffers (a ring of ranks); else
// straight into the receivers' slots of out (the loopback).
template <int SCOPE, bool TWO_PASS, bool VEC>
__global__ void __launch_bounds__(RING_THREADS)
dma_ring_kernel(RingArgs a, int n_chunks, long long budget) {
  signal_free<SCOPE>(a.table, a.n_loc, a.d, 1, a.epoch);
  const int items = a.n_loc * n_chunks;
  // A receive right after its send waits only on lower items when each
  // shard receives from another process (n_loc = 1); with several shards
  // here, every send comes first.
  const bool interleave = TWO_PASS && a.n_loc == 1;
  const int shift = a.d == 0 ? 1 : a.n_loc - 1;
  int ready_k = -1;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int k = i / n_chunks, c = i % n_chunks;
    const long long* row = a.table + 3 * k;
    const long long to = dst_of(row, a.d);
    float* dst = TWO_PASS ? ws_recv(to, a.d, a.cap_floats)
                          : a.out + (size_t)((k + shift) % a.n_loc) * a.n;
    send_chunk<SCOPE, VEC>(row, k, &ready_k, a.d, a.x + (size_t)k * a.n,
                           dst, to, a.n, c, a.chunk, a.cap_floats, a.epoch,
                           budget);
    if (interleave) {
      const long long own = row[OWN];
      const long long lo = (long long)c * a.chunk;
      const long long hi = lo + a.chunk < a.n ? lo + a.chunk : a.n;
      block_wait<SCOPE>(ws_arrived(own, a.d, a.cap_floats) + c, a.epoch,
                        budget);
      block_copy<VEC, true>(a.out + (size_t)k * a.n,
                            ws_recv(own, a.d, a.cap_floats), lo, hi);
    }
  }
  if (TWO_PASS && !interleave) {
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int k = i / n_chunks, c = i % n_chunks;
      const long long own = a.table[3 * k + OWN];
      const long long lo = (long long)c * a.chunk;
      const long long hi = lo + a.chunk < a.n ? lo + a.chunk : a.n;
      block_wait<SCOPE>(ws_arrived(own, a.d, a.cap_floats) + c, a.epoch,
                        budget);
      block_copy<VEC, true>(a.out + (size_t)k * a.n,
                            ws_recv(own, a.d, a.cap_floats), lo, hi);
    }
  } else if (!TWO_PASS && blockIdx.x < a.n_loc) {
    // The receive side on the loopback: shard blockIdx.x acquires every
    // chunk of its block.
    const long long own = a.table[3 * blockIdx.x + OWN];
    block_wait_all<SCOPE>(ws_arrived(own, a.d, a.cap_floats), n_chunks,
                          a.epoch, budget);
  }
}

// The kernel of a call: on the loopback one pass at device scope, between
// ranks two passes at system scope.
template <bool VEC>
void* ring_kernel(const RingArgs* a) {
  return a->loopback ? (void*)dma_ring_kernel<GPU_SCOPE, false, VEC>
                     : (void*)dma_ring_kernel<SYS_SCOPE, true, VEC>;
}

}  // namespace

extern "C" {

long long dma_ws_bytes(long long cap_floats) { return ws_bytes(cap_floats); }
int dma_min_chunk() { return MIN_CHUNK; }
int dma_ring_args_bytes() { return (int)sizeof(RingArgs); }
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

// Launches call `a` on its stream and returns the CUDA error of the launch
// (0 = launched).  n floats per shard, at most cap_floats; chunk: floats
// per copy item, a multiple of 4 and at least MIN_CHUNK; on the loopback
// the grid may be made of at most the ring's shards (n_loc), else of one.
int dma_ring_launch(const RingArgs* a) {
  if (a->n <= 0 || a->n > a->cap_floats || a->n_loc < 1 ||
      (a->d != 0 && a->d != 1) || a->chunk < MIN_CHUNK ||
      a->chunk % 4 != 0 || a->cap_floats % MIN_CHUNK != 0 ||
      (!a->loopback && a->n_loc != 1))
    return (int)cudaErrorInvalidValue;
  const long long chunks = (a->n + a->chunk - 1) / a->chunk;
  if (chunks * a->n_loc > (1ll << 30)) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int n_chunks = (int)chunks;
  long long budget = timeout_cycles(a->device, a->timeout_s);
  const bool vec = a->n % 4 == 0 && ((size_t)a->x % 16) == 0 &&
                   ((size_t)a->out % 16) == 0;
  RingArgs args = *a;
  void* params[] = {&args, &n_chunks, &budget};
  void* kern = vec ? ring_kernel<true>(a) : ring_kernel<false>(a);
  const int grid = resident_blocks(kern, a->device, RING_THREADS,
                                   chunks * a->n_loc);
  cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(grid), dim3(RING_THREADS), params, 0,
      static_cast<cudaStream_t>(a->stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
