// Device code shared by the two kernels of the nu ring's remote-copy tier:
// the ring exchange (dma_ring.cu) and the fused halo accumulation
// (dma_halo.cu).  Both run the same protocol over a peer workspace
// (spectrobot_tpu_torch/parallel/peer.py), the CUDA counterpart of the
// remote refs and DMA semaphores that Pallas gives the TPU kernels of
// benchmarks/dma_halo.py.
//
// The workspace of one shard, one cudaMalloc (its own, or a neighbour's
// mapped through CUDA IPC):
//
//   [0, 16)                 ready[2]    u64: the epoch up to which the
//                                       neighbour that this shard sends to
//                                       in direction d has freed its buffer
//   [128, 144)              arrived[2]  u64: chunks received in direction d,
//                                       counted over every call
//   [HEADER, + cap)         recv[0]     rows from the left neighbour
//   [HEADER + cap, + cap)   recv[1]     rows from the right neighbour
//
// Direction d = 0 moves data rightward (shard k sends to k + 1, into its
// recv[0]); d = 1 leftward (to k - 1, into its recv[1]).  A table holds,
// per shard of the launch, the bases of its own workspace and of its left
// and right neighbours'.
//
// The protocol of one call, epoch e (the host counts calls; every shard
// sees the same e, so the flags are never reset):
//   1. barrier:   the receiver stores e into ready[d] of the shard that
//                 sends to it (st.release.sys): its recv[d] is free, since
//                 the previous call on its stream has ended;
//   2. send:      the sender waits for its own ready[d] >= e (ld.acquire.sys),
//                 stores a chunk into the receiver's recv[d], then
//                 __threadfence_system() and a release add of 1 to the
//                 receiver's arrived[d];
//   3. receive:   the receiver waits for arrived[d] >= target (the host's
//                 running count of chunks), acquires, and reads recv[d]
//                 through L2 (ld.global.cg).
// No phase waits on a later one, and every block of the grid is resident
// (a cooperative launch), so no waiting block keeps the blocks it waits for
// from running.  Every wait is bounded: after the timeout the kernel traps,
// so a lost peer ends in a CUDA error, not a hang.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int WS_HEADER = 256;          // bytes before recv[0]
constexpr int WS_READY = 0;             // u64 offset of ready[2]
constexpr int WS_ARRIVED = 16;          // u64 offset of arrived[2] (byte 128)
constexpr int RING_THREADS = 128;

// Per-shard entries of the table: own, left and right workspace bases.
enum { OWN = 0, LEFT = 1, RIGHT = 2 };

typedef unsigned long long u64;

__device__ __forceinline__ u64* ws_ready(long long base, int d) {
  return reinterpret_cast<u64*>(base) + WS_READY + d;
}
__device__ __forceinline__ u64* ws_arrived(long long base, int d) {
  return reinterpret_cast<u64*>(base) + WS_ARRIVED + d;
}
__device__ __forceinline__ float* ws_recv(long long base, int d,
                                          long long cap_floats) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(base) + WS_HEADER) +
         d * cap_floats;
}

// The neighbour a shard sends to in direction d, and the one it receives
// from (whose ready[d] it signals).
__device__ __forceinline__ long long dst_of(const long long* row, int d) {
  return row[d == 0 ? RIGHT : LEFT];
}
__device__ __forceinline__ long long src_of(const long long* row, int d) {
  return row[d == 0 ? LEFT : RIGHT];
}

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void add_release_sys(u64* p, u64 v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Thread 0 spins until *p >= target, then the block goes on.  Traps after
// `budget` clock64() cycles.
__device__ __forceinline__ void block_wait(const u64* p, u64 target,
                                           long long budget) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire_sys(p) < target) {
      if (clock64() - t0 > budget) __trap();
      __nanosleep(128);
    }
    __threadfence();
  }
  __syncthreads();
}

// After the block's stores into a peer's buffer: make them visible at
// system scope, then count the chunk as arrived.
__device__ __forceinline__ void block_signal_arrival(u64* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    add_release_sys(arrived, 1ull);
  }
}

// Copy floats [lo, hi) of src to dst with the block; VEC: 16-byte accesses
// (lo, hi and both pointers 16-byte aligned).  Loads go through L2 only:
// src may be a buffer that another device or block has just written.
template <bool VEC>
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           long long lo, long long hi) {
  if (VEC) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* t = reinterpret_cast<float4*>(dst);
    for (long long i = lo / 4 + threadIdx.x; i < hi / 4; i += blockDim.x)
      t[i] = __ldcg(s + i);
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      dst[i] = __ldcg(src + i);
  }
}

// Phase 1 of the protocol for every (shard, direction) pair of the launch:
// each receiver tells the shard that sends to it that recv[d] is free.
__device__ __forceinline__ void signal_free(const long long* table, int n_loc,
                                            int d0, int n_dirs, u64 epoch) {
  if (threadIdx.x != 0) return;
  for (int i = blockIdx.x; i < n_loc * n_dirs; i += gridDim.x) {
    const int k = i / n_dirs, d = d0 + i % n_dirs;
    st_release_sys(ws_ready(src_of(table + 3 * k, d), d), epoch);
  }
}

// Phase 2 for one item: chunk c (of `chunk` floats, the host's copy item)
// of shard k's block (n floats at src) into the recv[d] buffer of the shard
// it sends to.
template <bool VEC>
__device__ __forceinline__ void send_chunk(const long long* row, int d,
                                           const float* src, long long n,
                                           int c, int chunk,
                                           long long cap_floats, u64 epoch,
                                           long long budget) {
  block_wait(ws_ready(row[OWN], d), epoch, budget);
  const long long dst = dst_of(row, d);
  const long long lo = (long long)c * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  block_copy<VEC>(ws_recv(dst, d, cap_floats), src, lo, hi);
  block_signal_arrival(ws_arrived(dst, d));
}

// The host's queries of the device, made once per device (and kernel):
// they cost far more than a launch.
constexpr int MAX_DEVICES = 64;

// Cycles of the SM clock in `seconds`, at the device's clock rate.
inline long long timeout_cycles(int dev, float seconds) {
  static int khz[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (khz[dev] == 0) {
    cudaDeviceGetAttribute(&khz[dev], cudaDevAttrClockRate, dev);
    if (khz[dev] <= 0) khz[dev] = 2000000;
  }
  return (long long)((double)seconds * 1e3 * khz[dev]);
}

// Blocks of a cooperative launch of `kernel` with `threads` threads on
// device `dev`: all resident at once, at most `want`.
inline int resident_blocks(const void* kernel, int dev, int threads,
                           long long want) {
  struct Entry { const void* kernel; int dev, threads, blocks; };
  static Entry cache[16];
  static int n_cached = 0;
  int blocks = 0;
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].threads == threads)
      blocks = cache[i].blocks;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (n_cached < 16) cache[n_cached++] = {kernel, dev, threads, blocks};
  }
  return (int)(want < blocks ? (want > 0 ? want : 1) : blocks);
}

}  // namespace
