// Device code shared by the two kernels of the nu ring's remote-copy tier:
// the ring exchange (dma_ring.cu) and the fused halo accumulation
// (dma_halo.cu).  Both run the same protocol over a peer workspace
// (spectrobot_tpu_torch/parallel/peer.py), the CUDA counterpart of the
// remote refs and DMA semaphores that Pallas gives the TPU kernels of
// benchmarks/dma_halo.py.
//
// The workspace of one shard, one cudaMalloc (its own, or a neighbour's
// mapped through CUDA IPC), for receive buffers of cap floats (a multiple
// of MIN_CHUNK) and n_flags = cap / MIN_CHUNK:
//
//   [0, 16)                     ready[2]    u64: the epoch up to which the
//                                           neighbour that this shard sends
//                                           to in direction d has freed
//                                           its destination
//   [HEADER, + 4 cap)           recv[0]     rows from the left neighbour
//   [HEADER + 4 cap, + 4 cap)   recv[1]     rows from the right neighbour
//   [HEADER + 8 cap, + 8 n_flags)  arrived[0][n_flags]  u64: per chunk c,
//                                           the epoch of the last call that
//                                           delivered it in direction d
//   [.., + 8 n_flags)           arrived[1][n_flags]
//
// Direction d = 0 moves data rightward (shard k sends to k + 1); d = 1
// leftward (to k - 1).  A table holds, per shard of the launch, the bases
// of its own workspace and of its left and right neighbours'.
//
// The protocol of one call, epoch e (the host counts calls; every shard
// sees the same e, so no flag is ever reset):
//   1. barrier:   the receiver stores e into ready[d] of the shard that
//                 sends to it (a release store): its destination is free,
//                 since its previous call on this stream has ended;
//   2. send:      the sender waits for its own ready[d] >= e (an acquire
//                 load), stores chunk c into the destination (the
//                 receiver's recv[d], or on the loopback its slot of the
//                 output), then fences and stores e into the receiver's
//                 arrived[d][c] (a release store);
//   3. receive:   the receiver waits for arrived[d][c] >= e (an acquire
//                 load) and reads chunk c (through L2: ld.global.cg).
// Each chunk has its own flag, so a receiver takes a chunk as soon as it
// has landed, while the others are still in flight.  The scope is a
// template argument: GPU_SCOPE (.gpu, __threadfence) when every shard of
// the launch is on one device (the loopback), SYS_SCOPE (.sys,
// __threadfence_system) between the cards of a ring of ranks.  No phase
// waits on a later one, and every block of the grid is resident (a
// cooperative launch), so no waiting block keeps the blocks it waits for
// from running.  Every wait is bounded: after the timeout the kernel
// traps, so a lost peer ends in a CUDA error, not a hang.

#pragma once

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int WS_HEADER = 256;          // bytes before recv[0]
constexpr int WS_READY = 0;             // u64 offset of ready[2]
constexpr int MIN_CHUNK = 1024;         // fewest floats of a copy item
constexpr int RING_THREADS = 256;
constexpr int COPY_UNROLL = 4;          // 16-byte loads in flight a thread
constexpr unsigned POLL_NS = 32;        // the sleep between two polls

enum Scope { GPU_SCOPE = 0, SYS_SCOPE = 1 };

// Per-shard entries of the table: own, left and right workspace bases.
enum { OWN = 0, LEFT = 1, RIGHT = 2 };

typedef unsigned long long u64;

// The bytes of a workspace whose receive buffers hold cap floats each.
inline long long ws_bytes(long long cap_floats) {
  return WS_HEADER + 8 * cap_floats + 16 * (cap_floats / MIN_CHUNK);
}

__device__ __forceinline__ u64* ws_ready(long long base, int d) {
  return reinterpret_cast<u64*>(base) + WS_READY + d;
}
__device__ __forceinline__ float* ws_recv(long long base, int d,
                                          long long cap_floats) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(base) + WS_HEADER) +
         d * cap_floats;
}
__device__ __forceinline__ u64* ws_arrived(long long base, int d,
                                           long long cap_floats) {
  return reinterpret_cast<u64*>(reinterpret_cast<char*>(base) + WS_HEADER +
                                8 * cap_floats) +
         d * (cap_floats / MIN_CHUNK);
}

// The neighbour a shard sends to in direction d, and the one it receives
// from (whose ready[d] it signals).
__device__ __forceinline__ long long dst_of(const long long* row, int d) {
  return row[d == 0 ? RIGHT : LEFT];
}
__device__ __forceinline__ long long src_of(const long long* row, int d) {
  return row[d == 0 ? LEFT : RIGHT];
}

template <int SCOPE>
__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  if (SCOPE == SYS_SCOPE)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <int SCOPE>
__device__ __forceinline__ void st_release(u64* p, u64 v) {
  if (SCOPE == SYS_SCOPE)
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

template <int SCOPE>
__device__ __forceinline__ void fence() {
  if (SCOPE == SYS_SCOPE)
    __threadfence_system();
  else
    __threadfence();
}

// Spin until *p >= target (the calling thread alone).  Traps after `budget`
// clock64() cycles.
template <int SCOPE>
__device__ __forceinline__ void spin_until(const u64* p, u64 target,
                                           long long budget) {
  const long long t0 = clock64();
  while (ld_acquire<SCOPE>(p) < target) {
    if (clock64() - t0 > budget) __trap();
    __nanosleep(POLL_NS);
  }
}

// Thread 0 spins until *p >= target, then the block goes on.
template <int SCOPE>
__device__ __forceinline__ void block_wait(const u64* p, u64 target,
                                           long long budget) {
  if (threadIdx.x == 0) {
    spin_until<SCOPE>(p, target, budget);
    __threadfence();
  }
  __syncthreads();
}

// The block waits until flags[0, n) are all >= target, each thread
// spinning on its share.
template <int SCOPE>
__device__ __forceinline__ void block_wait_all(const u64* flags, int n,
                                               u64 target, long long budget) {
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    spin_until<SCOPE>(flags + c, target, budget);
  __threadfence();
  __syncthreads();
}

// After the block's stores of a chunk: make them visible at SCOPE, then
// store the epoch into the chunk's arrival flag.
template <int SCOPE>
__device__ __forceinline__ void block_signal(u64* flag, u64 epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence<SCOPE>();
    st_release<SCOPE>(flag, epoch);
  }
}

// Copy floats [lo, hi) of src to dst with the block, COPY_UNROLL loads in
// flight a thread; VEC: 16-byte accesses (lo, hi and both pointers 16-byte
// aligned).  With L2, loads go through L2 only: src is a buffer that
// another device or block has just written.
template <bool VEC, bool L2>
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           long long lo, long long hi) {
  const int step = blockDim.x;
  if (VEC) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* t = reinterpret_cast<float4*>(dst);
    const long long i1 = hi / 4;
    for (long long i = lo / 4 + threadIdx.x; i < i1;
         i += COPY_UNROLL * step) {
      float4 v[COPY_UNROLL];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u)
        if (i + u * step < i1) v[u] = L2 ? __ldcg(s + i + u * step)
                                         : s[i + u * step];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u)
        if (i + u * step < i1) t[i + u * step] = v[u];
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += COPY_UNROLL * step) {
      float v[COPY_UNROLL];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u)
        if (i + u * step < hi) v[u] = L2 ? __ldcg(src + i + u * step)
                                         : src[i + u * step];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u)
        if (i + u * step < hi) dst[i + u * step] = v[u];
    }
  }
}

// Phase 1 of the protocol for every (shard, direction) pair of the launch:
// each receiver tells the shard that sends to it that its destination is
// free.
template <int SCOPE>
__device__ __forceinline__ void signal_free(const long long* table, int n_loc,
                                            int d0, int n_dirs, u64 epoch) {
  if (threadIdx.x != 0) return;
  for (int i = blockIdx.x; i < n_loc * n_dirs; i += gridDim.x) {
    const int k = i / n_dirs, d = d0 + i % n_dirs;
    st_release<SCOPE>(ws_ready(src_of(table + 3 * k, d), d), epoch);
  }
}

// Phase 2 for one item: chunk c (of `chunk` floats) of a block of n floats
// at src into dst (the same chunk of the destination), then its arrival
// flag in the receiver's workspace `to`.  The block first waits for the
// barrier of `row`'s shard in direction d, unless it has already seen it:
// `key` names the (shard, direction) pair, *ready_k the last one whose
// barrier this block has seen.
template <int SCOPE, bool VEC>
__device__ __forceinline__ void send_chunk(const long long* row, int key,
                                           int* ready_k, int d,
                                           const float* src, float* dst,
                                           long long to, long long n, int c,
                                           int chunk, long long cap_floats,
                                           u64 epoch, long long budget) {
  if (*ready_k != key) {
    block_wait<SCOPE>(ws_ready(row[OWN], d), epoch, budget);
    *ready_k = key;
  }
  const long long lo = (long long)c * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  block_copy<VEC, false>(dst, src, lo, hi);
  block_signal<SCOPE>(ws_arrived(to, d, cap_floats) + c, epoch);
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
  static Entry cache[32];
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
    if (n_cached < 32) cache[n_cached++] = {kernel, dev, threads, blocks};
  }
  return (int)(want < blocks ? (want > 0 ? want : 1) : blocks);
}

}  // namespace
