// The fused ring kernels' synchronisation between CTAs (fused_ring_fwd.cu,
// fused_ring_bwd.cu): counters in device memory, read with ld.acquire.gpu
// by one thread of the waiting CTA, written after __syncthreads and
// __threadfence by one thread of the writing CTA.  Every wait traps after
// 60 s of %globaltimer: a schedule fault ends the launch with an error, it
// does not hang the card.  Data that other CTAs rewrite during a launch
// moves through L2 only (ld.global.cg / st.global.cg), since an SM's L1
// could hold a stale line.
#pragma once

#include "common.cuh"

namespace bat {

constexpr unsigned long long kTimeoutNs = 60ull * 1000 * 1000 * 1000;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// thread 0 only: spin until *p >= need (acquire), trapping on timeout
__device__ void wait_ge(const int* p, int need) {
  if (ld_acquire(p) >= need) return;
  const unsigned long long t0 = global_ns();
  for (unsigned n = 1;; ++n) {
    __nanosleep(128);
    if (ld_acquire(p) >= need) return;
    if ((n & 1023u) == 0 && global_ns() - t0 > kTimeoutNs) __trap();
  }
}

// after every thread's stores: make them visible, then count them
__device__ __forceinline__ void publish(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1);
  }
}

// The next item of a round for this CTA of a position: its own one (j)
// when RESIDENT, else the next untaken one of the position's counter
// `taken` (thread 0 takes it, the CTA reads it after a barrier), so that
// items go out in increasing order to whichever CTA is free; n_items when
// none is left.  `slot` is a __shared__ int of the CTA.
__device__ __forceinline__ int next_item(int* taken, int* slot, int j,
                                         bool first, bool resident,
                                         int n_items) {
  if (resident) return first ? j : n_items;
  __syncthreads();  // every thread has read the previous item
  if (threadIdx.x == 0) *slot = atomicAdd(taken, 1);
  __syncthreads();
  return min(*slot, n_items);
}

// share j of G of a byte copy (16-byte units, through L2), by a CTA of NTH
// threads
template <int NTH>
__device__ __forceinline__ void copy_share(const void* src, void* dst,
                                           size_t bytes, int j, int G) {
  const size_t n16 = bytes / 16;
  const size_t lo = n16 * j / G, hi = n16 * (j + 1) / G;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (size_t i = lo + threadIdx.x; i < hi; i += NTH)
    __stcg(d + i, __ldcg(s + i));
}

}  // namespace bat
