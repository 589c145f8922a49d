// The grid-wide barrier of a cooperative launch, and the device clock by
// which it and wgmma.cuh's timed mbarrier wait give up: a wait longer than
// TIMEOUT_NS (a block that skipped a barrier, a load that never lands)
// traps, so the launch fails with an error instead of hanging the card.
#pragma once

#include <cuda_runtime.h>

namespace gsync {

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr unsigned long long TIMEOUT_NS = 20ull * 1000 * 1000 * 1000;

// Every block of the launch co-resident: bar[0] counts arrivals, bar[1] is
// the generation.  The generation is read before arriving, so the last
// block's increment cannot be missed; the fences publish each block's
// writes before the arrival and order the reads after it.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = now_ns();
      while (*gen == g) {
        __nanosleep(64);
        if (now_ns() - t0 > TIMEOUT_NS) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace gsync
