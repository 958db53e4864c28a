// Hopper's bulk copy from device memory to shared memory, with its
// completion counted in bytes on an mbarrier in shared memory.
//
// One thread arms the barrier with the bytes it expects and issues the
// copy; the copy engine (TMA) moves the bytes with no registers or
// instructions of the block, and every thread that needs them waits on the
// barrier's phase.  Rules: source and destination 16-byte aligned, a size
// that is a multiple of 16, at most 2^20 - 1 bytes expected per phase.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

// An mbarrier that completes a phase when ``count`` threads have arrived
// and every byte they announced has landed.  Then, before any use,
// mbar_fence_init and a block barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and announce ``bytes`` more to come on this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Announce ``bytes`` more to come on the current phase without arriving
// (the arrival comes later, from mbar_arrive).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrive once with no bytes announced: the phase completes on the
// arrivals alone (a stage whose copy was skipped keeps its phase count).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_addr(bar)) : "memory");
}

// Block until the phase of parity ``parity`` has completed (phases count
// 0, 1, 2, ... from mbar_init; the n-th use of a barrier waits on n & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copy ``bytes`` from src (global) to dst (shared); the bytes count down
// the transactions announced on ``bar``.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
