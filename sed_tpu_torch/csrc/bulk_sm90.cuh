// Bulk copies of the Tensor Memory Accelerator (TMA) into shared memory,
// completed on an mbarrier, for Hopper (sm_90), inline PTX.
//
// One thread arms the barrier with the bytes it expects and issues the
// copies; every thread that reads the destination waits for the barrier's
// phase.  A barrier completes a phase once its arrival and all the bytes
// expected with it are in, starting at phase 0, and
// a wait for parity p returns once the phase of that parity has completed.
// Source, destination and size must be multiples of 16 bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sed {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: a barrier that completes on one arrival plus its bytes;
// make it visible with fence_mbar_init() and a __syncthreads()
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: arrive on the barrier and make its current phase wait for
// `bytes` more, then issue the bulk_copy calls that bring them; the
// caller's earlier accesses of shared memory are ordered before them
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// copy `bytes` from global `src` to shared `dst`, counted on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace sed
