// Hopper's bulk asynchronous copies (the TMA's 1-D form, no tensor map)
// and the shared-memory barriers that count their bytes, shared by the
// octet SpMV (spmv_octet.cu), the stream copy (stream_copy.cu) and the
// triangular solves (trisolve_waves.cu, trisolve_fused.cu).
//
// A copy moves a contiguous run of bytes between global and shared
// memory; both addresses and the size are multiples of 16.  A global to
// shared copy reports its bytes to an mbarrier: the issuing thread arms
// the barrier with the bytes it expects (one arrival), and a waiter
// passes once they have landed.  A shared to global copy joins the
// issuing thread's bulk group, which that thread waits on before the
// shared buffer is written again.
#pragma once

#include <cstdint>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier completes a phase after `count` arrivals.
__device__ __forceinline__ void init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After every init, before any thread uses the barriers.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on `bar` and adds `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar`, no bytes.
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of `bar` whose parity is `parity` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Global to shared, `bytes` reported to `bar`.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared to global, in the issuing thread's current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until every bulk group of the thread has completed.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders the async proxy's shared-memory accesses after what this thread
// saw complete (the data a load brought in, before a store reads it).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace bulk
