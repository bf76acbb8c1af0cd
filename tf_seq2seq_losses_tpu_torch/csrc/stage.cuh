// Asynchronous staging helpers for the scans: Hopper's 1-D bulk copies
// (TMA without a tensor map) from global into shared memory, completing on
// an mbarrier, 4-byte cp.async for rows that are not 16-byte aligned, and
// the thread mapping of the kernels that hold a thread's lanes in
// registers.  Used by classic_fwd.cu, simplified_fwd.cu, classic_bwd_rf.cu,
// simplified_bwd_rf.cu, classic_bwd.cuh (classic_bwd.cu and
// classic_bwd_half.cu), simplified_bwd.cu, classic_log.cu, simplified_log.cu
// and fused_epilogue.cu.
//
// A bulk copy needs its global and shared addresses and its size to be
// multiples of 16 bytes; the wrappers check the base pointers, and rows of
// lpad floats (lpad a multiple of 32) keep every offset aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ctc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; then mbar_fence_init() and a __syncthreads()
// before any thread waits on the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's arrival: the phase completes once `bytes` have landed.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A plain arrival (a consumer releasing a slot to its producer).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier generic-proxy accesses of shared memory
// before its later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// An L2 policy for data read once: evicted first, so that it does not push
// out what the kernel reads again.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// The producer's side of one staged row: arrive, expecting its bytes, and
// issue the copy.
__device__ __forceinline__ void stage_row(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, src, bytes, bar, policy);
}

// 4-byte asynchronous copy (any 4-byte aligned address), waited for by the
// issuing thread with cp_async_wait_all() before a __syncthreads().
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A barrier among the first `threads` threads of the CTA (a multiple of
// 32), for a kernel whose last warp is a producer outside the step chain.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Lanes held in registers: thread t owns lanes t + j * threads for j below
// a compile-time count, at most 512 threads a CTA.
__host__ __device__ inline int lanes_per_thread(int lpad) {
  return (lpad + 511) / 512;
}

__host__ __device__ inline int strided_threads(int lpad) {
  const int lpt = lanes_per_thread(lpad);
  return ((lpad + lpt - 1) / lpt + 31) / 32 * 32;
}

}  // namespace ctc
