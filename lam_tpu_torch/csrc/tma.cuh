// The Hopper pieces of the walks fed by TMA bulk copies, shared by
// csrc/gemv_dense.cu (dense_stream) and csrc/strip_walk.cuh (strip_pass1):
// mbarriers, the L2 policies of the copies, the 1-D bulk copy itself and
// the card's SM count, read once for each device.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;  // of the per-device caches

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Adds `bytes` to the transactions the phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// L2 policies of the copies: a matrix is read once (evict first), the
// operand vector by every block (evict last).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory; completes
// its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "l"(policy)
      : "memory");
}

// The card's SM count, read once for each device.
int sm_count(int dev, int* sms) {
  static int cached[MAX_DEVICES];
  if (dev >= 0 && dev < MAX_DEVICES && cached[dev]) {
    *sms = cached[dev];
    return (int)cudaSuccess;
  }
  const cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) cached[dev] = *sms;
  return (int)e;
}

// The current device and its SM count; with `kernel` and `smem` given,
// also allows that kernel `smem` bytes of dynamic shared memory (above
// 48 KB only after opting in), once for each device through `sized`.
template <class Kernel>
int device_and_sms(Kernel kernel, size_t smem, bool* sized, int* dev,
                   int* sms) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  const int se = sm_count(*dev, sms);
  if (se != (int)cudaSuccess) return se;
  if (*dev < 0 || *dev >= MAX_DEVICES || !sized[*dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (*dev >= 0 && *dev < MAX_DEVICES) sized[*dev] = true;
  }
  return (int)cudaSuccess;
}

}  // namespace
