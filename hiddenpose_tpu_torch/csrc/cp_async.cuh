// Asynchronous copies from global to shared memory (cp.async), shared by
// the stencil kernels (conv3p_tile.cuh: K1, K1-bf16 and K5;
// conv3p_wgrad.cu: K6) and the bf16 stem (stem_conv_bf16.cu).
// A copy with `copy` false writes zeros and reads nothing, but `src` must
// still be an address inside the tensor.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 4 bytes, or 4 zero bytes.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool copy) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(copy ? 4 : 0)
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned), or 16 zero bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool copy) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

// The same, to a shared-memory address as `__cvta_generic_to_shared` gives.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool copy) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(copy ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
