// bf16 <-> f32 for the kernels that load or store bf16 (K1 through
// conv3p_tile.cuh, K3 in phase_pool.cu, K2-bf16 and K4-bf16 through
// wgmma_bf16.cuh), on raw 16-bit values: one rounding rule for all of them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The f32 value of the bf16 bits in the low half of v (exact).
__device__ __forceinline__ float bf16_widen(uint32_t v) {
  return __uint_as_float(v << 16);
}

// f32 -> bf16 bits, rounding to nearest even (torch's conversion), by one
// cvt instruction; a NaN stays a NaN.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(v));
  return r;
}

// Two f32 values as a bf16 pair, `lo` in the low half (one cvt).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
