// The tensor-core helpers of the 3xTF32 kernels (K4 / K4-dx in conv3mxu.cu,
// K2 in stem_conv.cu): TF32 rounding, the async-proxy fence, and wgmma
// m64n64k8 TF32 with A from registers and B from shared memory by
// descriptor.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Round to TF32, to nearest (the MMA would truncate an unconverted operand).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// TF32 rounding by bit operations (to nearest, ties away from zero, as
// cvt.rna.tf32.f32), bit for bit the plain PyTorch version's (_tf32.py).
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy, through which wgmma reads its B operand.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed groups are pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptor of a B operand (8 k x 64 n, TF32, K-major, no swizzle) at
// `p`: core matrices of 8 n x 4 k (128 contiguous bytes: n-row r at 16 r,
// 4 k values each), the two core matrices along k 1024 bytes apart (the
// leading byte offset), the eight along n 128 bytes apart (the stride byte
// offset); offsets and the address in units of 16 bytes.  So element
// (k, n) is the float at p + k % 4 + 4 (n % 8) + 256 (k / 4) + 32 (n / 8).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3fffu) | ((uint64_t)64 << 16) |
         ((uint64_t)8 << 32);
}

// d (64 x 64, over the warpgroup) = a (64 x 8, registers) * b (8 x 64,
// shared memory) + (scale_d ? d : 0): TF32 operands, f32 sum, asynchronous.
// Warp w of the warpgroup holds rows 16w .. 16w + 15 of a and d.  Its lane
// (g, t) = (lane / 4, lane % 4) holds a elements (row g, k t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) and, for each of the eight 8-wide n-tiles i,
// d[4i .. 4i + 3] = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
