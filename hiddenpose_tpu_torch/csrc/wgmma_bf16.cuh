// The tensor-core helpers of the bf16 kernels (K4-bf16 in conv3mxu_bf16.cu,
// K2-bf16 in stem_conv_bf16.cu): wgmma m64n64k16 with bf16 operands, A from
// registers and B from shared memory by descriptor, f32 sums.  The fences,
// commit and wait are those of wgmma_tf32.cuh, the bf16 conversions those
// of bf16.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "wgmma_tf32.cuh"

// The descriptor of an unswizzled K-major bf16 operand at `p`: core
// matrices of 8 rows x 8 k (128 contiguous bytes: row r at 16 r, its 8 k
// values), `lbo` bytes between the core matrices along k, `sbo` between
// those along n; offsets and the address in units of 16 bytes.  So element
// (k, n) is at byte 2 (k % 8) + 16 (n % 8) + lbo (k / 8) + sbo (n / 8).
__device__ __forceinline__ uint64_t desc_bf16(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3fffu) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 64, over the warpgroup) = a (64 x 16, registers) * b (16 x 64,
// shared memory) + (scale_d ? d : 0): bf16 operands, f32 sum, asynchronous.
// Warp w of the warpgroup holds rows 16w .. 16w + 15 of a and d.  Its lane
// (g, t) = (lane / 4, lane % 4) holds the bf16 pairs of a (low half the
// lower k) a[0] = (row g, k 2t, 2t + 1), a[1] = (g + 8, 2t..), a[2] = (g,
// 2t + 8..), a[3] = (g + 8, 2t + 8..) and, for each of the eight 8-wide
// n-tiles i, d[4i .. 4i + 3] = (g, 8i + 2t), (g, 8i + 2t + 1),
// (g + 8, 8i + 2t), (g + 8, 8i + 2t + 1).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
