// The tensor-core helpers of the bf16 kernels (K4-bf16 in conv3mxu_bf16.cu,
// K2-bf16 in stem_conv_bf16.cu): wgmma with bf16 operands and f32 sums,
// m64n64k16 with A from registers (K4-bf16) and m64n128k16 with both
// operands from shared memory by descriptor (K2-bf16).  The fences,
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
// An A operand (64 m x 16 k) in the same layout reads m where B reads n.
__device__ __forceinline__ uint64_t desc_bf16(uint32_t addr, int lbo,
                                              int sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_bf16(const void* p, int lbo,
                                              int sbo) {
  return desc_bf16(smem_u32(p), lbo, sbo);
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

// d (64 x 128, over the warpgroup) = a (64 x 16) * b (16 x 128) + (scale_d
// ? d : 0), both operands K-major in shared memory by descriptor (da, db):
// bf16 operands, f32 sum, asynchronous.  Warp w of the warpgroup holds rows
// 16w .. 16w + 15 of d; its lane (g, t), for each of the sixteen 8-wide
// n-tiles i, d[4i .. 4i + 3] = (g, 8i + 2t), (g, 8i + 2t + 1), (g + 8,
// 8i + 2t), (g + 8, 8i + 2t + 1).
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma instructions that write it asynchronously (an empty asm that
// reads and writes each register).
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
