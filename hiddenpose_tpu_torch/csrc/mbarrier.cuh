// The mbarrier and bulk-copy (TMA) helpers of the bf16 kernels that hand
// their stages from a producer to the MMAs without a block barrier (K4-bf16
// in conv3mxu_bf16.cu, K2-bf16 in stem_conv_bf16.cu): a stage's slot has a
// full mbarrier (its data has landed) and an empty one (every reader is
// done with it).  Also the host's tensor-map encoder and K2-bf16's
// tensor-map store of its output tiles.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the mbarrier initialisations visible to the other threads (and to
// the async proxy's copies); a block barrier must follow.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The one arrival of a stage's mbarrier, which also expects `bytes` from
// the copies into its slot.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) from global src to shared dst,
// completing on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The tensor map's box at coordinates (c, w, h, plane) into shared dst,
// completing on the mbarrier; the box's voxels outside the tensor read 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int w, int h, int plane,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h),
      "r"(plane), "r"(bar)
      : "memory");
}

// Waits until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// The box of shared memory at src into the tensor map's box at coordinates
// (c, w, h, plane), in the issuing thread's current bulk group; the box's
// elements outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c,
                                          int w, int h, int plane,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(w), "r"(h), "r"(plane), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared
// memory (their sources may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until all of this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, through the runtime (no link to libcuda), looked
// up once per library (an anonymous namespace: a static in a header would
// be one symbol for every library a process loads).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
namespace {
EncodeTiled encode_tiled = nullptr;

// Sets encode_tiled on first use; a cudaError_t as an int.
inline int find_encode_tiled() {
  if (encode_tiled != nullptr) return 0;
  cudaDriverEntryPointQueryResult found;
  void* fn = nullptr;
  const int err = (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                               cudaEnableDefault, &found);
  if (err) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return (int)cudaErrorNotSupported;
  encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  return 0;
}
}  // namespace
