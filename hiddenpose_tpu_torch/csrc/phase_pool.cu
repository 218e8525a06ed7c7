// K3: MaxPool3d(kernel 3, stride 2, padding 1) on an NDHWC volume.
//
// Replaces hiddenpose_tpu/ops/pallas/phase_pool.py::phase_maxpool_pallas
// (body _phase_pool_fwd_kernel), which pools the stem output in its
// space-to-depth phase layout.  Here the stem writes full-resolution NDHWC,
// so the pool reads that directly.  Padded positions never win: the running
// max starts at -inf and out-of-volume taps are skipped, the same result as
// the TPU kernel's float32-min padding (phase_pool.py NEG).
//
// What bounds it on the card: 27 compares per 4 bytes read, so device
// memory bandwidth (one full read of the stem output, an eighth of it
// written).  Design: one thread per output voxel and 4 channels, 16-byte
// loads with neighbouring threads on neighbouring channels and voxels so
// each warp reads whole cache lines; the 27-tap overlap between
// neighbouring windows (each input is read by up to 8 windows) is served
// from L1/L2.
//
// The bf16 form (the stem output of the bfloat16 model) reads 8 channels a
// 16-byte load, half the bytes, takes the maximum in f32 (exact: a bf16
// value widens without rounding) and stores the maximum, which is one of
// the inputs, back unrounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

__global__ void maxpool_k3s2p1_kernel(const float4* __restrict__ x,
                                      float4* __restrict__ out, int B, int D,
                                      int H, int W, int C4, int OD, int OH,
                                      int OW) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * OD * OH * OW * C4;
  if (idx >= total) return;
  const int c4 = (int)(idx % C4);
  int64_t r = idx / C4;
  const int ow = (int)(r % OW);
  r /= OW;
  const int oh = (int)(r % OH);
  r /= OH;
  const int od = (int)(r % OD);
  const int b = (int)(r / OD);

  float4 m = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  for (int kd = 0; kd < 3; ++kd) {
    const int id = 2 * od - 1 + kd;
    if (id < 0 || id >= D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = 2 * oh - 1 + kh;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = 2 * ow - 1 + kw;
        if (iw < 0 || iw >= W) continue;
        const float4 v =
            __ldg(x + (((int64_t)(b * D + id) * H + ih) * W + iw) * C4 + c4);
        m.x = fmaxf(m.x, v.x);
        m.y = fmaxf(m.y, v.y);
        m.z = fmaxf(m.z, v.z);
        m.w = fmaxf(m.w, v.w);
      }
    }
  }
  out[idx] = m;
}

// One thread per output voxel and 8 channels (one uint4 of bf16 pairs).
__global__ void maxpool_k3s2p1_bf16_kernel(const uint4* __restrict__ x,
                                           uint4* __restrict__ out, int B,
                                           int D, int H, int W, int C8,
                                           int OD, int OH, int OW) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * OD * OH * OW * C8;
  if (idx >= total) return;
  const int c8 = (int)(idx % C8);
  int64_t r = idx / C8;
  const int ow = (int)(r % OW);
  r /= OW;
  const int oh = (int)(r % OH);
  r /= OH;
  const int od = (int)(r % OD);
  const int b = (int)(r / OD);

  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
  for (int kd = 0; kd < 3; ++kd) {
    const int id = 2 * od - 1 + kd;
    if (id < 0 || id >= D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = 2 * oh - 1 + kh;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = 2 * ow - 1 + kw;
        if (iw < 0 || iw >= W) continue;
        const uint4 v =
            __ldg(x + (((int64_t)(b * D + id) * H + ih) * W + iw) * C8 + c8);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m[2 * q] = fmaxf(m[2 * q], bf16_widen(w[q] & 0xffffu));
          m[2 * q + 1] = fmaxf(m[2 * q + 1], bf16_widen(w[q] >> 16));
        }
      }
    }
  }
  // each maximum is one of the inputs: the conversion back is exact
  out[idx] = make_uint4(bf16_pair(m[0], m[1]), bf16_pair(m[2], m[3]),
                        bf16_pair(m[4], m[5]), bf16_pair(m[6], m[7]));
}

}  // namespace

// x (B, D, H, W, C) bf16 with C % 8 == 0, 16-byte aligned, out (B, OD,
// OH, OW, C) bf16.
extern "C" int hp_maxpool3d_k3s2p1_bf16(const void* x, void* out, int B,
                                        int D, int H, int W, int C, int OD,
                                        int OH, int OW, void* stream) {
  const int C8 = C / 8;
  const int64_t total = (int64_t)B * OD * OH * OW * C8;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  maxpool_k3s2p1_bf16_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(x), reinterpret_cast<uint4*>(out), B, D,
      H, W, C8, OD, OH, OW);
  return (int)cudaGetLastError();
}

// x (B, D, H, W, C) f32 with C % 4 == 0, out (B, OD, OH, OW, C) with
// O* = (* - 1) / 2 + 1.
extern "C" int hp_maxpool3d_k3s2p1(const float* x, float* out, int B, int D,
                                   int H, int W, int C, int OD, int OH, int OW,
                                   void* stream) {
  const int C4 = C / 4;
  const int64_t total = (int64_t)B * OD * OH * OW * C4;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  maxpool_k3s2p1_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), B,
      D, H, W, C4, OD, OH, OW);
  return (int)cudaGetLastError();
}
