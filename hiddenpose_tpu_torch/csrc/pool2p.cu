// K8: the backward of MaxPool3d(2) (non-overlapping 2^3 windows) on
// channels-planes volumes (B, C, D, H, W): the UNet's pool.
//
// Replaces hiddenpose_tpu/ops/pallas/pool2p.py::pool2_bwd_planes_pallas
// (body _pool2_bwd_kernel).  Contract: dx = dy at the FIRST maximum of each
// window in (d, h, w) order and 0 elsewhere (also for voxels that no
// window covers, at odd extents), with the window maximum recomputed from
// x.  The scan is the one of PyTorch's own max_pool3d (a later element
// wins only if it is greater, or NaN), so the kernel is bit-exact against
// the autograd of F.max_pool3d, ties included.
//
// What bounds it on the card: device memory, one read of x and of dy (an
// eighth of x) and one write of dx; a few compares per element.
// Design: one thread per element of dx, neighbouring threads on
// neighbouring w, so loads and stores are coalesced; a thread re-reads its
// window's 8 values, which its 7 neighbours read too, from L1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void maxpool2_bwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ dy,
                                    float* __restrict__ dx, int N, int D,
                                    int H, int W, int OD, int OH, int OW) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)N * D * H * W;
  if (idx >= total) return;
  const int w = (int)(idx % W);
  int64_t r = idx / W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int n = (int)(r / D);
  const int od = d / 2, oh = h / 2, ow = w / 2;
  if (od >= OD || oh >= OH || ow >= OW) {
    dx[idx] = 0.f;
    return;
  }
  const float* xw = x + (((int64_t)n * D + 2 * od) * H + 2 * oh) * W + 2 * ow;
  float m = -INFINITY;
  int arg = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v =
        __ldg(xw + ((int64_t)(k >> 2) * H + ((k >> 1) & 1)) * W + (k & 1));
    if (v > m || isnan(v)) {
      m = v;
      arg = k;
    }
  }
  const int self = (d - 2 * od) * 4 + (h - 2 * oh) * 2 + (w - 2 * ow);
  dx[idx] = arg == self
                ? __ldg(dy + (((int64_t)n * OD + od) * OH + oh) * OW + ow)
                : 0.f;
}

}  // namespace

// x (N, D, H, W) with N = B * C, dy (N, OD, OH, OW) with O* = * / 2,
// dx (N, D, H, W).
extern "C" int hp_maxpool2_bwd(const float* x, const float* dy, float* dx,
                               int N, int D, int H, int W, int OD, int OH,
                               int OW, void* stream) {
  const int64_t total = (int64_t)N * D * H * W;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  maxpool2_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, dy, dx, N, D, H, W, OD, OH, OW);
  return (int)cudaGetLastError();
}
