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
// Design: one thread per window, its plane pair (n, od) from the block's
// position and its (oh, ow) from one 32-bit division of its index, so a
// thread does a handful of integer instructions (the wrapper keeps every
// index inside int32).  Neighbouring threads take neighbouring windows
// along W: each of a window's four rows is one 8-byte load (W even) and
// one 8-byte store, coalesced across the warp, and dy one 4-byte load.  At
// an odd extent the windows that end beside the last plane, row or column
// zero it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// (n, od) = (blockIdx.z, blockIdx.y); window i = oh OW + ow of that plane
// pair.  VEC: W is even and x, dx are 8-byte aligned, so every row pair of
// a window is a float2.
template <bool VEC>
__global__ void maxpool2_bwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ dy,
                                    float* __restrict__ dx, int D, int H,
                                    int W, int OD, int OH, int OW) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= OH * OW) return;
  const int od = blockIdx.y, n = blockIdx.z;
  const int oh = i / OW;
  const int ow = i - oh * OW;
  const int HW = H * W;
  const int base = ((n * D + 2 * od) * H + 2 * oh) * W + 2 * ow;
  const int row[4] = {base, base + W, base + HW, base + HW + W};

  float v[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (VEC) {
      const float2 p = __ldg(reinterpret_cast<const float2*>(x + row[r]));
      v[2 * r] = p.x;
      v[2 * r + 1] = p.y;
    } else {
      v[2 * r] = __ldg(x + row[r]);
      v[2 * r + 1] = __ldg(x + row[r] + 1);
    }
  }
  float m = v[0];
  int arg = 0;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (v[k] > m || isnan(v[k])) {
      m = v[k];
      arg = k;
    }
  }
  const float g = __ldg(dy + (n * OD + od) * OH * OW + i);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = arg == 2 * r ? g : 0.f;
    const float b = arg == 2 * r + 1 ? g : 0.f;
    if (VEC) {
      *reinterpret_cast<float2*>(dx + row[r]) = make_float2(a, b);
    } else {
      dx[row[r]] = a;
      dx[row[r] + 1] = b;
    }
  }

  // The voxels past the last window along an odd axis: extent 3 there.
  const int de = od == OD - 1 ? D - 2 * od : 2;
  const int he = oh == OH - 1 ? H - 2 * oh : 2;
  const int we = ow == OW - 1 ? W - 2 * ow : 2;
  if (de + he + we > 6) {
    for (int a = 0; a < de; ++a)
      for (int b = 0; b < he; ++b)
        for (int c = 0; c < we; ++c)
          if (a == 2 || b == 2 || c == 2) dx[base + a * HW + b * W + c] = 0.f;
  }
}

}  // namespace

// x (N, D, H, W) with N = B * C, dy (N, OD, OH, OW) with O* = * / 2, all
// at least 1, dx (N, D, H, W); N * D * H * W < 2^31, N and OD < 2^16.
extern "C" int hp_maxpool2_bwd(const float* x, const float* dy, float* dx,
                               int N, int D, int H, int W, int OD, int OH,
                               int OW, void* stream) {
  const int windows = OH * OW;
  const int threads = windows < 256 ? (windows + 31) / 32 * 32 : 256;
  const dim3 grid((windows + threads - 1) / threads, OD, N);
  const bool vec =
      W % 2 == 0 && (uintptr_t)x % 8 == 0 && (uintptr_t)dx % 8 == 0;
  auto kernel = vec ? maxpool2_bwd_kernel<true> : maxpool2_bwd_kernel<false>;
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(x, dy, dx, D, H, W, OD,
                                                     OH, OW);
  return (int)cudaGetLastError();
}
