// K7: the VJP of K3 (phase_pool.cu), MaxPool3d(3, stride 2, padding 1) on an
// NDHWC volume, with the tie rule of the separable maximum chain.
//
// Replaces hiddenpose_tpu/ops/pallas/phase_pool.py::phase_maxpool_vjp_pallas
// (body _phase_pool_bwd_kernel), which differentiates the s2d phase pool.
// The contract is the autodiff of the chain of
// hiddenpose_tpu/ops/space_to_depth.py::phase_maxpool_k3s2, at full
// resolution: per axis, W then H then D,
//   out[m] = max(max(t[2m], t[2m+1]), t[2m-1])      (-inf outside)
// where each max splits a tie 0.5 / 0.5 (the weights of _tie_w, wroute_row
// and hroute there).  So with u the W-stage and v the H-stage maxima,
//   dv[d, mh, mw]  = sum_md  wD * g[md, mh, mw]
//   du[d, h, mw]   = sum_mh  wH * dv[d, mh, mw]
//   dx[d, h, w]    = sum_mw  wW * du[d, h, mw]
// each sum over the one or two windows of that axis that hold the index
// (2m as the first operand; 2m+1 as the second, and as the third of window
// m+1).  The weights are products of 1, 0.5 and 0, so every product is
// exact, and a two-term sum does not depend on its order: the kernel sums
// as the chain's autodiff does and matches it bit for bit.
//
// What bounds it on the card: device memory, one read of y (1 GiB at the
// t128 stem, 2 x 128^3 x 64), a read of g (an eighth of that) and one
// write of dy (1 GiB); the recomputed maxima come from L1/L2.
// Design: the gather form, so no atomics.  One thread per input voxel and
// 4 channels (16-byte loads, neighbouring threads on neighbouring
// channels, as K3).  For each of its (at most 2 x 2 x 2) windows it
// recomputes the window's stage maxima from y and applies the chain's
// weights at every maximum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Vol {
  const float4* y;
  int D, H, W, C4;
  int64_t base;  // offset of (b, 0, 0, 0, c4) in float4s

  __device__ __forceinline__ float4 at(int d, int h, int w) const {
    if (d < 0 || d >= D || h < 0 || h >= H || w < 0 || w >= W)
      return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    return __ldg(y + base + (((int64_t)d * H + h) * W + w) * C4);
  }
};

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// The chain's value from its three operands, c = t[2m-1], a0 = t[2m],
// a1 = t[2m+1].
__device__ __forceinline__ float4 chain(float4 c, float4 a0, float4 a1) {
  return max4(max4(a0, a1), c);
}

// The gradient weight of a max's operand p against q: 1, 0.5 at a tie, 0.
__device__ __forceinline__ float tie(float p, float q) {
  return p > q ? 1.f : (p < q ? 0.f : 0.5f);
}

// Weight of operand `role` (0: c = t[2m-1], 1: a0 = t[2m], 2: a1 = t[2m+1])
// in max(max(a0, a1), c).
__device__ __forceinline__ float role_w(float c, float a0, float a1,
                                        int role) {
  const float t = fmaxf(a0, a1);
  if (role == 0) return tie(c, t);
  return tie(t, c) * (role == 1 ? tie(a0, a1) : tie(a1, a0));
}

__device__ __forceinline__ float4 role_w4(float4 c, float4 a0, float4 a1,
                                          int role) {
  return make_float4(role_w(c.x, a0.x, a1.x, role),
                     role_w(c.y, a0.y, a1.y, role),
                     role_w(c.z, a0.z, a1.z, role),
                     role_w(c.w, a0.w, a1.w, role));
}

__device__ __forceinline__ float4 fma4(float4 w, float4 g, float4 acc) {
  return make_float4(fmaf(w.x, g.x, acc.x), fmaf(w.y, g.y, acc.y),
                     fmaf(w.z, g.z, acc.z), fmaf(w.w, g.w, acc.w));
}

// The windows of one axis that hold index i (pooled extent o): window m
// with the operand role of i in it.  Returns how many (1 or 2).
__device__ __forceinline__ int windows(int i, int o, int m[2], int role[2]) {
  if (i % 2 == 0) {
    m[0] = i / 2;
    role[0] = 1;
    return 1;
  }
  m[0] = (i - 1) / 2;
  role[0] = 2;
  if (m[0] + 1 >= o) return 1;
  m[1] = m[0] + 1;
  role[1] = 0;
  return 2;
}

// W-stage maximum u(d, h, mw).
__device__ __forceinline__ float4 u_at(const Vol& v, int d, int h, int mw) {
  return chain(v.at(d, h, 2 * mw - 1), v.at(d, h, 2 * mw),
               v.at(d, h, 2 * mw + 1));
}

// H-stage maximum v(d, mh, mw).
__device__ __forceinline__ float4 v_at(const Vol& v, int d, int mh, int mw) {
  return chain(u_at(v, d, 2 * mh - 1, mw), u_at(v, d, 2 * mh, mw),
               u_at(v, d, 2 * mh + 1, mw));
}

__global__ void maxpool_k3s2p1_vjp_kernel(const float4* __restrict__ y,
                                          const float4* __restrict__ g,
                                          float4* __restrict__ dy, int B,
                                          int D, int H, int W, int C4, int OD,
                                          int OH, int OW) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)B * D * H * W * C4;
  if (idx >= total) return;
  const int c4 = (int)(idx % C4);
  int64_t r = idx / C4;
  const int w = (int)(r % W);
  r /= W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int b = (int)(r / D);

  const Vol vol{y, D, H, W, C4, (int64_t)b * D * H * W * C4 + c4};
  const float4* gb = g + (int64_t)b * OD * OH * OW * C4 + c4;

  int mds[2], rds[2], mhs[2], rhs[2], mws[2], rws[2];
  const int nd = windows(d, OD, mds, rds);
  const int nh = windows(h, OH, mhs, rhs);
  const int nw = windows(w, OW, mws, rws);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dx = zero;
  for (int iw = 0; iw < nw; ++iw) {
    const int mw = mws[iw];
    float4 du = zero;
    for (int ih = 0; ih < nh; ++ih) {
      const int mh = mhs[ih];
      float4 dv = zero;
      for (int id = 0; id < nd; ++id) {
        const int md = mds[id];
        const float4 wd = role_w4(v_at(vol, 2 * md - 1, mh, mw),
                                  v_at(vol, 2 * md, mh, mw),
                                  v_at(vol, 2 * md + 1, mh, mw), rds[id]);
        const float4 gv = __ldg(gb + (((int64_t)md * OH + mh) * OW + mw) * C4);
        dv = fma4(wd, gv, dv);
      }
      const float4 wh = role_w4(u_at(vol, d, 2 * mh - 1, mw),
                                u_at(vol, d, 2 * mh, mw),
                                u_at(vol, d, 2 * mh + 1, mw), rhs[ih]);
      du = fma4(wh, dv, du);
    }
    const float4 ww = role_w4(vol.at(d, h, 2 * mw - 1), vol.at(d, h, 2 * mw),
                              vol.at(d, h, 2 * mw + 1), rws[iw]);
    dx = fma4(ww, du, dx);
  }
  dy[idx] = dx;
}

}  // namespace

// y (B, D, H, W, C) f32 with C % 4 == 0, g (B, OD, OH, OW, C) with
// O* = (* - 1) / 2 + 1, dy (B, D, H, W, C).
extern "C" int hp_maxpool3d_k3s2p1_vjp(const float* y, const float* g,
                                       float* dy, int B, int D, int H, int W,
                                       int C, int OD, int OH, int OW,
                                       void* stream) {
  const int C4 = C / 4;
  const int64_t total = (int64_t)B * D * H * W * C4;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  maxpool_k3s2p1_vjp_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(y), reinterpret_cast<const float4*>(g),
      reinterpret_cast<float4*>(dy), B, D, H, W, C4, OD, OH, OW);
  return (int)cudaGetLastError();
}
