// K1: SAME 3x3x3 stride-1 convolution on channels-planes volumes
// (B, C_in, D, H, W) with a DHWIO kernel, f32 accumulation.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes (kernel bodies
// _conv3p_kernel / _conv3p_kernel_db).  Same contract:
//   out = act(conv(pad(pre(x)), k) + bias [+ residual])
//   pre(x) = [relu](x * pre_scale + pre_shift) per input channel (optional)
//   pad    = zero (torch SAME) or edge (ReplicationPad3d)
//   act    = none / relu / leaky(0.2), applied after the residual add.
//
// What bounds it on the card: at this model's 1-64 channels the stencil does
// 27 * C_in FMAs per output per C_out, far below the ratio of the H100's
// fp32 peak to its memory bandwidth (about 20 FLOP/byte by the data sheet),
// so it is bound by memory traffic.
// Design: one block owns a 32 (W) x 8 (H) tile of one output plane for up to
// 8 output channels; for each input channel it stages the 3 x 10 x 34 halo
// tile (with the pre-affine and the padding already applied) and that
// channel's 27 x 8 weights in shared memory, so every input element is read
// from device memory about 3 times (once per depth tap) instead of 27.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;      // output tile width  (threadIdx.x)
constexpr int TH = 8;       // output tile height (threadIdx.y)
constexpr int CO_BLK = 8;   // output channels per block
constexpr int SW = TW + 2;
constexpr int SH = TH + 2;
constexpr int NTHREADS = TW * TH;

__global__ void __launch_bounds__(NTHREADS)
conv3p_kernel(const float* __restrict__ x, const float* __restrict__ k,
              const float* __restrict__ bias,
              const float* __restrict__ residual,
              const float* __restrict__ pre_scale,
              const float* __restrict__ pre_shift,
              float* __restrict__ out,
              int cin, int cout, int D, int H, int W,
              int edge, int act, int pre_mode, int tiles_w) {
  __shared__ float tile[3][SH][SW];
  __shared__ float wk[27][CO_BLK];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int d = blockIdx.y;
  const int n_cog = (cout + CO_BLK - 1) / CO_BLK;
  const int b = blockIdx.z / n_cog;
  const int co0 = (blockIdx.z % n_cog) * CO_BLK;
  const int64_t plane = (int64_t)H * W;

  float acc[CO_BLK];
#pragma unroll
  for (int j = 0; j < CO_BLK; ++j) acc[j] = 0.f;

  for (int ci = 0; ci < cin; ++ci) {
    const float* xc = x + ((int64_t)b * cin + ci) * D * plane;
    float sc = 1.f, sh = 0.f;
    if (pre_mode) {
      sc = pre_scale[ci];
      sh = pre_shift[ci];
    }
    for (int i = tid; i < 3 * SH * SW; i += NTHREADS) {
      const int dz = i / (SH * SW);
      const int r = i - dz * (SH * SW);
      const int yy = r / SW;
      const int xx = r - yy * SW;
      int gd = d - 1 + dz, gh = h0 - 1 + yy, gw = w0 - 1 + xx;
      bool inside = gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 &&
                    gw < W;
      if (edge) {
        gd = min(max(gd, 0), D - 1);
        gh = min(max(gh, 0), H - 1);
        gw = min(max(gw, 0), W - 1);
        inside = true;
      }
      float v = 0.f;
      if (inside) {
        v = xc[gd * plane + (int64_t)gh * W + gw];
        if (pre_mode) {
          v = fmaf(v, sc, sh);
          if (pre_mode == 2) v = fmaxf(v, 0.f);
        }
      }
      tile[dz][yy][xx] = v;
    }
    for (int i = tid; i < 27 * CO_BLK; i += NTHREADS) {
      const int t = i / CO_BLK;
      const int j = i - t * CO_BLK;
      const int co = co0 + j;
      wk[t][j] = co < cout ? k[((int64_t)t * cin + ci) * cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float v = tile[kd][ty + kh][tx + kw];
          const int t = (kd * 3 + kh) * 3 + kw;
#pragma unroll
          for (int j = 0; j < CO_BLK; ++j) acc[j] = fmaf(v, wk[t][j], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + ty;
  const int w = w0 + tx;
  if (h >= H || w >= W) return;
#pragma unroll
  for (int j = 0; j < CO_BLK; ++j) {
    const int co = co0 + j;
    if (co >= cout) break;
    const int64_t o =
        (((int64_t)b * cout + co) * D + d) * plane + (int64_t)h * W + w;
    float v = acc[j];
    if (bias) v += bias[co];
    if (residual) v += residual[o];
    if (act == 1) {
      v = fmaxf(v, 0.f);
    } else if (act == 2) {
      v = v >= 0.f ? v : 0.2f * v;
    }
    out[o] = v;
  }
}

}  // namespace

// pad_mode: 0 zero, 1 edge.  act: 0 none, 1 relu, 2 leaky(0.2).
// pre_mode: 0 no pre-affine, 1 affine, 2 affine + relu.
// bias / residual / pre_scale / pre_shift may be null.
extern "C" int hp_conv3p_fwd(const float* x, const float* k, const float* bias,
                             const float* residual, const float* pre_scale,
                             const float* pre_shift, float* out, int B, int cin,
                             int cout, int D, int H, int W, int pad_mode,
                             int act, int pre_mode, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int n_cog = (cout + CO_BLK - 1) / CO_BLK;
  dim3 grid(tiles_w * tiles_h, D, B * n_cog);
  dim3 block(TW, TH);
  conv3p_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, k, bias, residual, pre_scale, pre_shift, out, cin, cout, D, H, W,
      pad_mode, act, pre_mode, tiles_w);
  return (int)cudaGetLastError();
}
