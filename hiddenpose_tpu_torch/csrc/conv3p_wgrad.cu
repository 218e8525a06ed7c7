// K6: the kernel and bias gradients of K1 (conv3p.cu).
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes_wgrad (kernel
// bodies _conv3p_wgrad_kernel / _conv3p_wgrad_kernel_db).  Contract, with
// x (B, C_in, D, H, W), dz (B, C_out, D, H, W) = dL/d(pre-activation):
//   dk[t, ci, co] = sum over b and voxels o of pad(x)[b, ci, o + t - 1]
//                   * dz[b, co, o]                     (3, 3, 3, C_in, C_out)
//   db[co]        = sum over b and o of dz[b, co, o]
// where pad is zero or edge (replicate).  The TPU kernel takes
// C_in * C_out <= 32 and leaves wider convs to XLA; this one takes any.
//
// What bounds it on the card: a reduction of 27 * C_in * C_out (+ C_out)
// outputs over B * D * H * W voxel samples (4.2 M at 128^3, batch 2): at
// the path's 1-64 channels the operands are read once and each output is
// a long dot product, so it is bound by the loads feeding the FMAs.
// Design: two passes, both in a fixed order, so a result repeats exactly
// from run to run (no float atomics).
//   1. Voxel tiles of 4 (D) x 8 (H) x 32 (W) are dealt out in contiguous
//      runs, one run to each of `chunks` block columns.  A block owns one
//      input channel and 8 output channels; per tile it stages the
//      6 x 10 x 34 halo of x (padding applied) and the 8 dz tiles in
//      shared memory, and each of 27 * 8 threads keeps one tap's running
//      sum in a register (8 more threads sum dz for db).  It writes one
//      partial row per output.
//   2. One thread per output sums its `chunks` partials in chunk order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 4;
constexpr int TH = 8;
constexpr int TW = 32;
constexpr int TV = TD * TH * TW;        // voxels per tile
constexpr int XD = TD + 2;
constexpr int XH = TH + 2;
constexpr int XW = TW + 2;
constexpr int CO_G = 8;                 // output channels per block
constexpr int ZS = TV + 1;              // padded dz row: no bank conflicts
constexpr int NTHREADS = 256;           // >= 27 * CO_G + CO_G

__global__ void __launch_bounds__(NTHREADS)
conv3p_wgrad_partial(const float* __restrict__ x,
                     const float* __restrict__ dz, float* __restrict__ partial,
                     int B, int cin, int cout, int D, int H, int W, int edge,
                     int chunks) {
  __shared__ float xs[XD][XH][XW];
  __shared__ float zs[CO_G][ZS];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int ci = blockIdx.y;
  const int co0 = blockIdx.z * CO_G;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  const int64_t ntiles = (int64_t)B * tiles_d * tiles_h * tiles_w;
  const int64_t t_begin = ntiles * chunk / chunks;
  const int64_t t_end = ntiles * (chunk + 1) / chunks;
  const int64_t plane = (int64_t)H * W;
  const int64_t rows = 27LL * cin * cout + cout;

  // Role: a tap sum (tid < 27 * CO_G), a bias sum, or idle.
  const bool is_tap = tid < 27 * CO_G;
  const int j = is_tap ? tid / 27 : tid - 27 * CO_G;
  const int t = is_tap ? tid % 27 : 0;
  const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
  const bool active = co0 + j < cout &&
                      (is_tap || (j < CO_G && ci == 0));

  float acc = 0.f;
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    int64_t r = tile;
    const int wt = (int)(r % tiles_w);
    r /= tiles_w;
    const int ht = (int)(r % tiles_h);
    r /= tiles_h;
    const int dt = (int)(r % tiles_d);
    const int b = (int)(r / tiles_d);
    const int d0 = dt * TD, h0 = ht * TH, w0 = wt * TW;

    const float* xc = x + ((int64_t)b * cin + ci) * D * plane;
    for (int i = tid; i < XD * XH * XW; i += NTHREADS) {
      const int zd = i / (XH * XW);
      const int rr = i - zd * (XH * XW);
      const int yy = rr / XW;
      const int xx = rr - yy * XW;
      int gd = d0 - 1 + zd, gh = h0 - 1 + yy, gw = w0 - 1 + xx;
      bool inside = gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 &&
                    gw < W;
      if (edge) {
        gd = min(max(gd, 0), D - 1);
        gh = min(max(gh, 0), H - 1);
        gw = min(max(gw, 0), W - 1);
        inside = true;
      }
      xs[zd][yy][xx] = inside ? xc[gd * plane + (int64_t)gh * W + gw] : 0.f;
    }
    for (int i = tid; i < CO_G * TV; i += NTHREADS) {
      const int jj = i / TV;
      const int v = i - jj * TV;
      const int vd = v / (TH * TW);
      const int vh = (v / TW) % TH;
      const int vw = v % TW;
      const int co = co0 + jj;
      const int gd = d0 + vd, gh = h0 + vh, gw = w0 + vw;
      zs[jj][v] = (co < cout && gd < D && gh < H && gw < W)
                      ? dz[(((int64_t)b * cout + co) * D + gd) * plane +
                           (int64_t)gh * W + gw]
                      : 0.f;
    }
    __syncthreads();
    if (active && is_tap) {
      for (int vd = 0; vd < TD; ++vd) {
        for (int vh = 0; vh < TH; ++vh) {
          const float* xrow = &xs[vd + kd][vh + kh][kw];
          const float* zrow = &zs[j][(vd * TH + vh) * TW];
#pragma unroll 8
          for (int vw = 0; vw < TW; ++vw) acc = fmaf(xrow[vw], zrow[vw], acc);
        }
      }
    } else if (active) {
      for (int v = 0; v < TV; ++v) acc += zs[j][v];
    }
    __syncthreads();
  }

  if (!active) return;
  const int co = co0 + j;
  const int64_t out = is_tap ? ((int64_t)t * cin + ci) * cout + co
                             : 27LL * cin * cout + co;
  partial[(int64_t)chunk * rows + out] = acc;
}

__global__ void conv3p_wgrad_reduce(const float* __restrict__ partial,
                                    float* __restrict__ dk,
                                    float* __restrict__ db, int64_t n_dk,
                                    int64_t rows, int chunks) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * rows + r];
  if (r < n_dk) {
    dk[r] = s;
  } else if (db) {
    db[r - n_dk] = s;
  }
}

}  // namespace

// x (B, C_in, D, H, W), dz (B, C_out, D, H, W); partial: scratch of
// chunks * (27 * C_in * C_out + C_out) floats; dk (3, 3, 3, C_in, C_out);
// db (C_out,) or null.  pad_mode 0 zero, 1 edge.
extern "C" int hp_conv3p_wgrad(const float* x, const float* dz,
                               float* partial, float* dk, float* db, int B,
                               int cin, int cout, int D, int H, int W,
                               int pad_mode, int chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(chunks, cin, (cout + CO_G - 1) / CO_G);
  conv3p_wgrad_partial<<<grid, NTHREADS, 0, s>>>(
      x, dz, partial, B, cin, cout, D, H, W, pad_mode, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_dk = 27LL * cin * cout;
  const int64_t rows = n_dk + cout;
  const int threads = 256;
  conv3p_wgrad_reduce<<<(unsigned)((rows + threads - 1) / threads), threads,
                        0, s>>>(partial, dk, db, n_dk, rows, chunks);
  return (int)cudaGetLastError();
}
