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
// write of dy (1 GiB).
// Design: the gather form (no atomics), with every stage maximum computed
// once per block.  A block owns a TH x TW column of input voxels, CG
// float4s of channels, and a run of pooled depth windows; it walks down D
// two planes (one window) at a time.  Per step it
//   1. stores the two y planes it fetched into registers during the last
//      step, with their one-voxel halo (TH + 3 by TW + 3: the windows of
//      the tile's last odd row and column reach two further), into a ring
//      of four planes in shared memory,
//   2. starts the next step's y loads (they fly while the step computes),
//   3. computes the two planes' W-stage maxima u ((TH + 3) x (TW / 2 + 1))
//      and then their H-stage maxima v ((TH / 2 + 1) x (TW / 2 + 1)) into
//      rings,
//   4. computes dv of the two output planes from g and the five v planes of
//      the one or two depth windows, du from dv and u, and dx from du and
//      y, each stage through shared memory, a thread taking the even and
//      the odd index of a window together (they share the window's
//      operands and weights), and writes dx.
// So y is read once from device memory but for the halo (1.4 x at 16 x 16,
// most of it from L2: neighbouring tiles run together), no maximum is
// computed twice, and the loads are 16 bytes a thread, 64 contiguous bytes
// a voxel (CG = 4).  One block of 512 threads a multiprocessor (its rings
// take 206 KB): of the forms tried on the card (CG 2 or 4, tiles of 8 x 32,
// 16 x 16 and 16 x 32, 128 to 512 threads) the fastest.  In shared memory a y row holds its even columns, then
// its odd ones, so that neighbouring windows' operands are neighbours.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;            // input rows of a tile (even)
constexpr int TW = 16;            // input columns of a tile (even)
constexpr int CG = 4;             // float4s of channels a block takes
constexpr int YH = TH + 3;        // y rows held: h0 - 1 .. h0 + TH + 1
constexpr int YW = TW + 3;
constexpr int MH = TH / 2 + 1;    // windows per axis that touch the tile
constexpr int MW = TW / 2 + 1;
constexpr int YP = YH * YW * CG;  // float4s per y plane
constexpr int UP = YH * MW * CG;
constexpr int VP = MH * MW * CG;
constexpr int DUP = TH * MW * CG;
constexpr int XP = TH * TW * CG;  // outputs per plane
constexpr int NT = 512;
constexpr int YRING = 4;          // planes 2md .. 2md + 3 live at once
constexpr int VRING = 8;          // planes 2md - 1 .. 2md + 3 live at once
constexpr int PRE = (2 * YP + NT - 1) / NT;  // prefetch registers a thread
constexpr int XR = (XP + NT - 1) / NT;       // output pairs a thread a step
constexpr int SMEM_BYTES =
    (YRING * YP + YRING * UP + VRING * VP + 2 * VP + 2 * DUP) * 16;

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

__device__ __forceinline__ float4 fma4(float4 w, float4 g, float4 acc) {
  return make_float4(fmaf(w.x, g.x, acc.x), fmaf(w.y, g.y, acc.y),
                     fmaf(w.z, g.z, acc.z), fmaf(w.w, g.w, acc.w));
}

// Weights of a0 = t[2m] (w1) and a1 = t[2m+1] (w2) in max(max(a0, a1), c).
// tie(a1, a0) = 1 - tie(a0, a1), and every value is a multiple of 0.25 up
// to 1, so w2 = tie(t, c) - w1 exactly.
__device__ __forceinline__ void inner_w(float c, float a0, float a1,
                                        float& w1, float& w2) {
  const float tc = tie(fmaxf(a0, a1), c);
  w1 = tc * tie(a0, a1);
  w2 = tc - w1;
}

// Weight of c = t[2m-1] in max(max(a0, a1), c).
__device__ __forceinline__ float outer_w(float c, float a0, float a1) {
  return tie(c, fmaxf(a0, a1));
}

// One axis' gradients at the tile indices 2j (`even`) and 2j + 1 (`odd`;
// indices count from the tile's even origin) from the stage's operands and
// the next stage's gradient.  `op(k)` is the stage's operand at halo index
// k (the origin's predecessor is 0), `gr(j)` the gradient of window j of
// the tile, `more` whether window j + 1 exists.  Index 2j is the first
// operand of window j; 2j + 1 its second, and the third of window j + 1.
template <class Op, class Gr>
__device__ __forceinline__ void axis_grad(int j, bool more, Op op, Gr gr,
                                          float4& even, float4& odd) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 c = op(2 * j), a0 = op(2 * j + 1), a1 = op(2 * j + 2);
  const float4 gj = gr(j);
  float4 w1, w2;
  inner_w(c.x, a0.x, a1.x, w1.x, w2.x);
  inner_w(c.y, a0.y, a1.y, w1.y, w2.y);
  inner_w(c.z, a0.z, a1.z, w1.z, w2.z);
  inner_w(c.w, a0.w, a1.w, w1.w, w2.w);
  even = fma4(w1, gj, zero);
  odd = fma4(w2, gj, zero);
  if (more) {
    const float4 b0 = op(2 * j + 3), b1 = op(2 * j + 4);
    const float4 w0 = make_float4(
        outer_w(a1.x, b0.x, b1.x), outer_w(a1.y, b0.y, b1.y),
        outer_w(a1.z, b0.z, b1.z), outer_w(a1.w, b0.w, b1.w));
    odd = fma4(w0, gr(j + 1), odd);
  }
}

struct Tile {
  const float4* y;   // at (b, 0, 0, 0, 0)
  int D, H, W, C4, h0, w0, c0;

  // Offset in its plane of element e of a y plane with halo (in float4s),
  // or -1 outside the volume (H W C4 < 2^31 is the wrapper's check).
  __device__ __forceinline__ int offset(int e) const {
    const int cg = e % CG;
    const int r = e / CG;
    const int h = h0 - 1 + r / YW, w = w0 - 1 + r % YW, c4 = c0 + cg;
    if (h < 0 || h >= H || w < 0 || w >= W || c4 >= C4) return -1;
    return (h * W + w) * C4 + c4;
  }

  // The element at `off` of plane d, -inf outside the volume.
  __device__ __forceinline__ float4 fetch(int d, int off) const {
    if (off < 0 || d < 0 || d >= D)
      return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    return __ldg(y + (int64_t)d * H * W * C4 + off);
  }
};

// Where column yw of a y row lies in shared memory: the even columns
// first, then the odd ones, so that the windows' operands (columns 2j,
// 2j + 1, 2j + 2 for neighbouring j) are neighbours and 16-byte reads of
// neighbouring windows fall into distinct banks.
__device__ __forceinline__ int ycol(int yw) {
  return (yw & 1) * ((YW + 1) / 2) + (yw >> 1);
}

// Shared-memory index of element e = (yh YW + yw) CG + cg of a y plane.
__device__ __forceinline__ int yidx(int e) {
  const int r = e / CG;
  return ((r / YW) * YW + ycol(r % YW)) * CG + e % CG;
}

__device__ __forceinline__ int yslot(int d) { return (d + 1) & (YRING - 1); }
__device__ __forceinline__ int vslot(int d) { return (d + 1) & (VRING - 1); }

// u and v of planes d_lo .. d_hi from their y planes in the ring.
__device__ __forceinline__ void stage_maxima(float4* ys, float4* us,
                                             float4* vs, int d_lo, int d_hi,
                                             int tid) {
  const int n = d_hi - d_lo + 1;
  for (int e = tid; e < n * UP; e += NT) {
    const int s = yslot(d_lo + e / UP);
    const int i = e % UP;
    const int cg = i % CG, jw = (i / CG) % MW, yh = i / (CG * MW);
    const float4* p = ys + s * YP + (yh * YW) * CG + cg;
    us[s * UP + i] = chain(p[ycol(2 * jw) * CG], p[ycol(2 * jw + 1) * CG],
                           p[ycol(2 * jw + 2) * CG]);
  }
  __syncthreads();
  for (int e = tid; e < n * VP; e += NT) {
    const int d = d_lo + e / VP;
    const int i = e % VP;
    const int cg = i % CG, jw = (i / CG) % MW, jh = i / (CG * MW);
    const float4* p = us + yslot(d) * UP + ((2 * jh) * MW + jw) * CG + cg;
    vs[vslot(d) * VP + i] = chain(p[0], p[MW * CG], p[2 * MW * CG]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
maxpool_k3s2p1_vjp_kernel(const float4* __restrict__ y,
                          const float4* __restrict__ g,
                          float4* __restrict__ dy, int D, int H, int W,
                          int C4, int OD, int OH, int OW, int tiles_w,
                          int ncg, int nchunk, int wpc) {
  extern __shared__ float4 smem[];
  float4* ys = smem;
  float4* us = ys + YRING * YP;
  float4* vs = us + YRING * UP;
  float4* dvs = vs + VRING * VP;
  float4* dus = dvs + 2 * VP;

  const int tid = threadIdx.x;
  int r = blockIdx.x;
  const int c0 = (r % ncg) * CG;
  r /= ncg;
  const int w0 = (r % tiles_w) * TW;
  const int h0 = (r / tiles_w) * TH;
  const int b = blockIdx.y / nchunk;
  const int md_lo = (blockIdx.y % nchunk) * wpc;
  const int md_hi = min(OD, md_lo + wpc);  // exclusive
  const int mh0 = h0 / 2, mw0 = w0 / 2;

  const Tile tile{y + (int64_t)b * D * H * W * C4, D, H, W, C4, h0, w0, c0};
  const float4* gb = g + (int64_t)b * OD * OH * OW * C4;
  float4* dyb = dy + (int64_t)b * D * H * W * C4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // Planes 2 md_lo - 1 .. 2 md_lo + 1: the first window's.
  for (int e = tid; e < 3 * YP; e += NT) {
    const int d = 2 * md_lo - 1 + e / YP;
    ys[yslot(d) * YP + yidx(e % YP)] = tile.fetch(d, tile.offset(e % YP));
  }
  __syncthreads();
  stage_maxima(ys, us, vs, 2 * md_lo - 1, 2 * md_lo + 1, tid);

  // Each step's two planes: element tid + i NT of the pair, the same
  // offsets every step.
  int off[PRE];
  float4 pre[PRE];
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int e = tid + i * NT;
    off[i] = e < 2 * YP ? tile.offset(e % YP) : -1;
    if (e < 2 * YP) pre[i] = tile.fetch(2 * md_lo + 2 + e / YP, off[i]);
  }

  // Each step's outputs: pair tid + rd NT of the two planes, at the same
  // offset in its plane every step (-1: outside the volume).
  int xoff[XR];
#pragma unroll
  for (int rd = 0; rd < XR; ++rd) {
    const int i = (tid + rd * NT) % (XP / 2);
    const int h = h0 + i / (CG * TW / 2), w = w0 + 2 * ((i / CG) % (TW / 2));
    const int c4 = c0 + i % CG;
    xoff[rd] = (h < H && w < W && c4 < C4) ? (h * W + w) * C4 + c4 : -1;
  }

  for (int md = md_lo; md < md_hi; ++md) {
    // planes 2 md + 2 and 2 md + 3 arrive
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int e = tid + i * NT;
      if (e < 2 * YP)
        ys[yslot(2 * md + 2 + e / YP) * YP + yidx(e % YP)] = pre[i];
    }
    // the next step's loads fly while this step computes
    if (md + 1 < md_hi) {
#pragma unroll
      for (int i = 0; i < PRE; ++i) {
        const int e = tid + i * NT;
        if (e < 2 * YP) pre[i] = tile.fetch(2 * md + 4 + e / YP, off[i]);
      }
    }
    __syncthreads();
    stage_maxima(ys, us, vs, 2 * md + 2, 2 * md + 3, tid);

    // dv of planes 2 md (dvs[0]) and 2 md + 1 (dvs[1]), per window column
#pragma unroll
    for (int rd = 0; rd < (VP + NT - 1) / NT; ++rd) {
      const int i = tid + rd * NT;
      if (i >= VP) break;
      const int cg = i % CG, jw = (i / CG) % MW, jh = i / (CG * MW);
      const int mh = mh0 + jh, mw = mw0 + jw, c4 = c0 + cg;
      const bool valid = mh < OH && mw < OW && c4 < C4;
      const float4* gp = gb + (((int64_t)md * OH + mh) * OW + mw) * C4 + c4;
      const int64_t gplane = (int64_t)OH * OW * C4;
      // depth halo index 0 is plane 2 md - 1
      axis_grad(
          0, md + 1 < OD,
          [&](int k) { return vs[vslot(2 * md - 1 + k) * VP + i]; },
          [&](int j) { return valid ? __ldg(gp + j * gplane) : zero; },
          dvs[i], dvs[VP + i]);
    }
    __syncthreads();
    // du of the tile's rows, two rows a thread, per window column
#pragma unroll
    for (int rd = 0; rd < (DUP + NT - 1) / NT; ++rd) {
      const int e = tid + rd * NT;
      if (e >= DUP) break;
      const int pl = e / (DUP / 2);
      const int i = e % (DUP / 2);
      const int cg = i % CG, jw = (i / CG) % MW, j = i / (CG * MW);
      const float4* up = us + yslot(2 * md + pl) * UP + jw * CG + cg;
      const float4* dvp = dvs + pl * VP + jw * CG + cg;
      float4* dup = dus + pl * DUP + (2 * j * MW + jw) * CG + cg;
      axis_grad(
          j, mh0 + j + 1 < OH, [&](int k) { return up[k * MW * CG]; },
          [&](int jj) { return dvp[jj * MW * CG]; }, dup[0], dup[MW * CG]);
    }
    __syncthreads();
    // dx, two columns a thread
#pragma unroll
    for (int rd = 0; rd < XR; ++rd) {
      const int e = tid + rd * NT;
      const int pl = e / (XP / 2);
      const int d = 2 * md + pl;
      if (e >= XP || xoff[rd] < 0 || d >= D) continue;
      const int i = e % (XP / 2);
      const int cg = i % CG, j = (i / CG) % (TW / 2), th = i / (CG * TW / 2);
      const float4* yp = ys + yslot(d) * YP + ((th + 1) * YW) * CG + cg;
      const float4* dup = dus + pl * DUP + (th * MW) * CG + cg;
      float4 even, odd;
      axis_grad(
          j, mw0 + j + 1 < OW, [&](int k) { return yp[ycol(k) * CG]; },
          [&](int jj) { return dup[jj * CG]; }, even, odd);
      float4* out = dyb + (int64_t)d * H * W * C4 + xoff[rd];
      out[0] = even;
      if (w0 + 2 * j + 1 < W) out[C4] = odd;
    }
    __syncthreads();
  }
}

}  // namespace

// y (B, D, H, W, C) f32 with C % 4 == 0, g (B, OD, OH, OW, C) with
// O* = (* - 1) / 2 + 1, dy (B, D, H, W, C).
extern "C" int hp_maxpool3d_k3s2p1_vjp(const float* y, const float* g,
                                       float* dy, int B, int D, int H, int W,
                                       int C, int OD, int OH, int OW,
                                       void* stream) {
  const int C4 = C / 4;
  const int ncg = (C4 + CG - 1) / CG;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int64_t columns = (int64_t)ncg * tiles_w * tiles_h * B;
  // Runs of depth windows: one per column where the columns alone fill the
  // card, else enough runs for about 1024 blocks, none under 4 windows.
  int nchunk = (int)((1024 + columns - 1) / columns);
  nchunk = max(1, min(nchunk, (OD + 3) / 4));
  const int wpc = (OD + nchunk - 1) / nchunk;
  nchunk = (OD + wpc - 1) / wpc;
  cudaError_t err = cudaFuncSetAttribute(
      maxpool_k3s2p1_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(ncg * tiles_w * tiles_h), (unsigned)(B * nchunk));
  maxpool_k3s2p1_vjp_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(y), reinterpret_cast<const float4*>(g),
      reinterpret_cast<float4*>(dy), D, H, W, C4, OD, OH, OW, tiles_w, ncg,
      nchunk, wpc);
  return (int)cudaGetLastError();
}
