// K5: dx of K1 (conv3p.cu), the adjoint of "pad (zero or edge), then VALID
// 3x3x3 conv" on channels-planes volumes.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes_adjoint
// (kernel bodies _conv3p_adj_kernel / _conv3p_adj_kernel_db).  Contract:
//   dx[b, ci, i] = sum over (o, t) whose padded read lands on i of
//                  sum_co k[t, ci, co] * dz[b, co, o]
// with dz (B, C_out, D, H, W), the forward's DHWIO kernel
// (3, 3, 3, C_in, C_out) and dx (B, C_in, D, H, W).  With zero padding this
// is the correlation of dz with the flipped taps.  With edge padding a
// boundary voxel also collects the reads that the replicate pad clamped
// onto it; per axis the (o, t) pairs that land on i are always three
// (axis_pairs below), so a corner voxel takes 27 folded terms like any
// other, only from other taps.
//
// What bounds it on the card: the forward's arithmetic (27 * C_out FMAs per
// input voxel per C_in) at 1-64 channels, far below the fp32 FMA rate per
// byte of device memory, so memory traffic, as for K1.
// Design: K1's, with the roles of the channels swapped.  One block owns a
// 32 (W) x 8 (H) tile of one dx plane for up to 8 input channels; for each
// output channel it stages the 3 x 10 x 34 halo tile of dz (zeros outside
// the volume) and that channel's 27 x 8 taps in shared memory.  Each
// thread reads its three (offset, tap) pairs per axis from the halo tile,
// so the edge folding costs no extra memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;      // dx tile width  (threadIdx.x)
constexpr int TH = 8;       // dx tile height (threadIdx.y)
constexpr int CI_BLK = 8;   // input channels per block
constexpr int SW = TW + 2;
constexpr int SH = TH + 2;
constexpr int NTHREADS = TW * TH;

// The three (offset, tap) pairs along one axis by which dz positions
// o = i - 1 + off reach input i: o's tap t reads the padded input at
// o + t - 1.  Inside the volume (or with zero padding, where an o outside
// the volume holds a zero in the halo tile) t = 2 - off.  With edge
// padding the clamped reads fold onto the first and the last voxel.
__device__ __forceinline__ void axis_pairs(int i, int n, int edge, int off[3],
                                           int tap[3]) {
  off[0] = 2; tap[0] = 0;
  off[1] = 1; tap[1] = 1;
  off[2] = 0; tap[2] = 2;
  if (!edge) return;
  if (n == 1) {          // o = 0 reads i = 0 with every tap
    off[0] = 1; off[1] = 1; off[2] = 1;
  } else if (i == 0) {   // (o, t) = (0, 0), (1, 0), (0, 1)
    off[0] = 1; tap[0] = 0;
    off[1] = 2; tap[1] = 0;
    off[2] = 1; tap[2] = 1;
  } else if (i == n - 1) {  // (o, t) = (n-1, 2), (n-2, 2), (n-1, 1)
    off[0] = 1; tap[0] = 2;
    off[1] = 0; tap[1] = 2;
    off[2] = 1; tap[2] = 1;
  }
}

__global__ void __launch_bounds__(NTHREADS)
conv3p_adjoint_kernel(const float* __restrict__ dz,
                      const float* __restrict__ k, float* __restrict__ dx,
                      int cin, int cout, int D, int H, int W, int edge,
                      int tiles_w) {
  __shared__ float tile[3][SH][SW];
  __shared__ float wk[27][CI_BLK];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int d = blockIdx.y;
  const int n_cig = (cin + CI_BLK - 1) / CI_BLK;
  const int b = blockIdx.z / n_cig;
  const int ci0 = (blockIdx.z % n_cig) * CI_BLK;
  const int64_t plane = (int64_t)H * W;
  const int h = h0 + ty;
  const int w = w0 + tx;

  int offd[3], tapd[3], offh[3], taph[3], offw[3], tapw[3];
  axis_pairs(d, D, edge, offd, tapd);
  axis_pairs(min(h, H - 1), H, edge, offh, taph);
  axis_pairs(min(w, W - 1), W, edge, offw, tapw);

  float acc[CI_BLK];
#pragma unroll
  for (int j = 0; j < CI_BLK; ++j) acc[j] = 0.f;

  for (int co = 0; co < cout; ++co) {
    const float* zc = dz + ((int64_t)b * cout + co) * D * plane;
    for (int i = tid; i < 3 * SH * SW; i += NTHREADS) {
      const int zd = i / (SH * SW);
      const int r = i - zd * (SH * SW);
      const int yy = r / SW;
      const int xx = r - yy * SW;
      const int gd = d - 1 + zd, gh = h0 - 1 + yy, gw = w0 - 1 + xx;
      const bool inside = gd >= 0 && gd < D && gh >= 0 && gh < H &&
                          gw >= 0 && gw < W;
      tile[zd][yy][xx] = inside ? zc[gd * plane + (int64_t)gh * W + gw] : 0.f;
    }
    for (int i = tid; i < 27 * CI_BLK; i += NTHREADS) {
      const int t = i / CI_BLK;
      const int j = i - t * CI_BLK;
      const int ci = ci0 + j;
      wk[t][j] = ci < cin ? k[((int64_t)t * cin + ci) * cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = tile[offd[a]][ty + offh[bb]][tx + offw[c]];
          const int t = (tapd[a] * 3 + taph[bb]) * 3 + tapw[c];
#pragma unroll
          for (int j = 0; j < CI_BLK; ++j) acc[j] = fmaf(v, wk[t][j], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  if (h >= H || w >= W) return;
#pragma unroll
  for (int j = 0; j < CI_BLK; ++j) {
    const int ci = ci0 + j;
    if (ci >= cin) break;
    dx[(((int64_t)b * cin + ci) * D + d) * plane + (int64_t)h * W + w] =
        acc[j];
  }
}

}  // namespace

// dz (B, C_out, D, H, W), k (3, 3, 3, C_in, C_out) DHWIO (the forward
// kernel), dx (B, C_in, D, H, W); pad_mode 0 zero, 1 edge.
extern "C" int hp_conv3p_adjoint(const float* dz, const float* k, float* dx,
                                 int B, int cin, int cout, int D, int H, int W,
                                 int pad_mode, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int n_cig = (cin + CI_BLK - 1) / CI_BLK;
  dim3 grid(tiles_w * tiles_h, D, B * n_cig);
  dim3 block(TW, TH);
  conv3p_adjoint_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      dz, k, dx, cin, cout, D, H, W, pad_mode, tiles_w);
  return (int)cudaGetLastError();
}
