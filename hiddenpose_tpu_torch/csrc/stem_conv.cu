// K2: the PoseNet3D inference stem, Conv3d(1 -> 64, 7^3, pad 3) + folded
// eval BatchNorm (y * scale + shift) + ReLU, from the raw (B, D, H, W, 1)
// volume to the full-resolution NDHWC (B, D, H, W, 64) output.
//
// Replaces hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas
// (body _stem_kernel).  The TPU kernel evaluates the conv as a 5^3 conv in
// 2x2x2 space-to-depth form so that its matrix unit sees a 1000-deep
// contraction; here there is no space-to-depth and no matrix unit: the
// conv runs on the fp32 FMA pipes in full f32.
//
// What bounds it on the card: 343 * 64 FMAs per output voxel against 4
// bytes of input and 256 bytes of output, so it is bound by fp32 FMA issue
// (the output write is a few percent of the time).  Design: one block of
// 256 threads owns a 4 x 4 x 16 (D x H x W) output tile and all 64 output
// channels, walks down a column of such tiles in D, keeps the whole
// 343 x 64 weight table in shared memory for the block's lifetime and
// stages a 10 x 10 x 22 input halo tile per output tile.  Each thread keeps
// 8 voxels (along W) x 8 channels of accumulators, reads one 14-wide input
// row per (kd, kh) into registers and reuses it for all 7 kw taps, so it
// issues 64 FMAs per two 16-byte shared-memory weight loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 7;
constexpr int P = 3;
constexpr int COUT = 64;
constexpr int TD = 4, TH = 4, TW = 16;
constexpr int ID = TD + K - 1, IH = TH + K - 1, IW = TW + K - 1;  // 10 10 22
constexpr int VW = 8;             // voxels per thread along W
constexpr int CG = 8;             // channels per thread
constexpr int NTHREADS = 256;     // (TD*TH*TW/VW) * (COUT/CG)
constexpr int DCHUNK = 16;        // output planes per block (TD steps)
constexpr int W_FLOATS = K * K * K * COUT;
constexpr int IN_FLOATS = ID * IH * IW;
constexpr size_t SMEM_BYTES = (size_t)(W_FLOATS + IN_FLOATS) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS, 2)
stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ k,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ out,
                 int D, int H, int W, int relu, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* wk = reinterpret_cast<float*>(smem4);   // [343][64]
  float* xin = wk + W_FLOATS;                    // [ID][IH][IW]

  const int tid = threadIdx.x;
  const int cg = tid % (COUT / CG);
  const int vg = tid / (COUT / CG);              // 0..31
  const int vd = vg / 8;
  const int vh = (vg % 8) / 2;
  const int vw0 = (vg % 2) * VW;

  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int dbeg = blockIdx.y * DCHUNK;
  const int b = blockIdx.z;
  const float* xb = x + (int64_t)b * D * H * W;

  for (int i = tid; i < W_FLOATS / 4; i += NTHREADS)
    smem4[i] = reinterpret_cast<const float4*>(k)[i];

  const int dend = min(dbeg + DCHUNK, D);
  for (int d0 = dbeg; d0 < dend; d0 += TD) {
    __syncthreads();  // previous tile's reads are done (and weights landed)
    for (int i = tid; i < IN_FLOATS; i += NTHREADS) {
      const int dz = i / (IH * IW);
      const int r = i - dz * (IH * IW);
      const int yy = r / IW;
      const int xx = r - yy * IW;
      const int gd = d0 - P + dz, gh = h0 - P + yy, gw = w0 - P + xx;
      float v = 0.f;
      if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = xb[((int64_t)gd * H + gh) * W + gw];
      xin[i] = v;
    }
    __syncthreads();

    float acc[VW][CG];
#pragma unroll
    for (int j = 0; j < VW; ++j)
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[j][c] = 0.f;

    for (int kd = 0; kd < K; ++kd) {
      for (int kh = 0; kh < K; ++kh) {
        const float* row = xin + ((vd + kd) * IH + (vh + kh)) * IW + vw0;
        float r[VW + K - 1];
#pragma unroll
        for (int q = 0; q < VW + K - 1; ++q) r[q] = row[q];
        const float* wrow = wk + ((kd * K + kh) * K) * COUT + cg * CG;
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4 wa = *reinterpret_cast<const float4*>(wrow + kw * COUT);
          const float4 wb =
              *reinterpret_cast<const float4*>(wrow + kw * COUT + 4);
          const float wv[CG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < VW; ++j)
#pragma unroll
            for (int c = 0; c < CG; ++c)
              acc[j][c] = fmaf(r[j + kw], wv[c], acc[j][c]);
        }
      }
    }

    const int d = d0 + vd;
    const int h = h0 + vh;
    if (d < D && h < H) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const int w = w0 + vw0 + j;
        if (w >= W) break;
        float v[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          v[c] = fmaf(acc[j][c], __ldg(scale + cg * CG + c),
                      __ldg(shift + cg * CG + c));
          if (relu) v[c] = fmaxf(v[c], 0.f);
        }
        float4* o = reinterpret_cast<float4*>(
            out + (((int64_t)(b * D + d) * H + h) * W + w) * COUT + cg * CG);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

}  // namespace

// x (B, D, H, W) f32, k (7, 7, 7, 1, 64) DHWIO f32, scale/shift (64,),
// out (B, D, H, W, 64).
extern "C" int hp_stem_conv_fwd(const float* x, const float* k,
                                const float* scale, const float* shift,
                                float* out, int B, int D, int H, int W,
                                int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, (D + DCHUNK - 1) / DCHUNK, B);
  stem_conv_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, k, scale, shift, out, D, H, W, relu, tiles_w);
  return (int)cudaGetLastError();
}
