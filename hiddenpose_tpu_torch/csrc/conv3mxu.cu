// K4: 3x3x3 stride-1 pad-1 convolution, channels-last (NDHWC) input, DHWIO
// kernel, with an optional fused epilogue y * scale + shift (the eval
// BatchNorm affine) then ReLU.  Full f32: fp32 FMA, no TF32.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu (body
// _conv3mxu_kernel), the Bottleneck conv2 of the c64 @64^3, c128 @32^3 and
// c256 @16^3 stages.
//
// What bounds it on the card: as an implicit GEMM it is
// M = B*D*H*W (output voxels) x N = C_out x K = 27*C_in, i.e. hundreds of
// FLOPs per byte, so it is bound by fp32 FMA issue and by how well the
// operands are reused from shared memory and registers.  Design: a classic
// SIMT tiled GEMM.  A block of 128 threads computes a 128 (voxels) x 64
// (channels) output tile; each k-step stages a 128 x 16 slice of the
// implicit im2col matrix (16 consecutive input channels of one tap, zero
// where the tap falls outside the volume: no padded copy is ever written)
// and the matching 16 x 64 weight slice in shared memory; each thread then
// does 8 x 8 FMAs per pair of 16-byte loads from each operand.  The
// epilogue applies the affine and ReLU before the single store.
// Later work: wgmma would need TF32 or lower precision; cp.async or TMA
// double buffering would hide the global-load latency this version exposes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
conv3_igemm_kernel(const float* __restrict__ x, const float* __restrict__ k,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out,
                   int B, int D, int H, int W, int cin, int cout, int relu) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int64_t M = (int64_t)B * D * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // The A row this thread stages: voxel m0 + tid.
  const int64_t am = m0 + tid;
  const bool arow = am < M;
  int aw, ah, ad, ab;
  {
    int64_t r = arow ? am : 0;
    aw = (int)(r % W);
    r /= W;
    ah = (int)(r % H);
    r /= H;
    ad = (int)(r % D);
    ab = (int)(r / D);
  }

  const int tx = tid % 8;   // output channels n0 + tx*8 .. +8
  const int ty = tid / 8;   // output voxels   m0 + ty*8 .. +8
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int kdim = 27 * cin;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    const int tap = k0 / cin;
    const int ci0 = k0 - tap * cin;
    const int id = ad + tap / 9 - 1;
    const int ih = ah + (tap / 3) % 3 - 1;
    const int iw = aw + tap % 3 - 1;
    float4 a[4];
    if (arow && id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W) {
      const float4* src = reinterpret_cast<const float4*>(
          x + (((int64_t)(ab * D + id) * H + ih) * W + iw) * cin + ci0);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = __ldg(src + q);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[4 * q + 0][tid] = a[q].x;
      As[4 * q + 1][tid] = a[q].y;
      As[4 * q + 2][tid] = a[q].z;
      As[4 * q + 3][tid] = a[q].w;
    }
#pragma unroll
    for (int i = tid; i < BK * BN / 4; i += NT) {
      const int r = i / (BN / 4);
      const int c4 = i - r * (BN / 4);
      reinterpret_cast<float4*>(&Bs[r][0])[c4] = __ldg(
          reinterpret_cast<const float4*>(k + (int64_t)(k0 + r) * cout + n0) +
          c4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * 8;
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = scale ? __ldg(scale + n + j) : 1.f;
    sh[j] = shift ? __ldg(shift + n + j) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty * 8 + i;
    if (m >= M) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = fmaf(acc[i][j], sc[j], sh[j]);
      if (relu) v[j] = fmaxf(v[j], 0.f);
    }
    float4* o = reinterpret_cast<float4*>(out + m * cout + n);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace

// x (B, D, H, W, C_in), k (3, 3, 3, C_in, C_out), out (B, D, H, W, C_out),
// all f32 and contiguous; C_in % 16 == 0, C_out % 64 == 0.  scale and shift
// (C_out,) are both null (no affine) or both set.
extern "C" int hp_conv3_mxu_fwd(const float* x, const float* k,
                                const float* scale, const float* shift,
                                float* out, int B, int D, int H, int W,
                                int cin, int cout, int relu, void* stream) {
  const int64_t M = (int64_t)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), cout / BN);
  conv3_igemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, k, scale, shift, out, B, D, H, W, cin, cout, relu);
  return (int)cudaGetLastError();
}
