// K2-bf16: the stem of the bfloat16 model, Conv3d(1 -> 64, 7^3, pad 3) +
// folded eval BatchNorm (y * scale + shift) + ReLU, from the raw bf16
// (B, D, H, W, 1) volume to the full-resolution NDHWC (B, D, H, W, 64) bf16
// output.
//
// Replaces hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas on
// the bf16 operands the JAX model feeds it (StemS2D casts x and the kernel
// to the compute dtype): one bf16 pass on the matrix unit, exact products,
// f32 sums, the affine and ReLU in f32, the result rounded once to bf16.
// Here: wgmma m64n64k16 bf16, one pass, f32 sums.  An f32-output
// instantiation of the same kernel (F32OUT) serves a check against float64
// only: a bf16 store would hide a fault of the sums.
//
// What bounds it on the card: 343 x 64 multiply-adds per output voxel
// against 2 bytes in and 128 bytes out, so bf16 MMA issue (1.84e11 FLOP,
// 2.41e11 with the padding below, for (2, 128^3) at 989 TFLOP/s: 0.24 ms)
// beside the 537 MB write (0.16 ms at 3.35 TB/s).  What the design does:
//  - An implicit GEMM, M = output voxels, N = 64 channels, K = the taps.
//    wgmma's bf16 depth is 16: a k-step is two (kd, kh) rows of kw 0..7,
//    k slot 8 kh_sub + kw = tap (kh 2j + kh_sub, kw) of k-step j, so kh is
//    padded from 7 to 8 as kw is: four k-steps a kd (28 a voxel where 24.5
//    would do; 64 taps a kd for 49).  The weights of kh 7 and kw 7 are 0.
//  - A from registers.  A warpgroup's 64 rows are an 8 (H) x 8 (W) patch of
//    one output plane: lane (g, t) of warp w holds rows (h 2w, w g) and
//    (h 2w + 1, w g), one H step apart.  The halo plane holds 32-bit words
//    of two W neighbours, (v(c), v(c + 1)), so a register (two k slots, kw
//    2t and 2t + 1) is one word, and (row g + 8, kh) is (row g, kh + 1): a
//    lane's A of a whole kd is the 9 words of halo rows 2w .. 2w + 8 at one
//    column, 4 MMAs from 9 shared-memory loads.
//  - The halo has a row and a column of zeros past the window (row TH + 6,
//    column TW + 6), which the padded taps of the last rows and columns
//    read: no word of shared memory that was never written reaches an MMA.
//  - The weights (56 KB) are laid out in the wgmma's core-matrix order by a
//    small kernel (one launch a call) and stay in shared memory for the
//    block's life; with a ring of 8 halo planes a block takes 67 KB, so
//    two persistent blocks of two warpgroups share a SM and walk over work
//    units (an 8 x 16 column of output voxels, DCHUNK planes deep), each
//    halo plane staged once, the next loaded while the current one is
//    multiplied.
//  - f32 sums that round to nearest: the tensor core truncates its f32
//    accumulator, so the 4 MMAs of one kd sum into a fresh partial
//    (scale_d = 0 on the first) and the seven partials are added to the
//    accumulator by f32 adds.
//  - Epilogue: affine, ReLU, one rounding, 16-byte streaming stores of 8
//    channels: column r of n-tile 4p + q is channel 32p + 8(r / 2) + 2q +
//    r % 2, so a lane's accumulators of four n-tiles are 8 consecutive
//    channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int K = 7;
constexpr int P = 3;
constexpr int COUT = 64;
constexpr int KSTEPS = 4;                    // a kd
constexpr int B_STEP = 16 * COUT;            // bf16 of one k-step's B
constexpr int W_HALVES = K * KSTEPS * B_STEP;  // 56 KB of bf16
constexpr int RING = 8;                      // halo planes in shared memory
constexpr int DCHUNK = 32;                   // output planes of a work unit

// A block of two warpgroups owns an 8 x 16 tile of output voxels of a
// plane, each warpgroup an 8 x 8 patch.  Its halo plane: TH + 7 rows of
// TW + 6 words, word (hy, c) = (v(hy, c), v(hy, c + 1)) with v the input at
// (h0 - 3 + hy, w0 - 3 + c), zero outside the volume, in row TH + 6 and in
// column TW + 6.
constexpr int NT = 256;
constexpr int TH = 8, TW = 16;
constexpr int HR = TH + K;       // 15 rows
constexpr int HWW = TW + K - 1;  // 22 words a row
constexpr int PLANE = HR * HWW;  // words
constexpr int SPT = (PLANE + NT - 1) / NT;
constexpr int SMEM = W_HALVES * 2 + RING * PLANE * 4;

template <bool F32OUT>
__global__ void __launch_bounds__(NT, 2)
stem_conv_bf16_kernel(const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ wp,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, void* __restrict__ out,
                      int D, int H, int W, int relu, int tiles_h, int tiles_w,
                      int chunks, int units) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* const ws = smem;  // [kd][j][kc][ng][r][8 bf16]
  uint32_t* const ring = reinterpret_cast<uint32_t*>(smem + W_HALVES * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg_w = (tid >> 7) * 8;  // the warpgroup's patch in the tile
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < W_HALVES / 8; i += NT)
    cp_async16(reinterpret_cast<float*>(smem) + 4 * i,
               reinterpret_cast<const float*>(wp) + 4 * i, true);
  cp_async_commit();

  // This thread's words of a staged plane: (hy, c) of index tid + s NT.
  int st_hy[SPT], st_c[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int i = tid + s * NT;
    st_hy[s] = i / HWW;
    st_c[s] = i - st_hy[s] * HWW;
  }
  // a lane's A words of a kd: rows 2 warp .. 2 warp + 8 at one column
  const int a_off = 2 * warp * HWW + wg_w + g + 2 * t;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    int r = unit;
    const int dc = r % chunks;
    r /= chunks;
    const int h0 = (r % tiles_h) * TH;
    r /= tiles_h;
    const int w0 = (r % tiles_w) * TW;
    const int b = r / tiles_w;
    const int d0 = dc * DCHUNK;
    const int d1 = min(d0 + DCHUNK, D);
    const uint16_t* const xb = x + (int64_t)b * D * H * W;

    // Input plane p (zeros outside the volume and past the window) into
    // registers as words, then into the ring slot of p.
    auto value = [&](int p, int hy, int c) {
      const int gh = h0 - P + hy, gw = w0 - P + c;
      return (hy < HR - 1 && c < HWW && p >= 0 && p < D && gh >= 0 &&
              gh < H && gw >= 0 && gw < W)
                 ? (uint32_t)__ldg(xb + ((int64_t)p * H + gh) * W + gw)
                 : 0u;
    };
    auto load_plane = [&](int p, uint32_t (&v)[SPT]) {
#pragma unroll
      for (int s = 0; s < SPT; ++s)
        v[s] = tid + s * NT < PLANE
                   ? value(p, st_hy[s], st_c[s]) |
                         (value(p, st_hy[s], st_c[s] + 1) << 16)
                   : 0u;
    };
    auto store_plane = [&](int p, const uint32_t (&v)[SPT]) {
      uint32_t* const dst = ring + ((p + RING) & (RING - 1)) * PLANE;
#pragma unroll
      for (int s = 0; s < SPT; ++s)
        if (tid + s * NT < PLANE) dst[tid + s * NT] = v[s];
    };

    __syncthreads();  // the previous unit is done with the ring
    for (int p = d0 - P; p <= d0 + P; ++p) {
      uint32_t v[SPT];
      load_plane(p, v);
      store_plane(p, v);
    }
    cp_async_wait<0>();   // the weights (first unit only)
    fence_proxy_async();  // ... visible to the MMAs' reads of B
    __syncthreads();

    for (int d = d0; d < d1; ++d) {
      // The plane the next output plane adds to the ring, in flight while
      // this one is multiplied; its slot held plane d - 4, which no thread
      // reads after the last barrier.
      const bool more = d + 1 < d1;
      uint32_t nv[SPT];
      if (more) load_plane(d + P + 1, nv);

#pragma unroll 1
      for (int kd = 0; kd < K; ++kd) {
        const uint32_t* const src =
            ring + ((d - P + kd + RING) & (RING - 1)) * PLANE + a_off;
        uint32_t a[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) a[j] = src[j * HWW];
        const unsigned char* const bs = ws + kd * KSTEPS * B_STEP * 2;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
          const uint32_t aj[4] = {a[2 * j], a[2 * j + 1], a[2 * j + 1],
                                  a[2 * j + 2]};
          wgmma_bf16(part, aj, desc_bf16(bs + j * B_STEP * 2, 1024, 128), j);
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = kd ? acc[i] + part[i] : part[i];
      }

      if (more) store_plane(d + P + 1, nv);

      // rows g and g + 8 of the warp: (h 2 warp, w g) and (h 2 warp + 1)
      const int w = w0 + wg_w + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = h0 + 2 * warp + half;
        if (h >= H || w >= W) continue;
        const int64_t o = (((int64_t)(b * D + d) * H + h) * W + w) * COUT;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c0 = 32 * p + 8 * t;  // 8 consecutive channels
          const float4 sc0 = __ldg(reinterpret_cast<const float4*>(scale + c0));
          const float4 sc1 =
              __ldg(reinterpret_cast<const float4*>(scale + c0 + 4));
          const float4 sh0 = __ldg(reinterpret_cast<const float4*>(shift + c0));
          const float4 sh1 =
              __ldg(reinterpret_cast<const float4*>(shift + c0 + 4));
          const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w,
                               sc1.x, sc1.y, sc1.z, sc1.w};
          const float sh[8] = {sh0.x, sh0.y, sh0.z, sh0.w,
                               sh1.x, sh1.y, sh1.z, sh1.w};
          float v[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * p + q;  // n-tile: channels c0 + 2q, + 1
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float y = fmaf(acc[4 * i + 2 * half + e], sc[2 * q + e],
                             sh[2 * q + e]);
              v[2 * q + e] = relu ? fmaxf(y, 0.f) : y;
            }
          }
          if (F32OUT) {
            float4* const dst =
                reinterpret_cast<float4*>(static_cast<float*>(out) + o + c0);
            __stcs(dst, make_float4(v[0], v[1], v[2], v[3]));
            __stcs(dst + 1, make_float4(v[4], v[5], v[6], v[7]));
          } else {
            uint4* const dst = reinterpret_cast<uint4*>(
                static_cast<uint16_t*>(out) + o + c0);
            __stcs(dst, make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                   bf16_pair(v[4], v[5]),
                                   bf16_pair(v[6], v[7])));
          }
        }
      }
      __syncthreads();  // plane d + 4 is staged; plane d - 3 is free
    }
  }
}

// One 16-byte row of the prepared weights per thread: row r of core matrix
// (kc, ng) of k-step j of kd, its 8 k values kw 0..7 of tap row
// kh = 2j + kc (kh 7 and kw 7: zero), at output channel
// 32 (ng / 4) + 8 (r / 2) + 2 (ng % 4) + r % 2.
__global__ void stem_weights_bf16_kernel(const uint16_t* __restrict__ k,
                                         uint4* __restrict__ wp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W_HALVES / 8) return;
  const int r = idx & 7;
  const int ng = (idx >> 3) & 7;
  const int kc = (idx >> 6) & 1;
  const int j = (idx >> 7) & 3;
  const int kd = idx >> 9;
  const int kh = 2 * j + kc;
  const int co = 32 * (ng >> 2) + 8 * (r >> 1) + 2 * (ng & 3) + (r & 1);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kw = 2 * e + h;
      const uint32_t w =
          kh < K && kw < K ? __ldg(k + ((kd * K + kh) * K + kw) * COUT + co)
                           : 0u;
      pair |= w << (16 * h);
    }
    v[e] = pair;
  }
  wp[idx] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (7, 7, 7, 1, 64) DHWIO bf16 -> wp, the conv kernel's weight operand:
// (7, 4, 2, 8, 8, 8) bf16 (kd, k-step, kc, ng, r, kw), 16-byte aligned.
extern "C" int hp_stem_conv_bf16_prep(const void* k, void* wp, void* stream) {
  stem_weights_bf16_kernel<<<(W_HALVES / 8 + 255) / 256, 256, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(k), static_cast<uint4*>(wp));
  return (int)cudaGetLastError();
}

// x (B, D, H, W) bf16, wp from hp_stem_conv_bf16_prep, scale/shift (64,)
// f32, out (B, D, H, W, 64) bf16 (f32 with f32_out); all contiguous, wp,
// scale, shift and out 16-byte aligned.
extern "C" int hp_stem_conv_bf16_fwd(const void* x, const void* wp,
                                     const float* scale, const float* shift,
                                     void* out, int B, int D, int H, int W,
                                     int relu, int f32_out, void* stream) {
  auto kernel = f32_out ? stem_conv_bf16_kernel<true>
                        : stem_conv_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int chunks = (D + DCHUNK - 1) / DCHUNK;
  const int units = B * tiles_h * tiles_w * chunks;
  const int grid = units < 2 * sms ? units : 2 * sms;
  kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wp),
      scale, shift, out, D, H, W, relu, tiles_h, tiles_w, chunks, units);
  return (int)cudaGetLastError();
}
