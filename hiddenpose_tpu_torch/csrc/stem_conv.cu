// K2: the PoseNet3D inference stem, Conv3d(1 -> 64, 7^3, pad 3) + folded
// eval BatchNorm (y * scale + shift) + ReLU, from the raw (B, D, H, W, 1)
// volume to the full-resolution NDHWC (B, D, H, W, 64) output.
//
// Replaces hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas
// (body _stem_kernel).  The TPU kernel evaluates the conv as a 5^3 conv in
// 2x2x2 space-to-depth form so that its matrix unit sees a 1000-deep
// contraction; here there is no space-to-depth: the conv is an implicit
// GEMM on the tensor cores, M = output voxels, N = the 64 channels, K = the
// taps, with kw padded from 7 to 8 (K = 7 x 7 x 8 = 392; the eighth tap's
// weight is 0).  f32 in and out; the products run as three TF32 passes with
// f32 sums (3xTF32), never one: x = x_hi + x_lo and w = w_hi + w_lo, both
// parts TF32, x w ~ x_lo w_hi + x_hi w_lo + x_hi w_hi.
//
// What bounds it on the card: 343 x 64 multiply-adds per output voxel
// against 4 bytes in and 256 bytes out, so TF32 MMA issue at three passes
// (3 x 1.84e11 FLOP, 3 x 2.10e11 with the padding, for (2, 128^3)); the
// 1.07 GB output takes a quarter of that time and is written while the
// tensor cores work on the next plane.  What the design does about it:
//  - wgmma m64n64k8 TF32, A from registers, B by descriptor.  A k-step is
//    one (kd, kh) row of taps: its 8 k slots are kw 0..7.  A warpgroup's 64
//    rows are an 8 (H) x 8 (W) patch of one output plane: lane (g, t) of
//    warp w holds rows (h 2w, w g) and (h 2w + 1, w g), so A of row g + 8
//    at kh is A of row g at kh + 1, and a lane's A of a whole kd (seven
//    k-steps) is 8 halo rows x 2 values (kw t and t + 4): 16 8-byte loads.
//  - The input is split into (hi, lo) once, when a plane of its halo is
//    staged into shared memory (a float2 per voxel): each value feeds 343
//    products, and a k-step then costs a lane no conversion.
//  - The weights, split and laid out in the wgmma's core-matrix order by a
//    small kernel (stem_weights_kernel, one launch a call), stay in shared
//    memory for the block's life: 196 KB.  So one persistent block a SM,
//    2 warpgroups, walks over work units (an 8 x 16 column of output
//    voxels, DCHUNK planes deep), each plane of the halo staged once into
//    a ring of 8 planes, the next one loaded while the current one is
//    multiplied.
//  - f32 sums that round to nearest.  The tensor core truncates its f32
//    accumulator, so the 21 MMAs of one kd (the small terms first) sum
//    into a fresh partial (scale_d = 0 on the first) and the partial is
//    added to the register accumulator by an f32 add: seven adds a voxel.
//    A warpgroup runs one kd stage at a time; the other warpgroup's MMAs
//    fill the tensor cores while it loads and adds (issuing the next
//    stage before waiting, with a second partial and A set, was slower:
//    scripts/torch_stem_conv_variants.py).
//  - Epilogue: affine, ReLU, 16-byte streaming stores of 4 channels: a
//    lane's accumulators of two n-tiles are 4 consecutive channels, since
//    column r of n-tile 2p + q is channel 16p + 4(r / 2) + 2q + r % 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int K = 7;
constexpr int P = 3;
constexpr int COUT = 64;
constexpr int KSTEPS = K * K;            // (kd, kh)
constexpr int B_PART = 8 * COUT;         // floats of one (k-step, part) B
constexpr int W_FLOATS = KSTEPS * 2 * B_PART;   // hi and lo: 196 KB
constexpr int RING = 8;                  // halo planes in shared memory
constexpr int DCHUNK = 32;               // output planes of a work unit

// A block of two warpgroups owns an 8 x 16 tile of output voxels of a
// plane, each warpgroup an 8 x 8 patch; its halo plane holds (hi, lo) of
// (TH + 6) x (TW + 6) input voxels and a column of zeros, which the zero
// tap kw = 7 of the last output column reads.
constexpr int NT = 256;
constexpr int TH = 8, TW = 16;
constexpr int HW = TW + K;
constexpr int PLANE = (TH + K - 1) * HW;  // float2s
constexpr int SPT = (PLANE + NT - 1) / NT;
constexpr int SMEM = W_FLOATS * 4 + RING * PLANE * 8;

__global__ void __launch_bounds__(NT, 1)
stem_conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out,
                    int D, int H, int W, int relu, int tiles_h, int tiles_w,
                    int chunks, int units) {
  extern __shared__ __align__(16) float smem[];
  float* const ws = smem;  // [k-step][part][kc][ng][r][e]
  float2* const ring = reinterpret_cast<float2*>(smem + W_FLOATS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg_w = (tid >> 7) * 8;  // the warpgroup's patch in the tile
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < W_FLOATS / 4; i += NT)
    cp_async16(ws + 4 * i, wp + 4 * i, true);
  cp_async_commit();

  // This thread's halo voxels of a staged plane: (hy, wx) of index
  // tid + s NT; a lane's A values of a kd start at halo (2 warp, g + t) of
  // its warpgroup's patch.
  int st_hy[SPT], st_wx[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int i = tid + s * NT;
    st_hy[s] = i / HW;
    st_wx[s] = i - st_hy[s] * HW;
  }
  const int a_off = 2 * warp * HW + wg_w + g + t;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  uint32_t ahi[8][2], alo[8][2];

  // A of stage kd of output plane d: 8 halo rows x 2 values (kw t, t + 4),
  // hi and lo.
  auto load_a = [&](int d, int kd, uint32_t (&hi)[8][2],
                    uint32_t (&lo)[8][2]) {
    const float2* const src =
        ring + ((d - P + kd + RING) & (RING - 1)) * PLANE + a_off;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 v = src[j * HW + 4 * c];
        hi[j][c] = __float_as_uint(v.x);
        lo[j][c] = __float_as_uint(v.y);
      }
  };
  // The 21 MMAs of stage kd into a fresh partial, the small terms first:
  // A of row g + 8 at kh is A of row g at kh + 1.
  auto issue = [&](int kd, const uint32_t (&hi)[8][2],
                   const uint32_t (&lo)[8][2], float (&p)[32]) {
    const float* const bs = ws + kd * K * 2 * B_PART;
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const uint32_t a[4] = {lo[kh][0], lo[kh + 1][0], lo[kh][1],
                             lo[kh + 1][1]};
      wgmma_tf32(p, a, b_desc(bs + 2 * kh * B_PART), kh);
    }
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const uint32_t a[4] = {hi[kh][0], hi[kh + 1][0], hi[kh][1],
                             hi[kh + 1][1]};
      wgmma_tf32(p, a, b_desc(bs + (2 * kh + 1) * B_PART), 1);
    }
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const uint32_t a[4] = {hi[kh][0], hi[kh + 1][0], hi[kh][1],
                             hi[kh + 1][1]};
      wgmma_tf32(p, a, b_desc(bs + 2 * kh * B_PART), 1);
    }
    wgmma_commit();
  };
  // The partial of stage kd into the accumulator, by f32 adds.
  auto add = [&](const float (&p)[32], int kd) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = kd ? acc[i] + p[i] : p[i];
  };

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
    const float* const xb = x + (int64_t)b * D * H * W;

    // Input plane p (zeros outside the volume) into registers, then split
    // into the ring slot of p.
    auto load_plane = [&](int p, float (&v)[SPT]) {
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        const int gh = h0 - P + st_hy[s], gw = w0 - P + st_wx[s];
        v[s] = (tid + s * NT < PLANE && st_wx[s] < HW - 1 &&
                p >= 0 && p < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
                   ? __ldg(xb + ((int64_t)p * H + gh) * W + gw)
                   : 0.f;
      }
    };
    auto store_plane = [&](int p, const float (&v)[SPT]) {
      float2* const dst = ring + ((p + RING) & (RING - 1)) * PLANE;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        if (tid + s * NT < PLANE) {
          const float hi = tf32_round(v[s]);
          dst[tid + s * NT] = make_float2(hi, tf32_round(v[s] - hi));
        }
      }
    };

    __syncthreads();  // the previous unit is done with the ring
    for (int p = d0 - P; p <= d0 + P; ++p) {
      float v[SPT];
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
      float nv[SPT];
      if (more) load_plane(d + P + 1, nv);

      // Stage kd: its A into registers, its MMAs, their partial added.
      // (The other warpgroup's MMAs run while this one loads and adds.)
#pragma unroll 1
      for (int kd = 0; kd < K; ++kd) {
        load_a(d, kd, ahi, alo);
        issue(kd, ahi, alo, part);
        wgmma_wait();
        add(part, kd);
      }

      if (more) store_plane(d + P + 1, nv);

      // rows g and g + 8 of the warp: (h 2 warp, w g) and (h 2 warp + 1)
      const int w = w0 + wg_w + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = h0 + 2 * warp + half;
        if (h >= H || w >= W) continue;
        float* const o =
            out + (((int64_t)(b * D + d) * H + h) * W + w) * COUT + 4 * t;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) +
                                  4 * p + t);
          const float4 sh = __ldg(reinterpret_cast<const float4*>(shift) +
                                  4 * p + t);
          float4 v = make_float4(
              fmaf(acc[8 * p + 2 * half], sc.x, sh.x),
              fmaf(acc[8 * p + 2 * half + 1], sc.y, sh.y),
              fmaf(acc[8 * p + 4 + 2 * half], sc.z, sh.z),
              fmaf(acc[8 * p + 4 + 2 * half + 1], sc.w, sh.w));
          if (relu) {
            v.x = fmaxf(v.x, 0.f);
            v.y = fmaxf(v.y, 0.f);
            v.z = fmaxf(v.z, 0.f);
            v.w = fmaxf(v.w, 0.f);
          }
          __stcs(reinterpret_cast<float4*>(o + 16 * p), v);
        }
      }
      __syncthreads();  // plane d + 4 is staged; plane d - 3 is free
    }
  }
}

// One float4 of the prepared weights per thread: row r of core matrix
// (kc, ng) of part `part` (hi, lo) of k-step s = 7 kd + kh, its 4 k values
// kw = 4 kc + e (kw 7: zero), at output channel
// 16 (ng / 2) + 4 (r / 2) + 2 (ng % 2) + r % 2.
__global__ void stem_weights_kernel(const float* __restrict__ k,
                                    float4* __restrict__ wp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W_FLOATS / 4) return;
  const int r = idx & 7;
  const int ng = (idx >> 3) & 7;
  const int kc = (idx >> 6) & 1;
  const int part = (idx >> 7) & 1;
  const int s = idx >> 8;
  const int co = 16 * (ng >> 1) + 4 * (r >> 1) + 2 * (ng & 1) + (r & 1);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kw = 4 * kc + e;
    const float w = kw < K ? __ldg(k + (s * K + kw) * COUT + co) : 0.f;
    const float hi = tf32_round(w);
    v[e] = part ? tf32_round(w - hi) : hi;
  }
  wp[idx] = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (7, 7, 7, 1, 64) DHWIO f32 -> wp, the conv kernel's weight operand:
// (49, 2, 2, 8, 8, 4) f32 (k-step, part, kc, ng, r, e).
extern "C" int hp_stem_conv_prep(const float* k, float* wp, void* stream) {
  stem_weights_kernel<<<(W_FLOATS / 4 + 255) / 256, 256, 0,
                        (cudaStream_t)stream>>>(
      k, reinterpret_cast<float4*>(wp));
  return (int)cudaGetLastError();
}

// x (B, D, H, W) f32, wp from hp_stem_conv_prep, scale/shift (64,), out
// (B, D, H, W, 64); all contiguous, wp, scale, shift and out 16-byte
// aligned.
extern "C" int hp_stem_conv_fwd(const float* x, const float* wp,
                                const float* scale, const float* shift,
                                float* out, int B, int D, int H, int W,
                                int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int chunks = (D + DCHUNK - 1) / DCHUNK;
  const int units = B * tiles_h * tiles_w * chunks;
  const int grid = units < sms ? units : sms;
  stem_conv_tc_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      x, wp, scale, shift, out, D, H, W, relu, tiles_h, tiles_w, chunks,
      units);
  return (int)cudaGetLastError();
}
