// K4-bf16: 3x3x3 stride-1 pad-1 convolution of the bfloat16 model,
// channels-last (NDHWC) bf16 input, DHWIO bf16 kernel, with an optional
// fused epilogue y * scale + shift (the eval BatchNorm affine, f32) then
// ReLU, and a bf16 output.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu (body
// _conv3mxu_kernel) at its default compute_dtype 'bf16': bf16 operands,
// one pass on the matrix unit, f32 sums, the affine and ReLU in f32, the
// result in x's type.  The Bottleneck conv2 of the c64 @64^3, c128 @32^3
// and c256 @16^3 stages of the bf16 model.  An f32-output instantiation of
// the same kernel (F32OUT) serves a check against float64 only: a bf16
// store would hide a fault of the sums.
//
// What bounds it on the card: an implicit GEMM, M = B*D*H*W output voxels,
// N = C_out, K = 27*C_in, hundreds of FLOP per byte, so bf16 MMA issue
// (6.67e11 FLOP for one t128 batch-2 forward's eleven calls, 0.67 ms at
// 989 TFLOP/s).  The design is the f32 K4's (conv3mxu.cu) with one pass in
// place of three:
//  - wgmma m64n64k16 bf16, one warpgroup per 64 output rows, A from
//    registers, B from shared memory by descriptor.  A unit is 32 input
//    channels of one tap, two k-steps; k slot k of k-step s is channel
//    8 ((k % 8) / 2) + 4s + 2 (k / 8) + k % 2 of the unit, so a lane's A of
//    both k-steps is one 16-byte shared-memory read per row (its rows g and
//    g + 8, channels 8t .. 8t + 7), and no conversion.
//  - A ring of shared-memory stages filled by cp.async 16-byte copies, SUB
//    units (64 channels where C_in % 64 == 0) a stage.  An A tile (the
//    implicit im2col rows, contiguous in channels-last x) goes straight
//    from x to shared memory, zero-filled where the tap leaves the volume.
//    The weights arrive laid out in the wgmma's core-matrix order (a
//    unit's B is one contiguous 4 KB copy).  One cp.async.wait_group, one
//    fence.proxy.async and one barrier per stage; the next stages are in
//    flight while the MMAs run.  The layer's input is rounded to bf16 by
//    the caller in a separate pass (after bn1 and ReLU in f32): a cp.async
//    copies bytes and cannot round.
//  - f32 sums that round to nearest.  The tensor core truncates its f32
//    accumulator, so the MMAs of one stage sum into a fresh partial
//    (scale_d = 0 on the first), the partial is added to a register
//    accumulator by an f32 add, and every FLUSH stages that accumulator is
//    added to the tile's running sum in shared memory, as in the f32 K4.
//  - One tile shape: 128 x 64, two warpgroups, 3 stages, 104 KB of shared
//    memory with the running sums: two blocks a SM.
//  - Epilogue: column r of n-tile 4p + q is output channel 32p + 8(r / 2) +
//    2q + r % 2, so a lane's accumulators of four n-tiles are 8
//    consecutive channels: affine, ReLU, one rounding, one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BK = 32;       // input channels of one tap per unit
constexpr int WG = 2;        // warpgroups a block, each 64 rows
constexpr int NT = 128 * WG;
constexpr int BM = 64 * WG;
constexpr int BN = 64;       // the wgmma's n
constexpr int STAGES = 3;
constexpr int A_UNIT = BM * BK;      // bf16
constexpr int B_UNIT = 2 * 16 * BN;  // bf16: two k-steps
constexpr int A_COPIES = BM * BK * 2 / 16 / NT;  // 16-byte copies a thread
constexpr int B_COPIES = B_UNIT * 2 / 16 / NT;
constexpr int FLUSH = 8;     // units summed in registers between flushes
__host__ __device__ constexpr int smem_bytes(int sub) {
  return STAGES * sub * (A_UNIT + B_UNIT) * 2 + 32 * NT * 4;
}

// wp: the prepared weights, for each (unit, 64-wide n-block) the two
// k-steps' B, each 2 x 8 core matrices, 4 KB in all.
template <int SUB, bool F32OUT>
__global__ void __launch_bounds__(NT, 2)
conv3_bf16_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wp,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, void* __restrict__ out,
                  int B, int D, int H, int W, int cin, int cout, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* const As = reinterpret_cast<uint16_t*>(smem);  // [st][sub][row][32]
  uint16_t* const Bs = As + STAGES * SUB * A_UNIT;
  float4* const sum =
      reinterpret_cast<float4*>(Bs + STAGES * SUB * B_UNIT) + threadIdx.x;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 4 warps a warpgroup, each 16 rows
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t M = (int64_t)B * D * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // The A rows this thread copies: row (tid / 4) + i * NT / 4, 16-byte part
  // tid % 4 (8 channels).  Per row the address of its own voxel and the
  // taps that stay inside the volume (a row past M has none).
  const int part = tid & 3;
  const uint16_t* a_src[A_COPIES];
  uint32_t a_taps[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int64_t m = m0 + (tid >> 2) + i * (NT / 4);
    a_src[i] = x + part * 8;
    a_taps[i] = 0;
    if (m < M) {
      a_src[i] += m * cin;
      int64_t r = m;
      const int vw = (int)(r % W);
      r /= W;
      const int vh = (int)(r % H);
      r /= H;
      const int vd = (int)(r % D);
      for (int tap = 0; tap < 27; ++tap) {
        const int id = vd + tap / 9 - 1;
        const int ih = vh + (tap / 3) % 3 - 1;
        const int iw = vw + tap % 3 - 1;
        if (id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W)
          a_taps[i] |= 1u << tap;
      }
    }
  }

  const int units_per_tap = cin / BK;
  const int iters = 27 * units_per_tap / SUB;  // stages to run
  const int64_t b_step = (int64_t)(cout / BN) * (B_UNIT * 2 / 16);  // uint4s

  // The loader walks the units in order, STAGES - 1 stages ahead of the
  // MMAs: tap, channel block and slot advance by increments.
  auto tap_offset = [&](int tap) {
    return (((tap / 9 - 1) * H + (tap / 3) % 3 - 1) * W + tap % 3 - 1) * cin;
  };
  int ld_left = iters, ld_slot = 0, ld_tap = 0, ld_c = 0;
  int ld_off = tap_offset(0);
  const uint4* ld_b = wp + (int64_t)(n0 / BN) * (B_UNIT * 2 / 16) + tid;
  auto load_stage = [&]() {
    if (ld_left > 0) {
      --ld_left;
#pragma unroll
      for (int sub = 0; sub < SUB; ++sub) {
        const uint32_t a_dst = smem_u32(As + (ld_slot * SUB + sub) * A_UNIT +
                                        (tid >> 2) * BK + part * 8);
#pragma unroll
        for (int i = 0; i < A_COPIES; ++i) {
          const bool in = (a_taps[i] >> ld_tap) & 1u;
          cp_async16(a_dst + i * (NT / 4) * BK * 2,
                     in ? a_src[i] + ld_off : a_src[i], in);
        }
        const uint32_t b_dst =
            smem_u32(Bs + (ld_slot * SUB + sub) * B_UNIT + tid * 8);
#pragma unroll
        for (int i = 0; i < B_COPIES; ++i)
          cp_async16(b_dst + i * NT * 16, ld_b + i * NT, true);
        ld_b += b_step;
        ld_off += BK;
        if (++ld_c == units_per_tap) {
          ld_c = 0;
          ld_off = tap_offset(++ld_tap);
        }
      }
      if (++ld_slot == STAGES) ld_slot = 0;
    }
    cp_async_commit();
  };

  float acc[32], psum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = psum[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage();

  int pending = 0, slot = 0;
  for (int it = 0; it < iters; ++it) {
    // Stage `it` has landed, for every thread after the barrier and for the
    // async proxy after the fence; the barrier also says that every warp is
    // done with the stage before, which is refilled now.
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    load_stage();

    // A of both k-steps of a unit: rows g and g + 8, channels 8t .. 8t + 7
    uint32_t a[SUB][2][4];
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const uint16_t* as =
          As + (slot * SUB + sub) * A_UNIT + (warp * 16 + g) * BK + t * 8;
      const uint4 r0 = *reinterpret_cast<const uint4*>(as);
      const uint4 r1 = *reinterpret_cast<const uint4*>(as + 8 * BK);
      a[sub][0][0] = r0.x;
      a[sub][0][1] = r1.x;
      a[sub][0][2] = r0.y;
      a[sub][0][3] = r1.y;
      a[sub][1][0] = r0.z;
      a[sub][1][1] = r1.z;
      a[sub][1][2] = r0.w;
      a[sub][1][3] = r1.w;
    }
    wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const uint16_t* bs = Bs + (slot * SUB + sub) * B_UNIT;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        wgmma_bf16(psum, a[sub][s], desc_bf16(bs + s * 16 * BN, 1024, 128),
                   sub + s > 0);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += psum[i];
    if (++slot == STAGES) slot = 0;

    // The second level: every FLUSH units `acc` is added to the tile's
    // running sum, which lives in shared memory, 8 float4 a thread, each
    // thread its own; after the last stage the sum comes back into `acc`.
    const bool last = it == iters - 1;
    if (++pending == FLUSH / SUB || last) {
      pending = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4* s = sum + i * NT;
        float4 v = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                               acc[4 * i + 3]);
        if (it >= FLUSH / SUB) {
          const float4 o = *s;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        if (!last) {
          *s = v;
          v = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        acc[4 * i] = v.x;
        acc[4 * i + 1] = v.y;
        acc[4 * i + 2] = v.z;
        acc[4 * i + 3] = v.w;
      }
    }
  }

  // Epilogue: affine, ReLU, one rounding, one 16-byte store per 8 channels
  // (two for the f32 form).
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n = n0 + 32 * p + 8 * t;
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = scale ? __ldg(scale + n + j) : 1.f;
      sh[j] = shift ? __ldg(shift + n + j) : 0.f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + warp * 16 + half * 8 + g;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * q + e;
          float y = fmaf(acc[4 * (4 * p + q) + 2 * half + e], sc[j], sh[j]);
          v[j] = relu ? fmaxf(y, 0.f) : y;
        }
      if (F32OUT) {
        float4* const dst =
            reinterpret_cast<float4*>(static_cast<float*>(out) + m * cout + n);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + m * cout + n) =
            make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                       bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      }
    }
  }
}

// One 16-byte row of the prepared weights per thread: row r of core matrix
// (kc, ng) of k-step s of (unit, n-block), its 8 k values e, k slot
// 8 kc + e = input channel 8 (e / 2) + 4s + 2kc + e % 2 of the unit, at
// output channel 32 (ng / 4) + 8 (r / 2) + 2 (ng % 4) + r % 2 of the block.
__global__ void prep_bf16_kernel(const uint16_t* __restrict__ k,
                                 uint4* __restrict__ wp, int cin, int cout,
                                 int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = idx & 7;
  const int ng = (idx >> 3) & 7;
  const int kc = (idx >> 6) & 1;
  const int s = (idx >> 7) & 1;
  const int nb = (idx >> 8) % (cout / BN);
  const int u = (idx >> 8) / (cout / BN);
  const int tap = u / (cin / BK);
  const int ci0 = (u - tap * (cin / BK)) * BK + 4 * s + 2 * kc;
  const int co =
      nb * BN + 32 * (ng >> 2) + 8 * (r >> 1) + 2 * (ng & 3) + (r & 1);
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + 8 * q + h;  // e = 2q + h
      pair |= (uint32_t)__ldg(k + ((int64_t)tap * cin + ci) * cout + co)
              << (16 * h);
    }
    v[q] = pair;
  }
  wp[idx] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (3, 3, 3, C_in, C_out) bf16 -> wp, the conv kernel's weight operand
// (27 * cin / 32, cout / 64, 256) uint4, 16-byte aligned.
extern "C" int hp_conv3_mxu_bf16_prep(const void* k, void* wp, int cin,
                                      int cout, void* stream) {
  const int total = 27 * (cin / BK) * (cout / BN) * 256;
  prep_bf16_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(k), static_cast<uint4*>(wp), cin, cout,
      total);
  return (int)cudaGetLastError();
}

// x (B, D, H, W, C_in) bf16, wp from hp_conv3_mxu_bf16_prep, out (B, D, H,
// W, C_out) bf16 (f32 with f32_out), all contiguous and 16-byte aligned;
// C_in % 32 == 0, C_out % 64 == 0.  scale and shift (C_out,) f32 are both
// null (no affine) or both set.
extern "C" int hp_conv3_mxu_bf16_fwd(const void* x, const void* wp,
                                     const float* scale, const float* shift,
                                     void* out, int B, int D, int H, int W,
                                     int cin, int cout, int relu, int f32_out,
                                     void* stream) {
  const int64_t M = (int64_t)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), cout / BN);
  const bool two = cin % (2 * BK) == 0;
  auto kernel = two ? (f32_out ? conv3_bf16_kernel<2, true>
                               : conv3_bf16_kernel<2, false>)
                    : (f32_out ? conv3_bf16_kernel<1, true>
                               : conv3_bf16_kernel<1, false>);
  const int smem = smem_bytes(two ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wp), scale,
      shift, out, B, D, H, W, cin, cout, relu);
  return (int)cudaGetLastError();
}
