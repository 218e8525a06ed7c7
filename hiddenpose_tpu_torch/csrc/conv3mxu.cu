// K4: 3x3x3 stride-1 pad-1 convolution, channels-last (NDHWC) input, DHWIO
// kernel, with an optional fused epilogue y * scale + shift (the eval
// BatchNorm affine) then ReLU.  f32 in and out; the products run on the
// tensor cores as three TF32 passes with f32 accumulation (3xTF32), never
// one: a = a_hi + a_lo with both parts TF32, and
// a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi.  The dropped a_lo * b_lo
// is about 2^-22 of |a||b|, f32's own rounding.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu (body
// _conv3mxu_kernel, whose f32 mode is the matrix unit's multi-pass
// precision=HIGHEST), the Bottleneck conv2 of the c64 @64^3, c128 @32^3 and
// c256 @16^3 stages, and, on flipped, in/out-swapped taps, its input
// gradient (:525, :545).
//
// What bounds it on the card: as an implicit GEMM it is M = B*D*H*W (output
// voxels) x N = C_out x K = 27*C_in, hundreds of FLOP per byte, so it is
// bound by TF32 MMA issue at three passes (6.67e11 FLOP x 3 at 495 TFLOP/s
// for one t128 batch-2 forward's eleven calls; their bytes would take 0.3%
// of that).  What the design does about it:
//  - wgmma m64n64k8 TF32, asynchronous, one warpgroup per 64 output rows.
//    A comes from registers, so that it can be split there: a lane reads
//    its rows' 16 channels of a k-step from shared memory (two 16-byte
//    reads of the unpadded tile) and splits them with cvt.rna.tf32.f32,
//    twice.  B comes from shared memory by descriptor: the weights arrive
//    already split, hi and lo, in the wgmma's unswizzled "core matrix"
//    order (prep_kernel below), so a k-step's tile is one contiguous 8 KB
//    copy.  (An earlier mma.sync m16n8k8 form of the same pipeline spent 4.8
//    instructions per MMA and reached a third of the TF32 peak, this one
//    about half.)
//  - A ring of shared-memory stages filled by cp.async 16-byte copies, two
//    k-steps (32 input channels of one tap) a stage where C_in % 32 == 0.
//    An A tile (the implicit im2col rows, contiguous in channels-last x)
//    goes straight from x to shared memory, zero-filled (source size 0,
//    address clamped to the row's own voxel) where the tap leaves the
//    volume: no register staging, no padded copy.  One cp.async.wait_group,
//    one fence.proxy.async (wgmma reads through the async proxy) and one
//    barrier per stage; the next stage is in flight while the MMAs run.
//    The loader advances tap, channel block and slot by increments.
//  - Neither k nor n of an MMA has to follow memory order, so a lane's A
//    values of a k-step's two MMAs are input channels 4t .. 4t + 3, and its
//    accumulator columns of two n-tiles 4 consecutive output channels (one
//    16-byte store).
//  - One tile shape: 128 x 64, two warpgroups, 80 or 96 KB of shared memory,
//    two blocks a SM; c256 @16^3 gets 256 blocks for 132 SMs.
//  - f32 sums that round to nearest.  The tensor core truncates its f32
//    accumulator: summed there over the whole K loop the result is biased,
//    6 to 17 times the error of a plain f32 conv (measured, growing with K).
//    So the MMAs of one stage sum into a fresh partial (scale_d = 0), the
//    partial is added to a register accumulator by an f32 add, and every
//    FLUSH k-steps that accumulator is added to the tile's running sum in
//    shared memory: two levels, so that no sum takes more than a few dozen
//    additions at full magnitude.  The error against float64 is then a
//    tenth of the plain f32 conv's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int BK = 16;      // input channels of one tap per k-step
constexpr int FLUSH = 16;   // k-steps summed in registers between flushes
constexpr int WG = 2;       // warpgroups a block, each 64 rows
constexpr int NT = 128 * WG;
constexpr int BM = 64 * WG;
constexpr int BN = 64;      // the wgmma's n
constexpr int A_STAGE = BM * BK;          // floats
constexpr int B_STAGE = 2 * BN * BK;      // floats, hi and lo
constexpr int B_MAT = BN * 8;             // floats of one (part, kk) operand
constexpr int A_COPIES = BM * 4 / NT;     // 16-byte copies a thread, a stage
constexpr int B_COPIES = B_STAGE / 4 / NT;
// A stage of the ring holds SUB k-steps (2 where C_in % 32 == 0, else 1):
// one barrier and one wait for the MMAs per stage.  96 or 80 KB a block with
// the running sums, so two blocks fit a SM.
__host__ __device__ constexpr int stages(int sub) {
  return sub == 2 ? 2 : 3;
}
constexpr int smem_bytes(int sub) {
  return (stages(sub) * sub * (A_STAGE + B_STAGE) + 32 * NT) *
         (int)sizeof(float);
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp w of a warpgroup holds rows 16w .. 16w + 15 of the wgmma's A and D.
// Its lane (g, t) = (lane / 4, lane % 4) holds A elements (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4) and, for each of the eight 8-wide
// n-tiles, D elements (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// Neither k nor n has to follow memory order: here k slot j of MMA kk is
// input channel 4 (j % 4) + 2kk + j / 4 of the k-step, and column j of
// n-tile 2p + q is output channel 16p + 4(j / 2) + 2q + j % 2.
//
// wp: the prepared weights, for each (k-step, 64-wide n-block) the operands
// (hi, lo) x (kk 0, 1), each 2 x 8 core matrices, 8 KB in all.
template <int SUB>
__global__ void __launch_bounds__(NT, 2)
conv3_tf32x3_kernel(const float* __restrict__ x, const float4* __restrict__ wp,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out,
                    int B, int D, int H, int W, int cin, int cout, int relu) {
  constexpr int STAGES = stages(SUB);
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;  // [stage][sub][row][16]
  float* const Bs = smem + STAGES * SUB * A_STAGE;
  float4* const sum =
      reinterpret_cast<float4*>(Bs + STAGES * SUB * B_STAGE) + threadIdx.x;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 4 warps a warpgroup, each 16 rows
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t M = (int64_t)B * D * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // The A rows this thread copies: row (tid / 4) + i * NT / 4, 16-byte part
  // tid % 4.  Per row the address of its own voxel and the taps that stay
  // inside the volume (a row past M has none).
  const int part = tid & 3;
  const float* a_src[A_COPIES];
  uint32_t a_taps[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int64_t m = m0 + (tid >> 2) + i * (NT / 4);
    a_src[i] = x + part * 4;
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

  const int steps_per_tap = cin / BK;
  const int iters = 27 * steps_per_tap / SUB;  // stages to run
  const int64_t b_step = (int64_t)(cout / BN) * (B_STAGE / 4);  // float4s

  // The loader walks the k-steps in order, STAGES - 1 stages ahead of the
  // MMAs: tap, channel block and slot advance by increments, and a tap's
  // offset in x is worked out once a tap.
  auto tap_offset = [&](int tap) {
    return (((tap / 9 - 1) * H + (tap / 3) % 3 - 1) * W + tap % 3 - 1) * cin;
  };
  int ld_left = iters, ld_slot = 0, ld_tap = 0, ld_c = 0;
  int ld_off = tap_offset(0);
  const float4* ld_b = wp + (int64_t)(n0 / BN) * (B_STAGE / 4) + tid;
  auto load_stage = [&]() {
    if (ld_left > 0) {
      --ld_left;
#pragma unroll
      for (int sub = 0; sub < SUB; ++sub) {
        const uint32_t a_dst = smem_u32(As + (ld_slot * SUB + sub) * A_STAGE +
                                        (tid >> 2) * BK + part * 4);
#pragma unroll
        for (int i = 0; i < A_COPIES; ++i) {
          const bool in = (a_taps[i] >> ld_tap) & 1u;
          cp_async16(a_dst + i * (NT / 4) * BK * 4,
                     in ? a_src[i] + ld_off : a_src[i], in ? 16 : 0);
        }
        const uint32_t b_dst =
            smem_u32(Bs + (ld_slot * SUB + sub) * B_STAGE + tid * 4);
#pragma unroll
        for (int i = 0; i < B_COPIES; ++i)
          cp_async16(b_dst + i * NT * 16, ld_b + i * NT, 16);
        ld_b += b_step;
        ld_off += BK;
        if (++ld_c == steps_per_tap) {
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
  for (int s = 0; s < STAGES - 1; ++s) load_stage();  // iters >= 13

  int pending = 0, slot = 0;
  for (int it = 0; it < iters; ++it) {
    // Stage `it` has landed (all but the newest STAGES - 2 groups are done),
    // for every thread after the barrier, and for the async proxy, through
    // which the MMAs read B, after the fence; the barrier also says that
    // every warp is done with the stage before, which is refilled now.
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    load_stage();

    // A stage's 6 SUB wgmmas sum into a fresh partial (scale_d = 0 on the
    // first; the small terms, lo x hi and hi x lo, before the hi x hi ones,
    // so that most of them are added while the partial is small), and the
    // partial is added to the accumulator by an f32 add, which rounds to
    // nearest.  B operands of a k-step: hi kk 0, hi kk 1, lo kk 0, lo kk 1.
    uint32_t ahi[SUB][2][4], alo[SUB][2][4];
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      // rows g and g + 8 of the warp's 16, channels 4t .. 4t + 3
      const float* as =
          As + (slot * SUB + sub) * A_STAGE + (warp * 16 + g) * BK + t * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(as);
      const float4 a1 = *reinterpret_cast<const float4*>(as + 8 * BK);
      const float a[2][4] = {{a0.x, a1.x, a0.y, a1.y},
                             {a0.z, a1.z, a0.w, a1.w}};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[sub][kk][e] = to_tf32(a[kk][e]);
          alo[sub][kk][e] =
              to_tf32(a[kk][e] - __uint_as_float(ahi[sub][kk][e]));
        }
    }
    wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const float* bs = Bs + (slot * SUB + sub) * B_STAGE;
      wgmma_tf32(psum, alo[sub][0], b_desc(bs), sub);
      wgmma_tf32(psum, ahi[sub][0], b_desc(bs + 2 * B_MAT), 1);
      wgmma_tf32(psum, alo[sub][1], b_desc(bs + B_MAT), 1);
      wgmma_tf32(psum, ahi[sub][1], b_desc(bs + 3 * B_MAT), 1);
    }
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const float* bs = Bs + (slot * SUB + sub) * B_STAGE;
      wgmma_tf32(psum, ahi[sub][0], b_desc(bs), 1);
      wgmma_tf32(psum, ahi[sub][1], b_desc(bs + B_MAT), 1);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += psum[i];
    if (++slot == STAGES) slot = 0;

    // The second level: every FLUSH k-steps `acc` is added to the tile's
    // running sum, which lives in shared memory, 8 float4 a thread, each
    // thread its own; after the last k-step the sum comes back into `acc`.
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

  // Epilogue: affine, ReLU, one 16-byte store per 4 channels.
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int n = n0 + p * 16 + t * 4;
    float sc[4], sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = scale ? __ldg(scale + n + j) : 1.f;
      sh[j] = shift ? __ldg(shift + n + j) : 0.f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + warp * 16 + half * 8 + g;
      if (m >= M) continue;
      float v[4] = {acc[8 * p + 2 * half], acc[8 * p + 2 * half + 1],
                    acc[8 * p + 4 + 2 * half], acc[8 * p + 4 + 2 * half + 1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaf(v[j], sc[j], sh[j]);
        if (relu) v[j] = fmaxf(v[j], 0.f);
      }
      *reinterpret_cast<float4*>(out + m * cout + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One float4 of the prepared weights per thread: row r of one core matrix,
// its 4 k values.  k is (27, cin, cout), or with `transposed` (27, cout,
// cin) read as its tap-flipped, in/out-swapped conv:
// w[tap][ci][co] = k[26 - tap][co][ci].
__global__ void prep_kernel(const float* __restrict__ k,
                            float4* __restrict__ wp, int cin, int cout,
                            int transposed, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = idx & 7;
  const int ng = (idx >> 3) & 7;
  const int kc = (idx >> 6) & 1;
  const int kk = (idx >> 7) & 1;
  const int lo = (idx >> 8) & 1;
  const int nb = (idx >> 9) % (cout / BN);
  const int kb = (idx >> 9) / (cout / BN);
  const int tap = kb / (cin / BK);
  const int ci = (kb - tap * (cin / BK)) * BK + 2 * kk + kc;  // + 4e
  const int co =
      nb * BN + (ng >> 1) * 16 + 4 * (r >> 1) + 2 * (ng & 1) + (r & 1);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = transposed
               ? __ldg(k + ((int64_t)(26 - tap) * cout + co) * cin + ci + 4 * e)
               : __ldg(k + ((int64_t)tap * cin + ci + 4 * e) * cout + co);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float hi = tf32_round(v[e]);
    v[e] = lo ? tf32_round(v[e] - hi) : hi;
  }
  wp[idx] = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (3, 3, 3, C_in, C_out) f32 -> wp, the conv kernel's weight operand
// (27 * cin / 16, cout / 64, 512) float4.  cin, cout are those of the
// conv that the kernel will run: with `transposed` (the input gradient)
// cin = C_out and cout = C_in of k.
extern "C" int hp_conv3_mxu_prep(const float* k, float* wp, int cin, int cout,
                                 int transposed, void* stream) {
  const int total = 27 * (cin / BK) * (cout / BN) * 512;
  prep_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      k, reinterpret_cast<float4*>(wp), cin, cout, transposed, total);
  return (int)cudaGetLastError();
}

// x (B, D, H, W, C_in), wp from hp_conv3_mxu_prep, out (B, D, H, W, C_out),
// all f32, contiguous and 16-byte aligned; C_in % 16 == 0, C_out % 64 == 0.
// scale and shift (C_out,) are both null (no affine) or both set.
extern "C" int hp_conv3_mxu_fwd(const float* x, const float* wp,
                                const float* scale, const float* shift,
                                float* out, int B, int D, int H, int W,
                                int cin, int cout, int relu, void* stream) {
  const int64_t M = (int64_t)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), cout / BN);
  auto kernel = cin % (2 * BK) == 0 ? conv3_tf32x3_kernel<2>
                                    : conv3_tf32x3_kernel<1>;
  const int smem = smem_bytes(cin % (2 * BK) == 0 ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const float4*>(wp), scale, shift, out, B, D, H, W,
      cin, cout, relu);
  return (int)cudaGetLastError();
}
