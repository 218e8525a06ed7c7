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
// the same kernel (F32OUT) serves a check against float64, and the input
// gradient of the f32 model's 'default'-precision train step.
//
// K4-dx-bf16: the same kernel on the spatially flipped, in/out-swapped
// taps (the weight preparation's `transposed` flag folds both in) is the
// Bottleneck conv2's dx at the JAX train step's default precision
// (conv3mxu.py::_conv3_bwd into conv3_mxu at compute_dtype 'bf16'): dz and
// the taps rounded to bf16, one bf16 pass, f32 sums, an f32 (F32OUT, the
// f32 model) or bf16 (the bf16 model) result.  A dx is the forward's conv
// with C_in and C_out swapped, so everything below holds for it as it is.
//
// What bounds it on the card: an implicit GEMM, M = B*D*H*W output voxels,
// N = C_out, K = 27*C_in, hundreds of FLOP per byte, so bf16 MMA issue
// (6.67e11 FLOP for one t128 batch-2 forward's eleven calls, 0.67 ms at
// 989 TFLOP/s).  Before it, what the SMs copy from L2 into shared memory:
// an implicit GEMM that gathers A per tap copies each input voxel 27 times
// per 64 output channels, and one that reads B per 128-row tile copies
// the weights once per 128 voxels; at about 24 bytes a clock an SM, that
// traffic alone caps such a kernel at a quarter of the bf16 peak.  So:
//  - A tile is 256 output voxels of one output plane, TH x TW (8 x 32,
//    16 x 16 or 32 x 8: the wrapper picks the one that W fills), by 64
//    output channels.  Its work is cut into stages of one input plane kd
//    and 32 input channels: the stage's (TH + 2) x (TW + 2) halo of that
//    plane (64 bytes a voxel) is copied into shared memory once, by one
//    TMA box of a tensor map over x that reads zeros outside the volume,
//    with the B operands of its nine (kh, kw) taps, one bulk copy of a
//    contiguous 36 KB run of the prepared weights.  The nine taps read
//    their A rows from the one halo: L2-to-shared traffic for A falls from
//    27x the input to 3 x 1.3x, for B by half.  The kd planes outside the
//    volume are skipped.
//  - wgmma m64n64k16 bf16, four warpgroups a block, each an 8 x 8 patch of
//    the tile, A from registers (a halo row at any tap offset is a legal A
//    row), B from shared memory by descriptor.  k slot k of k-step s is
//    input channel 8 ((k % 8) / 2) + 4s + 2 (k / 8) + k % 2 of the stage's
//    32, so a lane's A of both k-steps is one 16-byte shared-memory read
//    per row (channels 8t .. 8t + 7), and no conversion.  A lane's rows g
//    and g + 8 are one column, H rows y and y + 1, so its four reads of a
//    kw feed the kw's three taps (12 reads a stage, not 18).  Two
//    neighbouring voxels of the halo are 64 bytes apart: the eight lanes
//    of one read phase hit 32 distinct banks.  A read is issued once the
//    MMAs that last read its registers are done, while the others run.
//  - A ring of 3 stages, two in flight while one is multiplied.  Thread 0
//    issues a stage's two copies once every warp has left the slot (the
//    slot's empty mbarrier, one arrival a warp); they complete on its full
//    mbarrier, which every warp waits for: no barrier of the block, 18 MMAs
//    a warpgroup a stage.  One persistent block a SM walks its tiles, the
//    copies running on across tiles.  The layer's input is rounded to bf16
//    by the caller in a separate pass (after bn1 and ReLU in f32): a copy
//    moves bytes and cannot round.
//  - f32 sums that round to nearest.  The tensor core truncates its f32
//    accumulator, so the 18 MMAs of a stage (9 taps x 2 k-steps: 288
//    products a partial) sum into a fresh partial (scale_d = 0 on the
//    first), which an f32 add puts into the register accumulator: 3 C_in /
//    32 partials in all.
//  - 176 KB of shared memory, 512 threads: one block a SM.
//  - Epilogue: column r of n-tile 4p + q is output channel 32p + 8(r / 2) +
//    2q + r % 2, so a lane's accumulators of four n-tiles are 8
//    consecutive channels: affine, ReLU, one rounding (cvt), one 16-byte
//    store.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BK = 32;        // input channels of a stage
constexpr int WG = 4;         // warpgroups a block, each 64 rows
constexpr int NT = 128 * WG;
constexpr int BM = 64 * WG;   // output voxels of a block's tile
constexpr int BN = 64;        // the wgmma's n
constexpr int STAGES = 3;
constexpr int HALO_MAX = 10 * 34;  // (TH + 2) (TW + 2) of 8 x 32, 32 x 8
constexpr int A_STAGE = HALO_MAX * BK;    // bf16
constexpr int TAP_B = 2 * 16 * BN;        // bf16: a tap's two k-steps
constexpr int B_STAGE = 9 * TAP_B;        // bf16: the stage's nine taps
constexpr int B_ROWS = B_STAGE * 2 / 16;  // 16-byte rows of a stage's B
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2 + 16 * STAGES;

// A tile of the call: batch b, output plane d, the th x tw voxels at (h0,
// w0), output channels 64 nb on; tiles are numbered W-tile fastest, then
// H-tile, plane, batch, n-block (tile_at decodes one n-block's index).
struct Tile {
  int b, d, h0, w0, nb;
};

__device__ __forceinline__ Tile tile_at(int i, int D, int tiles_h,
                                        int tiles_w, int th, int tw) {
  Tile u;
  u.w0 = (i % tiles_w) * tw;
  i /= tiles_w;
  u.h0 = (i % tiles_h) * th;
  i /= tiles_h;
  u.d = i % D;
  u.b = i / D;
  u.nb = 0;
  return u;
}

// x: the tensor map of the input, (C_in, W, H, B D) bf16, box (32, tw + 2,
// th + 2, 1).  wp: the prepared weights, for each stage (kd, 32-channel
// block c) and 64-wide n-block its nine taps' B (kh, kw), each two
// k-steps of 2 x 8 core matrices, 36 KB in all.  Persistent blocks: block
// i takes tiles i, i + gridDim.x, ...; its loader (thread 0) runs
// STAGES - 1 stages ahead of the MMAs across tiles, so a tile's first
// stages land while the last one is multiplied and its epilogue runs.
template <bool F32OUT>
__global__ void __launch_bounds__(NT, 1)
conv3_bf16_kernel(const __grid_constant__ CUtensorMap x,
                  const uint4* __restrict__ wp,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, void* __restrict__ out,
                  int B, int D, int H, int W, int cin, int cout, int relu,
                  int th, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* const As = reinterpret_cast<uint16_t*>(smem);  // [st][voxel][32]
  uint16_t* const Bs = As + STAGES * A_STAGE;              // [st][tap][...]
  // a slot's mbarriers: full (its copies have landed), empty (every warp
  // is done reading it)
  const uint32_t full = smem_u32(Bs + STAGES * B_STAGE);
  const uint32_t empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // 4 warps a warpgroup, each 16 rows
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hp = tw + 2;           // halo voxels a row
  const int tiles_w = (W + tw - 1) / tw;
  const int tiles_h = (H + th - 1) / th;
  const int per_nb = B * D * tiles_h * tiles_w;  // tiles of one n-block
  const int ntiles = per_nb * (cout / BN);
  const int c32 = cin / BK;
  const int nblocks = cout / BN;
  const uint32_t a_bytes = (th + 2) * hp * BK * 2;  // a stage's halo
  // the stages of a tile: input plane d + kd - 1 for the kd inside the
  // volume, then 32-channel block c
  auto kd_lo = [&](const Tile& u) { return u.d == 0 ? 1 : 0; };
  auto kd_hi = [&](const Tile& u) { return u.d == D - 1 ? 2 : 3; };
  auto tile = [&](int i) {
    Tile u = tile_at(i % per_nb, D, tiles_h, tiles_w, th, tw);
    u.nb = i / per_nb;
    return u;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The loader, thread 0: tile ld_i, stage (ld_kd, ld_c); a stage is the
  // halo of input plane d + kd - 1, channels 32c .. 32c + 31 (one box of
  // the tensor map, zero outside the volume) and its B (one bulk copy).
  int ld_i = blockIdx.x, ld_slot = 0, ld_kd = 0, ld_c = 0, ld_j = 0;
  Tile ld;
  if (tid == 0 && ld_i < ntiles) {
    ld = tile(ld_i);
    ld_kd = kd_lo(ld);
  }
  auto load_stage = [&]() {
    if (tid == 0 && ld_i < ntiles) {
      // stage ld_j refills the slot of stage ld_j - STAGES: once every warp
      // is done with it
      if (ld_j >= STAGES)
        mbar_wait(empty + 8 * ld_slot, ((ld_j / STAGES) + 1) & 1);
      ++ld_j;
      const uint32_t bar = full + 8 * ld_slot;
      mbar_expect(bar, a_bytes + B_STAGE * 2);
      tma_load(smem_u32(As + ld_slot * A_STAGE), &x, ld_c * BK, ld.w0 - 1,
               ld.h0 - 1, ld.b * D + ld.d + ld_kd - 1, bar);
      bulk_load(smem_u32(Bs + ld_slot * B_STAGE),
                wp + ((int64_t)(ld_kd * c32 + ld_c) * nblocks + ld.nb) * B_ROWS,
                B_STAGE * 2, bar);
      if (++ld_slot == STAGES) ld_slot = 0;
      if (++ld_c == c32) {
        ld_c = 0;
        if (++ld_kd == kd_hi(ld)) {
          ld_i += gridDim.x;
          if (ld_i < ntiles) {
            ld = tile(ld_i);
            ld_kd = kd_lo(ld);
          }
        }
      }
    }
  };

  // The rows of this lane: warpgroup wg owns the tile's 8 x 8 patch wg,
  // warp w its rows 2w and 2w + 1; the lane's rows g and g + 8 are the
  // tile voxels (y0, x0) and (y0 + 1, x0), whose tap (kh, kw) reads halo
  // voxels (y0 + kh, x0 + kw) and (y0 + kh + 1, x0 + kw).
  const int y0 = (wg / (tw / 8)) * 8 + 2 * warp;
  const int x0 = (wg % (tw / 8)) * 8 + g;
  const int a_base = (y0 * hp + x0) * BK + t * 8;

  float acc[32], psum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage();

  // The MMAs: tile ci, its stage `left` stages from the end; `use` counts
  // the stages of the block (the mbarrier's phase).
  int ci = blockIdx.x, slot = 0, use = 0;
  int left = 0;
  if (ci < ntiles) {
    const Tile u = tile(ci);
    left = (kd_hi(u) - kd_lo(u)) * c32;
  }
  while (ci < ntiles) {
    // Thread 0 refills the slot of the stage before once every warp is done
    // with it; stage `use` has landed once its full mbarrier's phase has
    // completed.  No barrier: a warp runs ahead until a slot it needs.
    load_stage();
    mbar_wait(full + 8 * slot, (use / STAGES) & 1);
    __syncwarp();  // the MMAs below are warp-collective

    // The nine taps, kw by kw.  Tap (kh, kw)'s A of both k-steps (rows g
    // and g + 8, channels 8t .. 8t + 7) is halo rows y0 + kh and y0 + kh + 1
    // at column x0 + kw, so the four 16-byte loads L[0..3] of a kw feed its
    // three taps, two MMAs each, a commit group a tap.  L[i] was last read
    // by taps i - 1 and i of the kw before (or of the stage before): it is
    // reloaded once those MMAs are done, while the others run.  All 18 MMAs
    // of the stage sum into one fresh partial.
    const uint16_t* const as = As + slot * A_STAGE + a_base;
    const uint16_t* const bs = Bs + slot * B_STAGE;
    uint4 L[4];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == 0) {
          wgmma_wait<2>();
        } else if (i < 3) {
          wgmma_wait<1>();
        }
        L[i] = *reinterpret_cast<const uint4*>(as + (i * hp + kw) * BK);
        if (i == 0) continue;
        const int kh = i - 1;
        const uint32_t a0[4] = {L[kh].x, L[i].x, L[kh].y, L[i].y};
        const uint32_t a1[4] = {L[kh].z, L[i].z, L[kh].w, L[i].w};
        const uint16_t* const b = bs + (kh * 3 + kw) * 2 * 16 * BN;
        wgmma_fence();
        wgmma_bf16(psum, a0, desc_bf16(b, 1024, 128), kh + kw > 0);
        wgmma_bf16(psum, a1, desc_bf16(b + 16 * BN, 1024, 128), 1);
        wgmma_commit();
      }
    wgmma_wait();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += psum[i];
    if (++slot == STAGES) slot = 0;
    ++use;
    if (--left > 0) continue;

    // Epilogue of tile ci: affine, ReLU, one rounding, one 16-byte store
    // per 8 channels (two for the f32 form).
    const Tile u = tile(ci);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = u.nb * BN + 32 * p + 8 * t;
      float sc[8], sh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = scale ? __ldg(scale + n + j) : 1.f;
        sh[j] = shift ? __ldg(shift + n + j) : 0.f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = u.h0 + y0 + half, w = u.w0 + x0;
        if (h >= H || w >= W) continue;
        const int64_t o =
            ((((int64_t)u.b * D + u.d) * H + h) * W + w) * cout + n;
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
              reinterpret_cast<float4*>(static_cast<float*>(out) + o);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + o) =
              make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                         bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    ci += gridDim.x;
    if (ci < ntiles) {
      const Tile next = tile(ci);
      left = (kd_hi(next) - kd_lo(next)) * c32;
    }
  }
}

// One 16-byte row of the prepared weights per thread: row r of core matrix
// (kc, ng) of k-step s of tap (kh, kw) of (stage (kd, c), n-block), its 8
// k values e, k slot 8 kc + e = input channel 32c + 8 (e / 2) + 4s + 2kc +
// e % 2, at output channel 32 (ng / 4) + 8 (r / 2) + 2 (ng % 4) + r % 2 of
// the block.  cin and cout are the conv's that the kernel runs; with
// `transposed`, k is (3, 3, 3, cout, cin), the weights of the forward conv
// whose dx this is, and tap t of the prepared weights reads its tap 26 - t
// (the flip of kd, kh and kw) with the channels swapped.
__global__ void prep_bf16_kernel(const uint16_t* __restrict__ k,
                                 uint4* __restrict__ wp, int cin, int cout,
                                 int transposed, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = idx & 7;
  const int ng = (idx >> 3) & 7;
  const int kc = (idx >> 6) & 1;
  const int s = (idx >> 7) & 1;
  int rest = idx >> 8;
  const int khw = rest % 9;
  rest /= 9;
  const int nb = rest % (cout / BN);
  rest /= cout / BN;
  const int c = rest % (cin / BK);
  const int tap = (rest / (cin / BK)) * 9 + khw;
  const int ci0 = c * BK + 4 * s + 2 * kc;
  const int co =
      nb * BN + 32 * (ng >> 2) + 8 * (r >> 1) + 2 * (ng & 3) + (r & 1);
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + 8 * q + h;  // e = 2q + h
      const int64_t at =
          transposed ? ((int64_t)(26 - tap) * cout + co) * cin + ci
                     : ((int64_t)tap * cin + ci) * cout + co;
      pair |= (uint32_t)__ldg(k + at) << (16 * h);
    }
    v[q] = pair;
  }
  wp[idx] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (3, 3, 3, C_in, C_out) bf16 (with `transposed`: (3, 3, 3, C_out,
// C_in), taps flipped and channels swapped on the way) -> wp, the conv
// kernel's weight operand (3 kd, cin / 32, cout / 64, 9 taps, 256) uint4,
// 16-byte aligned.
extern "C" int hp_conv3_mxu_bf16_prep(const void* k, void* wp, int cin,
                                      int cout, int transposed,
                                      void* stream) {
  const int total = 27 * (cin / BK) * (cout / BN) * 256;
  prep_bf16_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(k), static_cast<uint4*>(wp), cin, cout,
      transposed, total);
  return (int)cudaGetLastError();
}

// x (B, D, H, W, C_in) bf16; k (3, 3, 3, C_in, C_out) bf16 (with
// transposed: (3, 3, 3, C_out, C_in), the forward weights of a dx), which
// the call lays out into wp (as hp_conv3_mxu_bf16_prep) before the conv;
// out (B, D, H, W, C_out) bf16 (f32 with f32_out); all contiguous and
// 16-byte aligned; C_in % 32 == 0, C_out % 64 == 0.  scale and shift
// (C_out,) f32 are both null (no affine) or both set.  The integers come
// as one array, p = {B, D, H, W, C_in, C_out, relu, f32_out, th, tw,
// transposed}: the tile th x tw is 256 voxels, 8 x 32, 16 x 16 or 32 x 8
// (ops/kernels/conv3mxu.py::bf16_tile).
extern "C" int hp_conv3_mxu_bf16_fwd(const void* x, const void* k, void* wp,
                                     const float* scale, const float* shift,
                                     void* out, const int* p, void* stream) {
  const int B = p[0], D = p[1], H = p[2], W = p[3], cin = p[4], cout = p[5];
  const int relu = p[6], f32_out = p[7], th = p[8], tw = p[9];
  const int transposed = p[10];
  if (th * tw != BM || (th + 2) * (tw + 2) > HALO_MAX || tw % 8 != 0 ||
      th % 8 != 0)
    return (int)cudaErrorInvalidValue;
  int err = hp_conv3_mxu_bf16_prep(k, wp, cin, cout, transposed, stream);
  if (err) return err;
  if ((err = find_encode_tiled())) return err;
  // x as (C_in, W, H, B D): a box of 32 channels x (tw + 2) x (th + 2) x 1
  // plane lands in shared memory as the halo [hy][wx][32] of one stage
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B * D};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                 (cuuint64_t)H * W * cin * 2};
  const cuuint32_t box[4] = {BK, (cuuint32_t)tw + 2, (cuuint32_t)th + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(x), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  const int64_t tiles = (int64_t)B * D * ((H + th - 1) / th) *
                        ((W + tw - 1) / tw) * (cout / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  auto kernel = f32_out ? conv3_bf16_kernel<true> : conv3_bf16_kernel<false>;
  if ((err = (int)cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)))
    return err;
  kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      map, static_cast<const uint4*>(wp), scale, shift, out, B, D, H, W, cin,
      cout, relu, th, tw);
  return (int)cudaGetLastError();
}
