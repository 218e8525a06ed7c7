// K2-bf16: the stem of the bfloat16 model, Conv3d(1 -> 64, 7^3, pad 3) +
// folded eval BatchNorm (y * scale + shift) + ReLU, from the raw bf16
// (B, D, H, W, 1) volume to the full-resolution NDHWC (B, D, H, W, 64) bf16
// output.
//
// Replaces hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas on
// the bf16 operands the JAX model feeds it (StemS2D casts x and the kernel
// to the compute dtype): one bf16 pass on the matrix unit, exact products,
// f32 sums, the affine and ReLU in f32, the result rounded once to bf16.
// Here: wgmma m64n128k16 bf16, one pass, f32 sums.  An f32-output
// instantiation of the same kernel (F32OUT) serves a check against float64
// only: a bf16 store would hide a fault of the sums.
//
// What bounds it on the card: 343 x 64 multiply-adds per output voxel
// against 2 bytes in and 128 bytes out, so bf16 MMA issue (1.84e11 FLOP for
// (2, 128^3), 2.15e11 with the padding below: 0.217 ms at 989 TFLOP/s)
// beside the 537 MB write (0.160 ms at 3.35 TB/s).  What the design does:
//  - An implicit GEMM with the channels as M and the voxels as N: A is the
//    weights (64 channels x 16 taps a k-step), resident in shared memory
//    for the block's life (50 KB); B is 128 voxels of an output plane, 8 H
//    rows x 16 W columns.  Both come from shared memory by descriptor, so
//    no lane gathers an operand, and one m64n128k16 does the work of two
//    m64n64k16.
//  - A k-step is two (kd, kh) rows of kw 0..7: rows 2j and 2j + 1 of the
//    49 (kd, kh) rows, row 49 zero weights, kw 7 zero weights: 25 k-steps
//    a voxel (24.5 would do; 28 if a k-step stayed inside one kd).
//  - The voxels' operand is the expanded halo plane: for each of the tile's
//    halo rows and output columns, one 16-byte row of the 8 inputs its kw
//    taps read (x[.., w - 3 + kw], kw 0..7), 8 of them a 128-byte core
//    matrix.  A k-step's B is then the expanded rows of its two (kd, kh)
//    rows, LBO bytes apart, each 128 voxels at 128 bytes a core matrix.
//    Where a k-step straddles two kd, LBO is the distance to the next
//    plane's slot: the ring of plane slots is mirrored (slots 0..5 are also
//    written at RING + 0..5), so the seven planes of an output plane always
//    lie at seven consecutive slots and every LBO is positive.
//  - A producer warpgroup stages the planes, each of its four warps a
//    plane at a time, so four planes' loads are in flight: a warp reads the
//    raw halo plane from global memory into shared memory (zeros outside
//    the volume), waits for the slot's empty mbarrier (one arrival from
//    each consumer warp once it has multiplied its last output plane that
//    reads the slot), builds each expanded row from five 32-bit words of
//    the raw plane into the slot and arrives on its full mbarrier.  No
//    block barrier: the two consumer warpgroups (the tile's H rows 0..7 and
//    8..15) and the producers each run at their own pace.  One persistent
//    block a SM walks work units of a 16 x 16 column DCHUNK planes deep,
//    each plane staged once, the producers running up to RING - 7 planes
//    ahead, across units too.
//  - f32 sums that round to nearest: the tensor core truncates its f32
//    accumulator, so the k-steps of each of STAGES stages (13 and 12) sum
//    into a fresh partial (scale_d = 0 on the first), which an f32 add
//    puts into the sums.  Fewer, longer stages drain the MMA pipe less
//    often; two partials in flight in turn would need 64 registers more
//    than the 168 that 384 threads allow.
//  - Epilogue: the accumulator's rows are the 64 channels in order, its
//    columns the voxels.  It is transposed into shared memory by stmatrix
//    .trans (16 bytes a voxel's 8 channels) as the output tensor map's box
//    of 64 channels x 16 x 8 voxels with the 128-byte swizzle (so the 8
//    rows of a matrix hit distinct banks), and one thread stores the box by
//    the tensor map (cp.async.bulk.tensor), which writes nothing outside
//    the volume: the 537 MB write leaves the warps' instruction stream and
//    runs under the MMAs.  Two tiles a warpgroup, so a store has a whole
//    plane to read its tile.  A plane's epilogue runs while the first
//    stage of the next plane's MMAs is in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mbarrier.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int K = 7;
constexpr int P = 3;
constexpr int COUT = 64;
constexpr int KSTEPS = 25;
constexpr int TH = 16, TW = 16;          // the block tile
constexpr int NV = 8 * TW;               // voxels of a warpgroup (N)
constexpr int ROWS = TH + K;             // expanded rows of a slot
constexpr int RS = TW * 16;              // bytes of an expanded row
constexpr int PS = ROWS * RS;            // bytes of a plane slot
constexpr int RING = 12;                 // planes in flight
constexpr int SLOTS = RING + K - 1;      // with the mirrored slots
constexpr int DCHUNK = 64;               // output planes of a work unit
constexpr int W_BYTES = KSTEPS * 2048;   // the weights
constexpr int RAW_W = TW + 8;            // a raw halo row: TW + 6, padded
constexpr int RAW = (ROWS - 1) * RAW_W;  // bf16 of a raw halo plane
constexpr int ST_BYTES = NV * 128;       // an output tile: 128 voxels
constexpr int NT = 384;                  // two consumer warpgroups + the
                                         // producer warpgroup
constexpr int OFF_RING = W_BYTES;
constexpr int OFF_RAW = OFF_RING + SLOTS * PS;
constexpr int OFF_BAR = OFF_RAW + 4 * 2 * RAW;  // a raw plane a producer
constexpr int OFF_ST = OFF_BAR + 16 * RING;     // rounded up to 1024 bytes
constexpr int SMEM = OFF_ST + 1024 + 4 * ST_BYTES;
constexpr int PROD_ROWS = (ROWS - 1) * TW / 32;  // a producer lane's rows
constexpr int PROD_RAW = (RAW + 31) / 32;        // ... and raw values
// The stages of a plane: k-steps [stage_at(s), stage_at(s + 1)) sum into
// one fresh f32 partial, which an f32 add puts into the sums.
constexpr int STAGES = 2;
__host__ __device__ constexpr int stage_at(int s) {
  return (s * KSTEPS + STAGES - 1) / STAGES;
}

// The bytes of (kd, kh) row r's expanded row from the slot of the output
// plane's first input plane, for a warpgroup's first output row; row 49
// (the zero weights) reads row 7 of slot 6, a zero row for warpgroup 1.
__host__ __device__ constexpr int row_off(int r) {
  return r < 49 ? (r / 7) * PS + (r % 7) * RS : 6 * PS + 7 * RS;
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// The warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <bool F32OUT>
__global__ void __launch_bounds__(NT, 1)
stem_conv_bf16_kernel(const __grid_constant__ CUtensorMap omap,
                      const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ wp,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, void* __restrict__ out,
                      int D, int H, int W, int relu, int tiles_h, int tiles_w,
                      int chunks, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  // a slot's mbarriers: full (its plane is staged), empty (every consumer
  // warp is done with it)
  const uint32_t full = base + OFF_BAR;
  const uint32_t empty = full + 8 * RING;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;

  for (int i = tid; i < W_BYTES / 16; i += NT)
    cp_async16(reinterpret_cast<float*>(smem) + 4 * i,
               reinterpret_cast<const float*>(wp) + 4 * i, true);
  cp_async_commit();
  // every slot's last row: read only by the zero weights, so only finite
  for (int i = tid; i < SLOTS * RS / 16; i += NT)
    *reinterpret_cast<uint4*>(smem + OFF_RING + (i / (RS / 16)) * PS +
                              (ROWS - 1) * RS + 16 * (i % (RS / 16))) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the weights and zero rows, for the MMAs' reads
  __syncthreads();

  // Work unit u: batch b, the 16 x 16 column at (h0, w0), output planes
  // d0 .. d1 - 1 (the D chunk fastest).
  auto unit_at = [&](int u, int& b, int& h0, int& w0, int& d0, int& d1) {
    const int dc = u % chunks;
    u /= chunks;
    h0 = (u % tiles_h) * TH;
    u /= tiles_h;
    w0 = (u % tiles_w) * TW;
    b = u / tiles_w;
    d0 = dc * DCHUNK;
    d1 = min(d0 + DCHUNK, D);
  };

  if (wg == 2) {
    // The producer warpgroup: its warp pw stages the
    // block's planes q = pw, pw + 4, ... (counted over its units), four
    // planes' loads in flight at once.  Plane q goes to slot q % RING, and
    // to its mirror.  The warp reads the raw halo plane (rows h0 - 3 ..,
    // columns w0 - 3 .., zeros outside the volume) into its own shared
    // memory, waits for the slot's empty mbarrier, then lane l builds the
    // expanded rows l + 32 i (halo row (l + 32 i) / TW, output column
    // (l + 32 i) % TW), each from five 32-bit words of the raw plane.
    const int pw = (tid >> 5) & 3;
    uint16_t* const rp = reinterpret_cast<uint16_t*>(smem + OFF_RAW) +
                         pw * RAW;
    uint32_t q = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int b, h0, w0, d0, d1;
      unit_at(u, b, h0, w0, d0, d1);
      const uint16_t* const xb = x + (int64_t)b * D * H * W;
      for (int p = d0 - P; p < d1 + P; ++p, ++q) {
        if ((q & 3) != pw) continue;
        __syncwarp();  // the warp's last plane is built from rp
#pragma unroll
        for (int i = 0; i < PROD_RAW; ++i) {
          const int idx = lane + 32 * i;
          const int gh = h0 - P + idx / RAW_W, gw = w0 - P + idx % RAW_W;
          if (idx < RAW)
            rp[idx] = p >= 0 && p < D && gh >= 0 && gh < H && gw >= 0 &&
                              gw < W
                          ? __ldg(xb + ((int64_t)p * H + gh) * W + gw)
                          : (uint16_t)0;
        }
        __syncwarp();
        const int slot = q % RING;
        if (q >= RING) mbar_wait(empty + 8 * slot, ((q / RING) - 1) & 1);
#pragma unroll 1
        for (int i = 0; i < PROD_ROWS; ++i) {
          const int idx = lane + 32 * i;
          const int w = idx % TW;
          const uint32_t* const src = reinterpret_cast<const uint32_t*>(
              rp + (idx / TW) * RAW_W + (w & ~1));
          uint32_t e[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) e[k] = src[k];
          const int sh = 16 * (w & 1);
          const uint4 v = make_uint4(__funnelshift_r(e[0], e[1], sh),
                                     __funnelshift_r(e[1], e[2], sh),
                                     __funnelshift_r(e[2], e[3], sh),
                                     __funnelshift_r(e[3], e[4], sh));
          const int off = OFF_RING + slot * PS + 16 * idx;
          *reinterpret_cast<uint4*>(smem + off) = v;
          if (slot < K - 1)
            *reinterpret_cast<uint4*>(smem + off + RING * PS) = v;
        }
        fence_proxy_async();  // the writes, for the MMAs' reads
        mbar_arrive(full + 8 * slot);
      }
    }
  } else {
    // The consumer warpgroups: warpgroup wg multiplies the
    // tile's H rows 8 wg .. 8 wg + 7, its B rows 8 wg expanded rows into
    // each slot.  Lane (g, t) of warp w holds channels c1 = 16w + g and
    // c2 = c1 + 8.
    const int warp = (tid >> 5) & 3;
    const int t = lane & 3;
    const int c1 = 16 * warp + (lane >> 2), c2 = c1 + 8;
    const float sc1 = __ldg(scale + c1), sc2 = __ldg(scale + c2);
    const float sh1 = __ldg(shift + c1), sh2 = __ldg(shift + c2);
    // the warpgroup's two output tiles, 1024-byte aligned for the swizzle
    const uint32_t st =
        ((base + OFF_ST + 1023) & ~1023u) + 2 * wg * ST_BYTES;
    int sb = 0;  // the tile the next epilogue writes
    const uint32_t ring = base + OFF_RING + wg * 8 * RS;

    float acc[64], part[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = part[k] = 0.f;
    // the output plane whose sums acc holds, not yet stored (eb < 0: none)
    int eb = -1, ed = 0, eh = 0, ew = 0;

    // Affine, ReLU, one rounding; acc's voxel 8i + 2t + e of channel c1 is
    // acc[4i + e], of c2 acc[4i + 2 + e].
    auto epilogue = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = e < 2 ? fmaf(acc[4 * i + e], sc1, sh1)
                                : fmaf(acc[4 * i + e], sc2, sh2);
          acc[4 * i + e] = relu ? fmaxf(y, 0.f) : y;
        }
      if (F32OUT) {
        const int64_t plane = ((int64_t)eb * D + ed) * H;
        float* const o = static_cast<float*>(out);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 8 * i + 2 * t + e;
            const int h = eh + v / TW, w = ew + v % TW;
            if (h >= H || w >= W) continue;
            const int64_t at = ((plane + h) * W + w) * COUT;
            o[at + c1] = acc[4 * i + e];
            o[at + c2] = acc[4 * i + 2 + e];
          }
        return;
      }
      // Thread 0 of the warpgroup stored tile sb two epilogues ago: once
      // the store has read it, the warpgroup may write it again.
      if ((tid & 127) == 0) bulk_wait_read<1>();
      warpgroup_sync(1 + wg);
      // The tile as the output tensor map's box (64 channels, 16 W, 8 H)
      // with the 128-byte swizzle: voxel v's 16-byte piece c at byte
      // 128 v + 16 (c ^ v % 8).  Matrix j of stmatrix q is n-tile
      // 2q + j / 2, channels 16 warp + 8 (j % 2) .., piece c = 2 warp +
      // j % 2; transposed, its row r is voxel 8 (2q + j / 2) + r's 8
      // channels, at the address lane 8j + r gives.  The 8 rows of a
      // matrix hit 8 distinct pieces: no bank conflict.
      const int j = lane >> 3, r = lane & 7;
      const uint32_t row = st + sb * ST_BYTES + (8 * (j >> 1) + r) * 128 +
                           16 * ((2 * warp + (j & 1)) ^ r);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        stmatrix_x4_trans(row + 16 * q * 128,
                          bf16_pair(acc[8 * q], acc[8 * q + 1]),
                          bf16_pair(acc[8 * q + 2], acc[8 * q + 3]),
                          bf16_pair(acc[8 * q + 4], acc[8 * q + 5]),
                          bf16_pair(acc[8 * q + 6], acc[8 * q + 7]));
      fence_proxy_async();  // the tile, for the tensor-map store's reads
      warpgroup_sync(1 + wg);
      if ((tid & 127) == 0) {
        tma_store(&omap, 0, ew, eh, eb * D + ed, st + sb * ST_BYTES);
        bulk_commit();
      }
      sb ^= 1;
    };

    // Stage s's k-steps into part; s0 is the shared-memory address of the
    // warpgroup's first B row in the slot of the output plane's first
    // input plane.
    auto stage = [&](int s, uint32_t s0) {
      wgmma_hold(part);
      wgmma_fence();
#pragma unroll
      for (int j = stage_at(s); j < stage_at(s + 1); ++j) {
        const int r0 = row_off(2 * j), lbo = row_off(2 * j + 1) - r0;
        wgmma_bf16_ss(part, desc_bf16(base + 2048 * j, 1024, 128),
                      desc_bf16(s0 + r0, lbo, 128), j > stage_at(s));
      }
      wgmma_commit();
    };

    uint32_t q0 = 0;  // the block's plane count at the unit's first plane
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int b, h0, w0, d0, d1;
      unit_at(u, b, h0, w0, d0, d1);
      const int nout = d1 - d0;
      for (int i = 0; i < nout; ++i) {
        // output plane d0 + i reads planes q0 + i .. q0 + i + 6
        for (uint32_t q = i ? q0 + i + 6 : q0; q <= q0 + i + 6; ++q)
          mbar_wait(full + 8 * (q % RING), (q / RING) & 1);
        const uint32_t s0 = ring + ((q0 + i) % RING) * PS;
        stage(0, s0);
        if (eb >= 0) epilogue();  // the last plane's, under the MMAs
        wgmma_wait();
        wgmma_hold(part);
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[k] = part[k];
#pragma unroll
        for (int s = 1; s < STAGES; ++s) {
          stage(s, s0);
          wgmma_wait();
          wgmma_hold(part);
#pragma unroll
          for (int k = 0; k < 64; ++k) acc[k] += part[k];
        }
        // this warp is done with plane q0 + i
        if (lane == 0) mbar_arrive(empty + 8 * ((q0 + i) % RING));
        eb = b;
        ed = d0 + i;
        eh = h0 + 8 * wg;
        ew = w0;
      }
      // ... and with the unit's last six planes
      if (lane == 0)
        for (uint32_t q = q0 + nout; q < q0 + nout + 6; ++q)
          mbar_arrive(empty + 8 * (q % RING));
      q0 += nout + 6;
    }
    if (eb >= 0) epilogue();
    if (!F32OUT && (tid & 127) == 0) bulk_wait_all();
  }
}

// One 16-byte row of the prepared weights per thread: row r of core matrix
// (half, g) of k-step j, channel 8g + r, its 8 kw of (kd, kh) row 2j + half
// (row 49 and kw 7: zero).
__global__ void stem_weights_bf16_kernel(const uint16_t* __restrict__ k,
                                         uint4* __restrict__ wp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W_BYTES / 16) return;
  const int c = idx & 63;  // 8g + r
  const int row = 2 * (idx >> 7) + ((idx >> 6) & 1);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kw = 2 * e + h;
      const uint32_t w =
          row < K * K && kw < K ? __ldg(k + (row * K + kw) * COUT + c) : 0u;
      pair |= w << (16 * h);
    }
    v[e] = pair;
  }
  wp[idx] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// k (7, 7, 7, 1, 64) DHWIO bf16 -> wp, the conv kernel's weight operand:
// (25, 2, 8, 8, 8) bf16 (k-step, half, channel / 8, channel % 8, kw),
// 16-byte aligned.
extern "C" int hp_stem_conv_bf16_prep(const void* k, void* wp, void* stream) {
  stem_weights_bf16_kernel<<<(W_BYTES / 16 + 255) / 256, 256, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(k), static_cast<uint4*>(wp));
  return (int)cudaGetLastError();
}

// x (B, D, H, W) bf16, wp from hp_stem_conv_bf16_prep, scale/shift (64,)
// f32, out (B, D, H, W, 64) bf16 (f32 with f32_out); all contiguous, wp
// and out 16-byte aligned.
extern "C" int hp_stem_conv_bf16_fwd(const void* x, const void* wp,
                                     const float* scale, const float* shift,
                                     void* out, int B, int D, int H, int W,
                                     int relu, int f32_out, void* stream) {
  auto kernel = f32_out ? stem_conv_bf16_kernel<true>
                        : stem_conv_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  // out as (64, W, H, B D) bf16: a box of 64 channels x 16 x 8 x 1 plane
  // is a warpgroup's output tile, the box's voxels outside the volume not
  // written (the f32 form stores from registers and takes no map)
  CUtensorMap omap = {};
  if (!f32_out) {
    if (const int e = find_encode_tiled()) return e;
    const cuuint64_t dims[4] = {COUT, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B * D};
    const cuuint64_t strides[3] = {COUT * 2, (cuuint64_t)W * COUT * 2,
                                   (cuuint64_t)H * W * COUT * 2};
    const cuuint32_t box[4] = {COUT, TW, 8, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode_tiled(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims,
                     strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int chunks = (D + DCHUNK - 1) / DCHUNK;
  const int units = B * tiles_h * tiles_w * chunks;
  const int grid = units < sms ? units : sms;
  kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      omap, static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wp),
      scale, shift, out, D, H, W, relu, tiles_h, tiles_w, chunks, units);
  return (int)cudaGetLastError();
}
