// Probe kernels of the stem kernels' building blocks: tiny kernels, each
// held against a numpy / torch expression, that isolate on an exact case an
// operation the stem convs rely on today (csrc/stem_conv_bf16.cu and
// csrc/conv3mxu_bf16.cu: tensor-map (TMA) box copies that complete on
// mbarriers, a halo whose first lane is not 16-byte aligned, tensor-map
// stores; a tile transposed in shared memory under the 128-byte swizzle,
// as K2-bf16's stmatrix .trans epilogue writes it; csrc/stem_conv.cu's f32
// products).
//
// Replace the four pallas_calls of scripts/tpu_diag_stem_paired.py
// (check_a :57, check_b :89, check_c :109 and :126), which isolated the op
// of the TPU's paired-lane stem kernel that its compiler mis-lowered.
//
// What bounds them: each moves or multiplies well under a megabyte, so the
// byte and FLOP bounds are a fraction of a microsecond and a run is mostly
// the launch and one round trip to memory.  A and B move their data with
// the copy engine alone: no thread reads or writes an element of x,
// patches, lo or hi (B's ragged shapes excepted, below).  C is written to
// fill the card: small output tiles give hundreds of blocks, and its
// k-slices arrive by cp.async while the FMAs of the slice before run, so
// that its launch is no slower than the library's matmul.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "wgmma_tf32.cuh"

namespace {

// ---- A: the paired im2col store by box copies ------------------------------
// x (CIN, TD+4, TH+4, 128) -> patches (2*5*CIN, NC, 128).  Both tensors are
// 4-D tensor maps, innermost first: x as (128 lanes, XH rows, XD planes,
// CIN), patches as (128 lanes, TH rows, NC/TH sub-tiles, 80 patch rows).
// Every (ah, aw, dd) piece of the patch matrix is a box of x at (aw, ah,
// ah + dd, cin0) -- 64 lanes x TH rows x 1 plane x some channels -- stored
// as the box of patches at (64 lsb, 0, d2, (5 ah + aw) CIN + cin0).  The
// plan (the boxes' coordinates and shape) is made in Python
// (ops/kernels/probes.py::im2col_plan); a block takes BOXES_PER_BLOCK
// consecutive boxes of it.
//
// The copy engine starts a box only at a 16-byte boundary of the innermost
// dimension: a load at lane aw = 1, 2 or 3 stops the H100 with an illegal
// instruction.  So, as a halo load meets it, each box is loaded from lane
// aw & ~3, SHIFT lanes wider, and the block's threads move its rows by
// aw & 3 lanes into the store box in shared memory; no thread touches x or
// the patches.  Each box's load is issued at once by a thread of its own
// and completes on an mbarrier of its own, so a block's boxes are in
// flight together; its stores leave when all have been moved.  With the
// plan's 2 channels a box, 2 boxes a block give 80 blocks, each with half
// an (ah, aw, dd) piece in flight (PERF.md, probe A:
// scripts/torch_probe_variants.py times other plans).
constexpr int CIN = 8, TD = 4, TH = 4, NC = TD / 2 * TH, LANES = 128;
constexpr int XD = TD + 4, XH = TH + 4, ROWS = 2 * 5 * CIN;
constexpr int SHIFT = 4;  // floats in 16 bytes: the load's extra lanes
constexpr int BOXES_PER_BLOCK = 2;
constexpr int IM2COL_THREADS = 128;
constexpr int BOX_SMEM = 48 * 1024;  // a block's slots, at most

__host__ __device__ constexpr uint32_t round128(uint32_t bytes) {
  return (bytes + 127) & ~127u;
}

// Box i of the block: its load (lanes + SHIFT wide) into load slot i, its
// rows moved by its lane start's remainder into store slot i, its store.
// `lanes`: the store box's width; `rows`: its other three extents' product.
__global__ void __launch_bounds__(IM2COL_THREADS)
probe_im2col_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap pmap,
                    const int* __restrict__ coords, int lanes, int rows) {
  extern __shared__ unsigned char raw_slots[];
  __shared__ __align__(8) uint64_t full[BOXES_PER_BLOCK];
  const int tid = threadIdx.x;
  const int* plan = coords + 8 * blockIdx.x * BOXES_PER_BLOCK;
  const uint32_t load_bytes = 4u * (lanes + SHIFT) * rows;
  const uint32_t load_slot = round128(load_bytes);
  const uint32_t store_slot = round128(4u * lanes * rows);
  // every slot starts on a multiple of 128 bytes
  const uint32_t base = round128(smem_u32(raw_slots));
  const uint32_t stores = base + BOXES_PER_BLOCK * load_slot;
  if (tid < BOXES_PER_BLOCK) {
    const int* c = plan + 8 * tid;
    const uint32_t bar = smem_u32(&full[tid]);
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect(bar, load_bytes);
    tma_load(base + tid * load_slot, &xmap, __ldg(c) & ~(SHIFT - 1),
             __ldg(c + 1), __ldg(c + 2), __ldg(c + 3), bar);
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits
  const float* ld = reinterpret_cast<const float*>(
      raw_slots + (base - smem_u32(raw_slots)));
  float* st = reinterpret_cast<float*>(raw_slots +
                                       (stores - smem_u32(raw_slots)));
  for (int i = 0; i < BOXES_PER_BLOCK; ++i) {
    mbar_wait(smem_u32(&full[i]), 0);
    const int shift = __ldg(plan + 8 * i) & (SHIFT - 1);
    const float* src = ld + i * (load_slot / 4);
    float* dst = st + i * (store_slot / 4);
    for (int e = tid; e < lanes * rows; e += IM2COL_THREADS) {
      const int r = e / lanes, w = e % lanes;
      dst[e] = src[r * (lanes + SHIFT) + shift + w];
    }
  }
  fence_proxy_async();  // the moved rows, for the stores' reads
  __syncthreads();
  if (tid < BOXES_PER_BLOCK) {
    const int* c = plan + 8 * tid;
    tma_store(&pmap, __ldg(c + 4), __ldg(c + 5), __ldg(c + 6), __ldg(c + 7),
              stores + tid * store_slot);
    bulk_commit();
    bulk_wait_all();  // the slot stays in shared memory until it is written
  }
}

// ---- B: lane-half slice + transpose through the swizzle -------------------
// x (M, N) -> lo = x[:, :N/2]^T, hi = x[:, N/2:]^T, each (N/2, M).  A block
// of 2 TR threads takes a tile of TR rows x 32 columns of one half
// (blockIdx.z): one tensor-map box with the 128-byte swizzle, so row r's
// 16-byte piece p lies at 128 r + 16 (p ^ r % 8).  Each thread moves a 4 x 4
// block (rows 4 rb.., columns 4 cb..) of a 32 x 32 sub-tile: four 16-byte
// reads, a transpose in registers, four 16-byte writes into the store box
// of lo or hi under the same swizzle.  8 consecutive threads form a phase
// of a 16-byte access; thread i of phase q takes rb = i, cb = i ^ q, so the
// 8 pieces a phase reads (cb ^ (4 rb + k) % 8) and writes
// (rb ^ (4 cb + k) % 8) lie in 8 distinct bank groups: no bank conflict and
// no pad column.  One thread then stores the TR / 32 boxes of 32 x 32.
// TR = 32 read fastest of 32, 64 and 128 on the H100 (PERF.md, probe B:
// scripts/torch_probe_variants.py).
//
// TMA needs a tensor's row stride in multiples of 16 bytes (x's is 4 N,
// lo's and hi's 4 M) and a box's first column on a 16-byte boundary (hi's
// tiles start at column N/2 of x).  A side that misses either (TMA_IN false
// where N % 8, TMA_OUT false where M % 4; the wrapper decides by the
// shape) moves its elements by threads instead, into or out of the same
// swizzled tiles.
constexpr int TR = 32;         // x rows a tile
constexpr int TC = 32;         // x columns a tile: 128 bytes, the swizzle's
                               // span
constexpr int SUB = TC * 128;  // bytes of a 32 x 32 sub-tile

__device__ __forceinline__ int swz(int row, int piece) {
  return row * 128 + 16 * (piece ^ (row & 7));
}

template <bool TMA_IN, bool TMA_OUT>
__global__ void __launch_bounds__(2 * TR)
probe_slice_transpose_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap lomap,
                             const __grid_constant__ CUtensorMap himap,
                             const float* __restrict__ x,
                             float* __restrict__ lo, float* __restrict__ hi,
                             int M, int N) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full;
  // the 128-byte swizzle repeats every 1024 bytes: both tiles start on one
  unsigned char* a = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  unsigned char* b = a + TR * 128;
  const int half = N / 2;
  const int c0 = blockIdx.x * TC, r0 = blockIdx.y * TR;
  const int lane0 = blockIdx.z * half;
  const int tid = threadIdx.x;

  if (TMA_IN) {
    const uint32_t bar = smem_u32(&full);
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect(bar, TR * 128);  // the whole box, rows past M read as 0
      tma_load(smem_u32(a), &xmap, lane0 + c0, r0, 0, 0, bar);
    }
    __syncthreads();  // the mbarrier is initialised before anyone waits
    mbar_wait(bar, 0);
  } else {
    for (int i = tid; i < TR * TC; i += 2 * TR) {
      const int r = i / TC, c = i % TC;
      const bool in = r0 + r < M && c0 + c < half;
      *reinterpret_cast<float*>(a + swz(r, c / 4) + 4 * (c % 4)) =
          in ? x[(int64_t)(r0 + r) * N + lane0 + c0 + c] : 0.f;
    }
    __syncthreads();
  }

  {
    const int s = tid / 64, q = tid / 8 % 8, rb = tid % 8, cb = rb ^ q;
    float v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 t = *reinterpret_cast<const float4*>(
          a + swz(32 * s + 4 * rb + k, cb));
      v[k][0] = t.x, v[k][1] = t.y, v[k][2] = t.z, v[k][3] = t.w;
    }
    unsigned char* sub = b + s * SUB;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sub + swz(4 * cb + j, rb)) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
  }

  if (TMA_OUT) {
    fence_proxy_async();  // the threads' writes, for the stores' reads
    __syncthreads();
    if (tid == 0) {
      const CUtensorMap* map = blockIdx.z ? &himap : &lomap;
      for (int s = 0; s < TR / 32 && r0 + 32 * s < M; ++s)
        tma_store(map, r0 + 32 * s, c0, 0, 0, smem_u32(b + s * SUB));
      bulk_commit();
      bulk_wait_all();
    }
  } else {
    __syncthreads();
    float* out = blockIdx.z ? hi : lo;
    for (int i = tid; i < TR * TC; i += 2 * TR) {
      const int j = i / TR, r = i % TR;  // out row c0 + j, column r0 + r
      if (c0 + j < half && r0 + r < M)
        out[(int64_t)(c0 + j) * M + r0 + r] = *reinterpret_cast<const float*>(
            b + (r / 32) * SUB + swz(j, r % 32 / 4) + 4 * (r % 4));
    }
  }
}

// A row-major f32 (rows, cols) tensor as a 4-D tensor map (cols, rows, 1,
// 1) with a box of (box_cols, box_rows, 1, 1); 0 or a cudaError_t.
int encode_2d(CUtensorMap* map, const float* t, int rows, int cols,
              int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t row = (cuuint64_t)cols * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<float*>(t), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---- C: f32 SIMT matrix product ------------------------------------------
// out (M, N) = a (M, K) @ b (K, N), fp32 FMA (no TF32, no tensor cores).
// A block owns a 16 x 16 output tile: at (512, 1024) @ (1024, 128) that is
// 256 blocks on the card's 132 SMs, 128 at N = 64.  Its 256 threads are four
// groups of 64 (2 x 2 outputs a thread); each group takes a quarter of every
// 128-deep k-slice, so a SM holds 16 warps to hide the shared-memory
// latency, and the four partial tiles are summed through shared memory in
// group order: every output is the same chains of fmaf and the same three
// additions in every call, so a reading repeats bit for bit.  The k-slices
// of a and b pass through a two-slot shared-memory ring filled by cp.async,
// 16 bytes a copy where K and N are multiples of 4 and the pointers are
// 16-byte aligned (VEC), else 4; a copy that would leave a or b has source
// size 0, which writes zeros.
constexpr int GM = 16, GN = 16, GK = 128, GT = 256, GROUPS = 4;
constexpr int LDA = GK + 4;  // rows 2 apart land 8 banks apart
constexpr int LDB = GN;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = in ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(GT)
probe_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int M, int K, int N) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  __shared__ __align__(16) float As[2][GM * LDA];
  __shared__ __align__(16) float Bs[2][GK * LDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int group = tid / 64;
  const int tx = tid % 8, ty = tid / 8 % 8;

  // Slice `s` of a and b into slot s % 2.  A masked copy keeps a valid
  // address (the tensor's first element) and reads nothing.
  auto load = [&](int s) {
    const int k0 = s * GK;
    float* as = As[s & 1];
    float* bs = Bs[s & 1];
    for (int i = tid; i < GM * GK / W; i += GT) {
      const int r = i / (GK / W), c = (i % (GK / W)) * W;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async(as + r * LDA + c, in ? a + (int64_t)(m0 + r) * K + k0 + c : a,
               in, 4 * W);
    }
    for (int i = tid; i < GK * GN / W; i += GT) {
      const int r = i / (GN / W), c = (i % (GN / W)) * W;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async(bs + r * LDB + c, in ? b + (int64_t)(k0 + r) * N + n0 + c : b,
               in, 4 * W);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[2][2] = {};
  const int slices = (K + GK - 1) / GK;
  load(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load(s + 1);  // lands while slice s is multiplied
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int kg = group * (GK / GROUPS);  // this group's part of the slice
    const float* as = As[s & 1] + 2 * ty * LDA + kg;
    const float* bs = Bs[s & 1] + kg * LDB + 2 * tx;
#pragma unroll 4
    for (int kk = 0; kk < GK / GROUPS; kk += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk);
      const float4 a1 = *reinterpret_cast<const float4*>(as + LDA + kk);
      const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w},
                              {a1.x, a1.y, a1.z, a1.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bs + (kk + e) * LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][0] = fmaf(av[i][e], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i][e], bv.y, acc[i][1]);
        }
      }
    }
    __syncthreads();  // the slot is refilled two slices on
  }
  // groups 1-3 hand their partial tiles to group 0, which adds them in order
  __shared__ float4 red[GROUPS - 1][64];
  if (group > 0)
    red[group - 1][tid % 64] =
        make_float4(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
  __syncthreads();
  if (group > 0) return;
  for (int g = 0; g < GROUPS - 1; ++g) {
    const float4 r = red[g][tid];
    acc[0][0] += r.x, acc[0][1] += r.y, acc[1][0] += r.z, acc[1][1] += r.w;
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + 2 * ty + i, n = n0 + 2 * tx + j;
      if (m < M && n < N) out[(int64_t)m * N + n] = acc[i][j];
    }
}

}  // namespace

// x (8, 8, 8, 128) f32 -> out (80, 8, 128) f32, both contiguous and 16-byte
// aligned.  box: the store boxes' shape (lanes, rows, planes, channels or
// patch rows), 4 host ints; the loads are SHIFT lanes wider.  coords:
// n_boxes x 8 device ints, each box's coordinates on x's map (lane, row,
// plane, channel) then on patches' (lane, row, sub-tile, patch row)
// (ops/kernels/probes.py::im2col_plan).
extern "C" int hp_probe_im2col(const float* x, float* out, const int* box,
                               const int* coords, int n_boxes, void* stream) {
  if (n_boxes < 1 || n_boxes % BOXES_PER_BLOCK || box[0] < 1 ||
      box[0] + SHIFT > LANES || (box[0] * 4) % 16)
    return (int)cudaErrorInvalidValue;
  const int rows = box[1] * box[2] * box[3];
  const uint32_t slots = round128(4u * (box[0] + SHIFT) * rows) +
                         round128(4u * box[0] * rows);
  if (128 + BOXES_PER_BLOCK * slots > BOX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (const int e = find_encode_tiled()) return e;
  const cuuint32_t load_box[4] = {(cuuint32_t)box[0] + SHIFT,
                                  (cuuint32_t)box[1], (cuuint32_t)box[2],
                                  (cuuint32_t)box[3]};
  const cuuint32_t store_box[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                                   (cuuint32_t)box[2], (cuuint32_t)box[3]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint64_t row = LANES * 4;
  CUtensorMap xmap, pmap;
  const cuuint64_t xdims[4] = {LANES, XH, XD, CIN};
  const cuuint64_t xstrides[3] = {row, row * XH, row * XH * XD};
  const cuuint64_t pdims[4] = {LANES, TH, NC / TH, ROWS};
  const cuuint64_t pstrides[3] = {row, row * TH, row * NC};
  if (encode_tiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<float*>(x), xdims, xstrides, load_box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode_tiled(&pmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, pdims,
                   pstrides, store_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  probe_im2col_kernel<<<n_boxes / BOXES_PER_BLOCK, IM2COL_THREADS,
                        128 + BOXES_PER_BLOCK * slots,
                        (cudaStream_t)stream>>>(xmap, pmap, coords, box[0],
                                                rows);
  return (int)cudaGetLastError();
}

// x (M, N) f32 with N even -> lo, hi (N/2, M) f32, all contiguous and 16-byte
// aligned.  tma_in: x's tiles arrive by tensor-map boxes (needs N % 8 == 0),
// else by the threads; tma_out: lo's and hi's leave by tensor-map boxes
// (needs M % 4 == 0), else by the threads.
extern "C" int hp_probe_slice_transpose(const float* x, float* lo, float* hi,
                                        int M, int N, int tma_in, int tma_out,
                                        void* stream) {
  const int half = N / 2;
  if (M < 1 || N < 2 || N % 2 || (tma_in && N % 8) || (tma_out && M % 4))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {}, lomap = {}, himap = {};
  if (tma_in || tma_out) {
    if (const int e = find_encode_tiled()) return e;
  }
  if (tma_in) {
    if (const int e = encode_2d(&xmap, x, M, N, TC, TR,
                                CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
  }
  if (tma_out) {
    if (const int e = encode_2d(&lomap, lo, half, M, 32, TC,
                                CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
    if (const int e = encode_2d(&himap, hi, half, M, 32, TC,
                                CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
  }
  auto kernel = tma_in ? (tma_out ? probe_slice_transpose_kernel<true, true>
                                  : probe_slice_transpose_kernel<true, false>)
                       : (tma_out ? probe_slice_transpose_kernel<false, true>
                                  : probe_slice_transpose_kernel<false, false>);
  const dim3 grid((half + TC - 1) / TC, (M + TR - 1) / TR, 2);
  // the x tile and its transposed sub-tiles, from a 1024-byte boundary
  const int smem = 1024 + 2 * TR * 128;
  kernel<<<grid, 2 * TR, smem, (cudaStream_t)stream>>>(
      xmap, lomap, himap, x, lo, hi, M, N);
  return (int)cudaGetLastError();
}

// a (M, K), b (K, N) -> out (M, N), all f32 and contiguous; any M, K, N.
extern "C" int hp_probe_dot_f32(const float* a, const float* b, float* out,
                                int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  if (vec)
    probe_dot_kernel<true><<<grid, GT, 0, (cudaStream_t)stream>>>(a, b, out, M,
                                                                  K, N);
  else
    probe_dot_kernel<false><<<grid, GT, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                   M, K, N);
  return (int)cudaGetLastError();
}
