// Probe kernels of the stem conv's building blocks: tiny kernels, each held
// against a numpy / torch expression, that check one operation
// csrc/stem_conv.cu relies on (gathering im2col patches through shared
// memory, reading a lane half of a tile and transposing it, an f32 FMA
// matrix product).
//
// Replace the four pallas_calls of scripts/tpu_diag_stem_paired.py
// (check_a :57, check_b :89, check_c :109 and :126), which isolated the op
// of the TPU's paired-lane stem kernel that its compiler mis-lowered.
//
// What bounds them: each moves or multiplies well under a megabyte, so the
// byte and FLOP bounds are a few microseconds and a run is mostly a launch.
// A and B are written for exactness and for exercising the access pattern.
// C is also written to fill the card: small output tiles give hundreds of
// blocks, and its k-slices arrive by cp.async while the FMAs of the slice
// before run, so that its launch is no slower than the library's matmul.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- A: the paired im2col store ------------------------------------------
// x (CIN, TD+4, TH+4, 128) -> patches (2*5*CIN, NC, 128).  One block per
// (ah, aw) tap: it gathers its CIN x NC x 128 slab into shared memory with
// the probe's addressing (sub-tile row d2*TH + h, lane half lsb*64 + w),
// then stores the slab with coalesced 16-byte writes.
constexpr int CIN = 8, TD = 4, TH = 4, NC = TD / 2 * TH, LANES = 128;
constexpr int XD = TD + 4, XH = TH + 4;

__global__ void __launch_bounds__(256)
probe_im2col_kernel(const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(16) float slab[];  // [CIN][NC][LANES]
  const int ah = blockIdx.x / 5, aw = blockIdx.x % 5;
  for (int i = threadIdx.x; i < CIN * NC * LANES; i += blockDim.x) {
    const int lane = i % LANES;
    const int col = (i / LANES) % NC;
    const int cin = i / (LANES * NC);
    const int lsb = lane / 64, w = lane % 64;
    const int d2 = col / TH, h = col % TH;
    const int dd = 2 * d2 + lsb;
    slab[i] = __ldg(x + ((cin * XD + ah + dd) * XH + ah + h) * LANES + aw + w);
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(
      out + (int64_t)blockIdx.x * CIN * NC * LANES);
  const float4* src = reinterpret_cast<const float4*>(slab);
  for (int i = threadIdx.x; i < CIN * NC * LANES / 4; i += blockDim.x)
    dst[i] = src[i];
}

// ---- B: lane-half slice + transpose ---------------------------------------
// x (M, N) -> lo = x[:, :N/2]^T, hi = x[:, N/2:]^T, each (N/2, M), through a
// 32 x 33 shared tile (the pad column keeps the transposed read off one
// bank).  blockIdx.z picks the half.
constexpr int TT = 32;

__global__ void __launch_bounds__(TT * 8)
probe_slice_transpose_kernel(const float* __restrict__ x,
                             float* __restrict__ lo, float* __restrict__ hi,
                             int M, int N) {
  __shared__ float tile[TT][TT + 1];
  const int half = N / 2;
  const int c0 = blockIdx.x * TT, r0 = blockIdx.y * TT;
  const int lane0 = blockIdx.z * half;
  for (int j = threadIdx.y; j < TT; j += 8) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < M && c < half) tile[j][threadIdx.x] = x[(int64_t)r * N + lane0 + c];
  }
  __syncthreads();
  float* out = blockIdx.z ? hi : lo;
  for (int j = threadIdx.y; j < TT; j += 8) {
    const int c = c0 + j, r = r0 + threadIdx.x;
    if (r < M && c < half) out[(int64_t)c * M + r] = tile[threadIdx.x][j];
  }
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

// x (8, 8, 8, 128) f32 -> out (80, 8, 128) f32, both contiguous.
extern "C" int hp_probe_im2col(const float* x, float* out, void* stream) {
  probe_im2col_kernel<<<10, 256, CIN * NC * LANES * sizeof(float),
                        (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

// x (M, N) f32 with N even -> lo, hi (N/2, M) f32.
extern "C" int hp_probe_slice_transpose(const float* x, float* lo, float* hi,
                                        int M, int N, void* stream) {
  const int half = N / 2;
  dim3 grid((half + TT - 1) / TT, (M + TT - 1) / TT, 2);
  probe_slice_transpose_kernel<<<grid, dim3(TT, 8), 0, (cudaStream_t)stream>>>(
      x, lo, hi, M, N);
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
