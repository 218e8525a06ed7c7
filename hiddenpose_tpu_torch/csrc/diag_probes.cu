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
// What bounds them: nothing worth the name.  Each moves or multiplies well
// under a megabyte, so a run is a launch (a few microseconds); the byte and
// FLOP bounds are far below that.  They are written for exactness and for
// exercising the access pattern, not for speed.

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
// out (M, N) = a (M, K) @ b (K, N): a 64 x 64 output tile per block of 256
// threads, 4 x 4 outputs per thread, 16-deep k-slices through shared
// memory, fp32 FMA in k order (no TF32, no tensor cores).
constexpr int GM = 64, GN = 64, GK = 16;

__global__ void __launch_bounds__(256)
probe_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[GK][GM + 1];
  __shared__ float Bs[GK][GN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int i = tid; i < GM * GK; i += 256) {
      const int r = i / GK, c = i % GK;
      As[c][r] = (m0 + r < M && k0 + c < K)
                     ? a[(int64_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < GK * GN; i += 256) {
      const int r = i / GN, c = i % GN;
      Bs[r][c] = (k0 + r < K && n0 + c < N)
                     ? b[(int64_t)(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
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

// a (M, K), b (K, N) -> out (M, N), all f32 and contiguous.
extern "C" int hp_probe_dot_f32(const float* a, const float* b, float* out,
                                int M, int K, int N, void* stream) {
  dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  probe_dot_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a, b, out, M, K, N);
  return (int)cudaGetLastError();
}
