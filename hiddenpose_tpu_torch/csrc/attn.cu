// K9: fused short-sequence attention, out = softmax(q k^T, axis=-1) v, for
// q (B, Lq, dh) already scaled, k and v (B, Lk, dh).  Scores, the
// max-subtracted softmax and the accumulation are f32; f32 inputs use fp32
// FMA only (no TF32, no tensor cores).  q and k are f32 or bf16 (together),
// v is f32 or bf16, the output has v's type.
//
// Replaces hiddenpose_tpu/ops/pallas/attn_vmem.py::attend_fused (body
// _attn_kernel): the grouped patch attention of the Sformer (1024 groups of
// Lq 1024, Lk 1048, dh 32 per layer at full width) and of the TimeSformer.
//
// What bounds it on the card: 4*B*Lq*Lk*dh FLOP against q + k + v + out
// bytes is about 260 FLOP per byte at the Sformer's shape, so with f32 SIMT
// arithmetic the fp32 FMA rate bounds it, provided the (Lq, Lk) score matrix
// never reaches device memory (the plain version writes and re-reads it:
// 4.4 GB per layer).  The TPU kernel holds one group's whole k^T, v and
// score tile in its fast memory; a block here has 227 KB of shared memory
// and one group's k and v alone are 268 KB, so the design is the streaming
// one: a block owns a tile of q rows of one group, k and v pass through
// shared memory in tiles of KT keys (converted to f32 while staging), and
// the softmax is the online one (running max m and running sum l per row,
// the accumulator rescaled by exp(m_old - m_new) once per chunk of 8 keys).
// A q row belongs to SPLIT adjacent lanes, each holding D of the head's
// dims (as interleaved float4 chunks, so the lanes of a row read
// consecutive 16-byte words of a key: no bank conflict) of q and of the
// accumulator in registers; a score is D FMAs per lane and log2(SPLIT)
// shuffles.  Every lane of a warp reads the same key, so a shared-memory
// load is a broadcast.  Ragged Lk and Lq are masked here (a tail key's score
// is -inf before the max; a tail row computes on zeros and stores nothing):
// no padded or transposed copy of k is made on the host.  The running max
// is finite after the first chunk (a chunk always holds a real key), so
// exp(-inf - m) is 0 and never NaN.
//
// When v is bf16 the unnormalised probability exp(s - m) is rounded to bf16
// before it multiplies v, as the TPU kernel casts its probabilities to v's
// type; the row sum l is taken before the rounding, as there.  (The TPU
// kernel rounds the normalised probability: the two differ by the rounding
// of one bf16 factor, inside the bf16 tolerance.)
//
// Later work: bf16 operands on mma.sync or wgmma; two q rows per lane to
// halve the shared-memory loads per FMA; splitting the keys across blocks
// for few-row, long-key calls (the joint-token read), which stay on the
// library path today.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int CH = 8;    // keys per softmax update

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The probability as the second product sees it: v's precision.
__device__ __forceinline__ float round_like(float p, const float*) {
  return p;
}

__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// D: head dims per lane (a multiple of 4); SPLIT: lanes per q row (a power
// of two up to 8).  The padded head dim D * SPLIT >= dh; dims >= dh are
// zeros in shared memory and in q, and are not stored.
template <typename TQK, typename TV, int D, int SPLIT>
__global__ void __launch_bounds__(NT)
attend_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
              const TV* __restrict__ v, TV* __restrict__ out, int Lq, int Lk,
              int dh, int ntiles) {
  constexpr int DHP = D * SPLIT;        // padded head dim
  constexpr int C4 = DHP / 4;           // float4 chunks per key
  constexpr int NC = D / 4;             // float4 chunks per lane
  constexpr int BQ = NT / SPLIT;        // q rows per block
  constexpr int KT = (4096 / DHP) < 64 ? (4096 / DHP) : 64;  // keys per tile
  static_assert(KT % CH == 0, "a key tile is whole chunks");

  __shared__ __align__(16) float Ks[KT * DHP];
  __shared__ __align__(16) float Vs[KT * DHP];

  const int tid = threadIdx.x;
  const int64_t group = blockIdx.x / ntiles;
  const int tile = (int)(blockIdx.x - group * ntiles);
  const int sub = tid % SPLIT;                 // which lane of the row
  const int row = tile * BQ + tid / SPLIT;     // q row inside the group
  const bool live = row < Lq;

  const TQK* kg = k + group * Lk * dh;
  const TV* vg = v + group * Lk * dh;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = sub + SPLIT * i;
    qr[i] = (live && 4 * c < dh)
                ? load4(q + (group * Lq + row) * dh + 4 * c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += KT) {
    const int nk = min(KT, Lk - k0);
    __syncthreads();  // the previous tile has been read
    for (int idx = tid; idx < KT * C4; idx += NT) {
      const int key = idx / C4;
      const int c = idx - key * C4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < nk && 4 * c < dh) {
        const int64_t off = (int64_t)(k0 + key) * dh + 4 * c;
        kk = load4(kg + off);
        vv = load4(vg + off);
      }
      store4(Ks + key * DHP + 4 * c, kk);
      store4(Vs + key * DHP + 4 * c, vv);
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = sub + SPLIT * i;
#pragma unroll
        for (int jj = 0; jj < CH; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(
              Ks + (j0 + jj) * DHP + 4 * c);
          s[jj] = fmaf(qr[i].x, kk.x, s[jj]);
          s[jj] = fmaf(qr[i].y, kk.y, s[jj]);
          s[jj] = fmaf(qr[i].z, kk.z, s[jj]);
          s[jj] = fmaf(qr[i].w, kk.w, s[jj]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
#pragma unroll
        for (int o = 1; o < SPLIT; o <<= 1)
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], o);
        if (j0 + jj >= nk) s[jj] = -INFINITY;  // the ragged tail of Lk
        cmax = fmaxf(cmax, s[jj]);
      }
      const float mn = fmaxf(m, cmax);
      const float scale = expf(m - mn);  // 0 at the first chunk (m = -inf)
      m = mn;
      l *= scale;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i].x *= scale;
        acc[i].y *= scale;
        acc[i].z *= scale;
        acc[i].w *= scale;
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float p = expf(s[jj] - mn);
        l += p;
        const float pr = round_like(p, (const TV*)nullptr);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + SPLIT * i;
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (j0 + jj) * DHP + 4 * c);
          acc[i].x = fmaf(pr, vv.x, acc[i].x);
          acc[i].y = fmaf(pr, vv.y, acc[i].y);
          acc[i].z = fmaf(pr, vv.z, acc[i].z);
          acc[i].w = fmaf(pr, vv.w, acc[i].w);
        }
      }
    }
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + SPLIT * i;
      if (4 * c < dh)
        store4(out + (group * Lq + row) * dh + 4 * c,
               make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                           acc[i].w * inv));
    }
  }
}

template <typename TQK, typename TV, int D, int SPLIT>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int Lq, int Lk, int dh, cudaStream_t stream) {
  constexpr int BQ = NT / SPLIT;
  const int64_t ntiles = (Lq + BQ - 1) / BQ;
  if (B * ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  attend_kernel<TQK, TV, D, SPLIT><<<(unsigned)(B * ntiles), NT, 0, stream>>>(
      (const TQK*)q, (const TQK*)k, (const TV*)v, (TV*)out, Lq, Lk, dh,
      (int)ntiles);
  return (int)cudaGetLastError();
}

template <typename TQK, typename TV>
int dispatch(const void* q, const void* k, const void* v, void* out, int64_t B,
             int Lq, int Lk, int dh, cudaStream_t s) {
  if (dh <= 8) return launch<TQK, TV, 8, 1>(q, k, v, out, B, Lq, Lk, dh, s);
  if (dh <= 16) return launch<TQK, TV, 16, 1>(q, k, v, out, B, Lq, Lk, dh, s);
  if (dh <= 32) return launch<TQK, TV, 32, 1>(q, k, v, out, B, Lq, Lk, dh, s);
  if (dh <= 64) return launch<TQK, TV, 32, 2>(q, k, v, out, B, Lq, Lk, dh, s);
  if (dh <= 128) return launch<TQK, TV, 32, 4>(q, k, v, out, B, Lq, Lk, dh, s);
  return launch<TQK, TV, 32, 8>(q, k, v, out, B, Lq, Lk, dh, s);
}

}  // namespace

// q (B, Lq, dh), k and v (B, Lk, dh), out (B, Lq, dh), contiguous, with
// dh % 4 == 0 and dh <= 256.  qk_bf16 / v_bf16 say whether q and k / v and
// out are bf16 (else f32); bf16 q and k with an f32 v is not taken.
extern "C" int hp_attend_fwd(const void* q, const void* k, const void* v,
                             void* out, long long B, int Lq, int Lk, int dh,
                             int qk_bf16, int v_bf16, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || dh < 4 || dh > 256 || dh % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qk_bf16 && !v_bf16)
    return dispatch<float, float>(q, k, v, out, B, Lq, Lk, dh, s);
  if (qk_bf16 && v_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, B, Lq, Lk, dh,
                                                  s);
  if (!qk_bf16 && v_bf16)
    return dispatch<float, __nv_bfloat16>(q, k, v, out, B, Lq, Lk, dh, s);
  return (int)cudaErrorInvalidValue;
}
