// K9: fused attention, out = softmax(q k^T, axis=-1) v, for q (B, Lq, dh)
// already scaled, k and v (B, Lk, dh).  Scores, the max-subtracted softmax
// and the accumulation are f32.  q and k are f32 or bf16 (together), v is
// f32 or bf16, the output has v's type.
//
// Replaces hiddenpose_tpu/ops/pallas/attn_vmem.py::attend_fused (body
// _attn_kernel): the grouped patch attention of the Sformer (1024 groups of
// Lq 1024, Lk 1048, dh 32 per layer at full width) and of the TimeSformer;
// and, through the split over the keys below, the Sformer's joint-token
// read (8 groups of Lq 24, Lk 131 096), which the TPU router left to XLA.
//
// What bounds it on the card.  The grouped shape is 4*B*Lq*Lk*dh FLOP against
// q + k + v + out bytes, about 260 FLOP per byte, so it is bound by the
// products, provided the (Lq, Lk) score matrix never reaches device memory
// (the plain version writes and re-reads it: 4.4 GB per layer).  The
// joint-token read is 24 rows against 268 MB of keys and values: bound by
// bytes, if enough blocks share the keys to pull them at the card's rate.
//
// The design, for head dim 32 (attend_tc_kernel):
//  - Both products run on the tensor cores with wgmma.  An f32 operand is
//    never given one TF32 pass: it is split into TF32 hi and lo parts with
//    cvt.rna and the product is lo*hi + hi*lo + hi*hi (3xTF32), the small
//    terms first.  bf16 q and k multiply in one exact bf16 pass; with a bf16
//    v the unnormalised probability is rounded to bf16 and p v is one bf16
//    pass (the row sum l is taken before the rounding, as the TPU kernel
//    sums its f32 probabilities).
//  - A block of two warpgroups owns 128 q rows of one group, 64 a warpgroup.
//    k and v pass in tiles of 64 keys through a two-slot shared-memory ring.
//    The B operand of a wgmma lives in shared memory, where nothing can
//    split or transpose it, so a tile is staged through registers: its
//    16-byte global loads are issued before the score products of the tile
//    before, and under that tile's last p v products it is split (hi, lo),
//    v is transposed (p v needs v key-major for 32-bit operands), and both
//    are stored in the wgmma's unswizzled core-matrix order, padded so that
//    the stores hit distinct banks.  One barrier a tile.
//  - q is the A operand, from registers: its fragments are split once and
//    parked in shared memory, each thread its own 16-byte words.
//  - The score accumulator of a thread is the A fragment of p v as it lies:
//    a thread holds keys 2t and 2t + 1 of each 8-key block, and p v's k slot
//    t is defined to be key 2t, slot t + 4 key 2t + 1 (v's tile is stored in
//    that order), so p never passes through shuffles or shared memory.
//  - The online softmax works on a whole 64-key tile: one max, one rescale,
//    base-2 exponentials (ex2.approx of an FMA with log2 e; the running max
//    is kept in base-2 units, so its rounding cancels).  Two blocks a SM, so
//    that one block's exponentials run under another's products.  They
//    overlap only in part (scripts/torch_attn_diag.py at the grouped f32
//    shape: 1.69 ms a call; its products alone 1.15, everything but them
//    0.77), so every instruction saved per score shows: the splits are two
//    integer instructions instead of cvt.rna (a quarter-rate instruction),
//    a lo part is rounded by one add, and p v's fragments are made in
//    rounds, which keeps the kernel free of spills.  Running a tile as two
//    half tiles, so that a warpgroup's own products run under its softmax,
//    cost more instructions than it hid and is not kept.
//  - Sums that round: the tensor core truncates its f32 accumulator.  Each
//    tile's p v goes into fresh partials (scale_d = 0), one for the hi * hi
//    terms and one for the small terms, which are folded into the register
//    accumulator by acc = acc * scale + (big + small) in f32.
//  - Few-row, long-key calls split the keys: when B x (q tiles) blocks
//    cannot fill the card and Lk is long, hp_attend_plan cuts the keys into
//    S chunks (a multiple of the key tile, about 4 blocks a SM), each block
//    writes its rows' (m, l, unnormalised acc) to a workspace, and
//    combine_kernel folds the S partials in chunk order: no atomics, so two
//    calls agree bit for bit.  A chunk is never empty.
//
// Other head dims (dh % 4 == 0 up to 256) keep a SIMT instance of the same
// streaming pipeline (attend_simt_kernel): fp32 FMA, a q row on SPLIT
// adjacent lanes, the next key tile's global loads in flight in registers
// while the current one is multiplied, the same split over the keys.
//
// Ragged Lq and Lk are masked here (a tail key is zero in shared memory and
// scores -inf before the max; a tail row computes on zeros and stores
// nothing).  Every tile holds a real key, so the running max is finite
// after the first tile and exp(-inf - m) is 0, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float L2E = 1.4426950408889634f;
constexpr int SMS = 132;        // the H100's SMs: the split's target
constexpr int MIN_CHUNK = 512;  // fewest keys worth a block of their own

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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x for x <= 0: the special-function unit's approximation (2 ulp), results
// below the normal range flushed to zero.  (exp2f wraps the same
// instruction in a range fix-up that the online softmax never needs: 1.81
// ms a call with it, 1.69 without.)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The probability as the second product sees it: v's precision.
__device__ __forceinline__ float round_like(float p, const float*) {
  return p;
}

__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Where a block's rows go.  One chunk: the normalised output.  More: the
// rows' (m, l) (m in base-2 units: the max score times log2 e) and
// unnormalised accumulator, for combine_kernel.
struct Dest {
  float* acc;  // (B, S, Lq, dh)
  float* ml;   // (B, S, Lq, 2)
  int nsplit;
  int chunk;   // keys a chunk, a multiple of 64
};

// ---- the tensor-core form, head dim 32 -------------------------------------

constexpr int TNT = 256;  // two warpgroups
constexpr int TBQ = 128;  // q rows a block
constexpr int TKT = 64;   // keys a tile
constexpr int TDH = 32;
// p v with an f32 v goes to the tensor cores in PV_ROUNDS rounds of 64 /
// PV_ROUNDS keys, each waited for before the next one's fragments are made:
// 8 fragment registers alive instead of 64, no spills to speak of under the
// 128 registers that two blocks a SM leave (scripts/torch_attn_diag.py:
// 1 round 1.97 ms a call, 2: 2.08, 4: 1.76, 8: 1.69).
constexpr int PV_ROUNDS = 8;
// Shared-memory tiles, in the wgmma's unswizzled K-major order: core
// matrices of 8 rows x 16 bytes, 128 contiguous bytes each.
//  k, f32: [8 dim quads][65 keys][4 floats], hi then lo; the odd key count
//    puts a quarter-warp's 16-byte stores on distinct banks.
//  k, bf16: [4 dim octets][66 keys][8 bf16].
//  v, f32: [16 key quads][4 dim octets][36 floats], hi then lo: key quad
//    2 b + par holds keys 8 b + par + {0, 2, 4, 6}.
//  v, bf16: [8 key octets][4 dim octets][72 bf16].
constexpr int KF_LBO = 65 * 16, KF_PART = 8 * KF_LBO;
constexpr int KH_LBO = 66 * 16, KH_BYTES = 4 * KH_LBO;
constexpr int V_SBO = 144, V_LBO = 4 * V_SBO;
constexpr int VF_PART = 16 * V_LBO, VH_BYTES = 8 * V_LBO;
constexpr int QF_BYTES = 4 * 2 * TNT * 16;  // f32 q: A fragments, hi and lo

__host__ __device__ constexpr int k_bytes(bool f32) {
  return f32 ? 2 * KF_PART : KH_BYTES;
}
__host__ __device__ constexpr int v_bytes(bool f32) {
  return f32 ? 2 * VF_PART : VH_BYTES;
}
constexpr int tc_smem(bool qf, bool vf) {
  return (qf ? QF_BYTES : 0) + 2 * (k_bytes(qf) + v_bytes(vf));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Round to TF32 (10 mantissa bits), to nearest, ties away from zero, bit for
// bit what cvt.rna.tf32.f32 gives, by two integer instructions: the cvt
// runs at a quarter of their rate, and the kernel splits 48 values a thread
// a tile (scripts/torch_attn_diag.py: 1.78 ms a call with cvt, 1.69 so).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: hi = tf32(v), lo = tf32(v - hi) (the difference is
// exact in f32).  The tensor core reads the upper 19 bits of an operand, so
// lo is rounded by adding half a TF32 ulp and left unmasked.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// Makes this thread's shared-memory writes visible to the async proxy,
// through which wgmma reads its B operand.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The descriptor of an unswizzled K-major B operand at shared address
// `addr`: `lbo` bytes between the core matrices along k, `sbo` between those
// along n (both and the address in units of 16 bytes).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define HP_D16(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HP_D32(d)                                                           \
  HP_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define HP_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, {%32, %33, %34, %35}, %36, p"
#define HP_R16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
  "{%16, %17, %18, %19}, %20, p"

// d (64 x N over the warpgroup, f32) = a (64 x k, registers) * b (k x N,
// shared memory) + (scale_d ? d : 0), asynchronous.  TF32: k 8; bf16: k 16.
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HP_R32
      ", 1, 1;\n}\n"
      : HP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HP_R16
      ", 1, 1;\n}\n"
      : HP_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_R32
      ", 1, 1, 0;\n}\n"
      : HP_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HP_R16
      ", 1, 1, 0;\n}\n"
      : HP_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void sts128(unsigned char* p, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

__device__ __forceinline__ void sts64(unsigned char* p, uint32_t a,
                                      uint32_t b) {
  *reinterpret_cast<uint2*>(p) = make_uint2(a, b);
}

// A key tile on its way from device memory to shared memory: the raw
// 16-byte words of this thread's share of k and of v.
struct Staged {
  uint4 k[2];
  uint4 v[2];
};

// Warp w of the block holds q rows 16 w .. 16 w + 15 of the tile: its lane
// (g, t) = (lane / 4, lane % 4) rows g and g + 8.  Of a wgmma's A (64 x 8
// TF32) a thread holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); of
// A (64 x 16 bf16) the pairs (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); of D, for each 8-wide n-tile i, d[4i .. 4i + 3] =
// (g, 8i + 2t), (g, 8i + 2t + 1), (g + 8, 8i + 2t), (g + 8, 8i + 2t + 1).
template <typename TQK, typename TV, bool SPLIT_KEYS>
__device__ __forceinline__ void
attend_tc(const TQK* __restrict__ q, const TQK* __restrict__ k,
          const TV* __restrict__ v, TV* __restrict__ out, const Dest& dst,
          int Lq, int Lk, int ntiles) {
  constexpr bool QF = sizeof(TQK) == 4, VF = sizeof(TV) == 4;
  constexpr int KB = k_bytes(QF), VB = v_bytes(VF);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const qs = smem;
  unsigned char* const ring = smem + (QF ? QF_BYTES : 0);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t group = blockIdx.x / ntiles;
  const int tile = (int)(blockIdx.x - group * ntiles);
  const int split = blockIdx.y;
  const int kbeg = split * dst.chunk;
  const int kend = min(Lk, kbeg + dst.chunk);
  const int nt = (kend - kbeg + TKT - 1) / TKT;
  const int row0 = tile * TBQ + warp * 16 + g, row1 = row0 + 8;
  // a warpgroup none of whose rows exist stages tiles and multiplies nothing
  const bool wg_live = tile * TBQ + (warp >> 2) * 64 < Lq;

  const TQK* kg = k + group * Lk * TDH;
  const TV* vg = v + group * Lk * TDH;
  const TQK* q0 = q + (group * Lq + row0) * TDH;
  const TQK* q1 = q + (group * Lq + row1) * TDH;

  // q's A fragments: f32 split once and parked in shared memory, each
  // thread its own words; bf16 in registers.
  uint32_t qa[2][4];
  if (QF) {
    const float* f0 = reinterpret_cast<const float*>(q0);
    const float* f1 = reinterpret_cast<const float*>(q1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int d = 8 * ks + t;
      const float x[4] = {row0 < Lq ? __ldg(f0 + d) : 0.f,
                          row1 < Lq ? __ldg(f1 + d) : 0.f,
                          row0 < Lq ? __ldg(f0 + d + 4) : 0.f,
                          row1 < Lq ? __ldg(f1 + d + 4) : 0.f};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
      sts128(qs + ((2 * ks) * TNT + tid) * 16, hi[0], hi[1], hi[2], hi[3]);
      sts128(qs + ((2 * ks + 1) * TNT + tid) * 16, lo[0], lo[1], lo[2], lo[3]);
    }
  } else {
    const uint32_t* h0 = reinterpret_cast<const uint32_t*>(q0);
    const uint32_t* h1 = reinterpret_cast<const uint32_t*>(q1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = row0 < Lq ? __ldg(h0 + 8 * ks + t) : 0u;
      qa[ks][1] = row1 < Lq ? __ldg(h1 + 8 * ks + t) : 0u;
      qa[ks][2] = row0 < Lq ? __ldg(h0 + 8 * ks + 4 + t) : 0u;
      qa[ks][3] = row1 < Lq ? __ldg(h1 + 8 * ks + 4 + t) : 0u;
    }
  }

  // This thread's share of a tile.  k, f32: dim quad kq of keys kk and
  // kk + 32; bf16: dim octet kq of key kk.  v, f32: dim quad vq of two keys
  // of key quad vkq (slots 2 vs and 2 vs + 1); bf16: dim pair vq of four
  // keys of key octet vkq (keys 4 vs .. 4 vs + 3).
  const int kq = QF ? tid & 7 : tid & 3;
  const int kk = QF ? tid >> 3 : tid >> 2;
  const int vq = VF ? tid & 7 : tid & 15;
  const int vs = VF ? (tid >> 3) & 1 : (tid >> 4) & 1;
  const int vkq = VF ? tid >> 4 : tid >> 5;

  auto load_tile = [&](int k0, Staged& st) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    if (QF) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + kk + 32 * i;
        st.k[i] = key < kend
                      ? __ldg(reinterpret_cast<const uint4*>(
                            kg + (int64_t)key * TDH + 4 * kq))
                      : zero;
      }
    } else {
      const int key = k0 + kk;
      st.k[0] = key < kend ? __ldg(reinterpret_cast<const uint4*>(
                                 kg + (int64_t)key * TDH + 8 * kq))
                           : zero;
    }
    if (VF) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * (vkq >> 1) + 2 * (2 * vs + e) + (vkq & 1);
        st.v[e] = key < kend
                      ? __ldg(reinterpret_cast<const uint4*>(
                            vg + (int64_t)key * TDH + 4 * vq))
                      : zero;
      }
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * vkq + 4 * vs + e;
        w[e] = key < kend ? __ldg(reinterpret_cast<const uint32_t*>(
                                vg + (int64_t)key * TDH + 2 * vq))
                          : 0u;
      }
      st.v[0] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  auto store_tile = [&](int slot, const Staged& st) {
    unsigned char* ks_ = ring + slot * (KB + VB);
    unsigned char* vs_ = ks_ + KB;
    if (QF) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t x[4] = {st.k[i].x, st.k[i].y, st.k[i].z, st.k[i].w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(x[e]), hi[e], lo[e]);
        unsigned char* p = ks_ + kq * KF_LBO + (kk + 32 * i) * 16;
        sts128(p, hi[0], hi[1], hi[2], hi[3]);
        sts128(p + KF_PART, lo[0], lo[1], lo[2], lo[3]);
      }
    } else {
      sts128(ks_ + kq * KH_LBO + kk * 16, st.k[0].x, st.k[0].y, st.k[0].z,
             st.k[0].w);
    }
    if (VF) {
      const uint32_t x0[4] = {st.v[0].x, st.v[0].y, st.v[0].z, st.v[0].w};
      const uint32_t x1[4] = {st.v[1].x, st.v[1].y, st.v[1].z, st.v[1].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * vq + j;
        uint32_t h0, l0, h1, l1;
        split_tf32(__uint_as_float(x0[j]), h0, l0);
        split_tf32(__uint_as_float(x1[j]), h1, l1);
        unsigned char* p =
            vs_ + vkq * V_LBO + (n >> 3) * V_SBO + (n & 7) * 16 + vs * 8;
        sts64(p, h0, h1);
        sts64(p + VF_PART, l0, l1);
      }
    } else {
      const int n = 2 * vq;
      unsigned char* p =
          vs_ + vkq * V_LBO + (n >> 3) * V_SBO + (n & 7) * 16 + vs * 8;
      sts64(p, __byte_perm(st.v[0].x, st.v[0].y, 0x5410),
            __byte_perm(st.v[0].z, st.v[0].w, 0x5410));
      sts64(p + 16, __byte_perm(st.v[0].x, st.v[0].y, 0x7632),
            __byte_perm(st.v[0].z, st.v[0].w, 0x7632));
    }
  };

  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's

  Staged st;
  if (nt > 0) {
    load_tile(kbeg, st);
    store_tile(0, st);
  }
  fence_proxy_async();
  __syncthreads();

  for (int it = 0; it < nt; ++it) {
    const int slot = it & 1;
    const int k0 = kbeg + it * TKT;
    const uint32_t ks_ = smem_u32(ring + slot * (KB + VB));
    const uint32_t vs_ = ks_ + KB;
    const bool more = it + 1 < nt;
    if (more) load_tile(k0 + TKT, st);  // in flight under the score products

    float s[32];
    if (wg_live) {
      // scores: s = q k^T
      if (QF) {
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint4 h = *reinterpret_cast<const uint4*>(
              qs + ((2 * ks) * TNT + tid) * 16);
          const uint4 l = *reinterpret_cast<const uint4*>(
              qs + ((2 * ks + 1) * TNT + tid) * 16);
          ahi[ks][0] = h.x, ahi[ks][1] = h.y, ahi[ks][2] = h.z, ahi[ks][3] = h.w;
          alo[ks][0] = l.x, alo[ks][1] = l.y, alo[ks][2] = l.z, alo[ks][3] = l.w;
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t b = ks_ + 2 * ks * KF_LBO;
          mma_tf32(s, alo[ks], b_desc(b, KF_LBO, 128), ks > 0);
          mma_tf32(s, ahi[ks], b_desc(b + KF_PART, KF_LBO, 128), 1);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_tf32(s, ahi[ks], b_desc(ks_ + 2 * ks * KF_LBO, KF_LBO, 128), 1);
      } else {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma_bf16(s, qa[ks], b_desc(ks_ + 2 * ks * KH_LBO, KH_LBO, 128),
                   ks > 0);
      }
      wgmma_commit();
      wgmma_wait();

      // the online softmax of the tile, rows g (x) and g + 8 (y)
      if (k0 + TKT > kend) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e >= kend)
              s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, d));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, d));
      }
      // The running max is kept in base-2 units, as rounded: every weight
      // of the row is then 2^(s log2 e - n) for one n per tile, the same
      // n in the rescale, so that n's rounding cancels in acc / l.
      const float n0 = fmaxf(m0, x0 * L2E), n1 = fmaxf(m1, x1 * L2E);
      const float sc0 = ex2(m0 - n0);  // 0 at the first tile
      const float sc1 = ex2(m1 - n1);
      m0 = n0, m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], L2E, -n0));
          s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], L2E, -n1));
          sum0 += s[4 * j + e];
          sum1 += s[4 * j + 2 + e];
        }
      }
      l0 = fmaf(l0, sc0, sum0);
      l1 = fmaf(l1, sc1, sum1);

      // p v into fresh partials; the score registers are its A fragments.
      // With an f32 v the small terms (lo * hi, hi * lo) have a partial of
      // their own: added to the hi * hi sum inside the tensor core, each
      // would cost a truncation at that sum's magnitude.
      float part[16], small[16];
      if (VF) {
#pragma unroll
        for (int r = 0; r < PV_ROUNDS; ++r) {
          constexpr int JR = 8 / PV_ROUNDS;
          uint32_t phi[JR][4], plo[JR][4];
#pragma unroll
          for (int jr = 0; jr < JR; ++jr) {
            const int j = r * JR + jr;
            split_tf32(s[4 * j], phi[jr][0], plo[jr][0]);
            split_tf32(s[4 * j + 2], phi[jr][1], plo[jr][1]);
            split_tf32(s[4 * j + 1], phi[jr][2], plo[jr][2]);
            split_tf32(s[4 * j + 3], phi[jr][3], plo[jr][3]);
          }
          wgmma_fence();
#pragma unroll
          for (int jr = 0; jr < JR; ++jr) {
            const uint32_t b = vs_ + 2 * (r * JR + jr) * V_LBO;
            mma_tf32(small, plo[jr], b_desc(b, V_LBO, V_SBO), r + jr > 0);
            mma_tf32(small, phi[jr], b_desc(b + VF_PART, V_LBO, V_SBO), 1);
            mma_tf32(part, phi[jr], b_desc(b, V_LBO, V_SBO), r + jr > 0);
          }
          if (r + 1 < PV_ROUNDS) {
            wgmma_commit();
            wgmma_wait();
          }
        }
      } else {
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
          pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
          pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
          pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(part, pa[j], b_desc(vs_ + 2 * j * V_LBO, V_LBO, V_SBO),
                   j > 0);
      }
      wgmma_commit();
      // The next tile is split and stored under the last products, into the
      // other slot, which every warp left at the barrier that ended the
      // tile before.
      if (more) store_tile(slot ^ 1, st);
      wgmma_wait();
      if (VF) {
#pragma unroll
        for (int i = 0; i < 16; ++i) part[i] += small[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[4 * i] = fmaf(o[4 * i], sc0, part[4 * i]);
        o[4 * i + 1] = fmaf(o[4 * i + 1], sc0, part[4 * i + 1]);
        o[4 * i + 2] = fmaf(o[4 * i + 2], sc1, part[4 * i + 2]);
        o[4 * i + 3] = fmaf(o[4 * i + 3], sc1, part[4 * i + 3]);
      }
    }
    if (more && !wg_live) store_tile(slot ^ 1, st);
    fence_proxy_async();
    __syncthreads();
  }

  // a row's sum lies on the four lanes of its quad
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Lq) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (!SPLIT_KEYS) {
      const float inv = 1.f / l;
      TV* p = out + (group * Lq + row) * TDH + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store2(p + 8 * i, o[4 * i + 2 * half] * inv,
               o[4 * i + 2 * half + 1] * inv);
    } else {
      const int64_t r = (group * dst.nsplit + split) * Lq + row;
      float* p = dst.acc + r * TDH + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store2(p + 8 * i, o[4 * i + 2 * half], o[4 * i + 2 * half + 1]);
      if (t == 0) store2(dst.ml + 2 * r, m, l);
    }
  }
}

// One body, two entry points, so that a profile tells the grouped form
// (one chunk, normalised rows) from the split over the keys (partial rows).
template <typename TQK, typename TV>
__global__ void __launch_bounds__(TNT, 2)
attend_tc_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                 const TV* __restrict__ v, TV* __restrict__ out, Dest dst,
                 int Lq, int Lk, int ntiles) {
  attend_tc<TQK, TV, false>(q, k, v, out, dst, Lq, Lk, ntiles);
}

template <typename TQK, typename TV>
__global__ void __launch_bounds__(TNT, 2)
attend_tc_split_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                       const TV* __restrict__ v, TV* __restrict__ out,
                       Dest dst, int Lq, int Lk, int ntiles) {
  attend_tc<TQK, TV, true>(q, k, v, out, dst, Lq, Lk, ntiles);
}

// ---- the SIMT form, every other head dim -----------------------------------

constexpr int NT = 128;  // threads per block
constexpr int CH = 8;    // keys per softmax update

// D: head dims per lane (a multiple of 4); SPLIT: lanes per q row (a power
// of two up to 8).  The padded head dim D * SPLIT >= dh; dims >= dh are
// zeros in shared memory and in q, and are not stored.  A lane holds D dims
// of q and of the accumulator as interleaved float4 chunks, so the lanes of
// a row read consecutive 16-byte words of a key (no bank conflict); every
// lane of a warp reads the same key, a broadcast.
template <typename TQK, typename TV, int D, int SPLIT>
__global__ void __launch_bounds__(NT)
attend_simt_kernel(const TQK* __restrict__ q, const TQK* __restrict__ k,
                   const TV* __restrict__ v, TV* __restrict__ out, Dest dst,
                   int Lq, int Lk, int dh, int ntiles) {
  constexpr int DHP = D * SPLIT;        // padded head dim
  constexpr int C4 = DHP / 4;           // float4 chunks per key
  constexpr int NC = D / 4;             // float4 chunks per lane
  constexpr int BQ = NT / SPLIT;        // q rows per block
  constexpr int KT = (2048 / DHP) < 64 ? (2048 / DHP) : 64;  // keys per tile
  constexpr int PER = KT * C4 / NT;     // float4 a thread stages, k and v each
  static_assert(KT % CH == 0 && KT * C4 % NT == 0, "whole chunks and shares");

  __shared__ __align__(16) float Ks[2][KT * DHP];
  __shared__ __align__(16) float Vs[2][KT * DHP];

  const int tid = threadIdx.x;
  const int64_t group = blockIdx.x / ntiles;
  const int tile = (int)(blockIdx.x - group * ntiles);
  const int split = blockIdx.y;
  const int kbeg = split * dst.chunk;
  const int kend = min(Lk, kbeg + dst.chunk);
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

  // The next tile's words wait in registers, converted to f32, while the
  // current tile is multiplied.
  float4 kr[PER], vr[PER];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      const int key = idx / C4;
      const int c = idx - key * C4;
      kr[i] = vr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + key < kend && 4 * c < dh) {
        const int64_t off = (int64_t)(k0 + key) * dh + 4 * c;
        kr[i] = load4(kg + off);
        vr[i] = load4(vg + off);
      }
    }
  };
  auto store_tile = [&](int slot) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      store4(Ks[slot] + 4 * (tid + i * NT), kr[i]);
      store4(Vs[slot] + 4 * (tid + i * NT), vr[i]);
    }
  };

  if (kbeg < kend) {
    load_tile(kbeg);
    store_tile(0);
  }
  __syncthreads();

  int slot = 0;
  for (int k0 = kbeg; k0 < kend; k0 += KT, slot ^= 1) {
    const int nk = min(KT, kend - k0);
    const bool more = k0 + KT < kend;
    if (more) load_tile(k0 + KT);
    const float* ks_ = Ks[slot];
    const float* vs_ = Vs[slot];

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
              ks_ + (j0 + jj) * DHP + 4 * c);
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
      // m is kept in base-2 units, as rounded (see attend_tc)
      const float mn = fmaxf(m, cmax * L2E);
      const float scale = ex2(m - mn);  // 0 at the first chunk
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
        const float p = ex2(fmaf(s[jj], L2E, -mn));
        l += p;
        const float pr = round_like(p, (const TV*)nullptr);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = sub + SPLIT * i;
          const float4 vv = *reinterpret_cast<const float4*>(
              vs_ + (j0 + jj) * DHP + 4 * c);
          acc[i].x = fmaf(pr, vv.x, acc[i].x);
          acc[i].y = fmaf(pr, vv.y, acc[i].y);
          acc[i].z = fmaf(pr, vv.z, acc[i].z);
          acc[i].w = fmaf(pr, vv.w, acc[i].w);
        }
      }
    }
    // the other slot was last read in the tile before, behind a barrier
    if (more) store_tile(slot ^ 1);
    __syncthreads();
  }

  if (!live) return;
  const float inv = dst.nsplit == 1 ? 1.f / l : 1.f;
  const int64_t r = (group * dst.nsplit + split) * Lq + row;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = sub + SPLIT * i;
    if (4 * c >= dh) continue;
    const float4 val = make_float4(acc[i].x * inv, acc[i].y * inv,
                                   acc[i].z * inv, acc[i].w * inv);
    if (dst.nsplit == 1)
      store4(out + (group * Lq + row) * dh + 4 * c, val);
    else
      store4(dst.acc + r * dh + 4 * c, val);
  }
  if (dst.nsplit > 1 && sub == 0) store2(dst.ml + 2 * r, m, l);
}

// out = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s over the S chunks
// of a row (m_s in base-2 units), in chunk order; a thread per (row, 4 dims).
template <typename TV>
__global__ void __launch_bounds__(256)
combine_kernel(Dest dst, TV* __restrict__ out, int64_t rows, int Lq, int dh) {
  const int c4 = dh / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * c4) return;
  const int64_t gr = idx / c4;  // group * Lq + row
  const int c = (int)(idx - gr * c4);
  const int64_t group = gr / Lq;
  const int row = (int)(gr - group * Lq);
  const int64_t r0 = group * dst.nsplit * Lq + row;
  float m = -INFINITY;
  for (int s = 0; s < dst.nsplit; ++s)
    m = fmaxf(m, __ldg(dst.ml + 2 * (r0 + (int64_t)s * Lq)));
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s = 0; s < dst.nsplit; ++s) {
    const int64_t r = r0 + (int64_t)s * Lq;
    const float2 ml = __ldg(reinterpret_cast<const float2*>(dst.ml + 2 * r));
    const float w = ex2(ml.x - m);
    const float4 a = load4(dst.acc + r * dh + 4 * c);
    num.x = fmaf(w, a.x, num.x);
    num.y = fmaf(w, a.y, num.y);
    num.z = fmaf(w, a.z, num.z);
    num.w = fmaf(w, a.w, num.w);
    den = fmaf(w, ml.y, den);
  }
  const float inv = 1.f / den;
  store4(out + gr * dh + 4 * c,
         make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
}

// Lanes a q row is spread over in the SIMT form, by head dim.
constexpr int simt_split(int dh) {
  return dh <= 32 ? 1 : dh <= 64 ? 2 : dh <= 128 ? 4 : 8;
}

// The number of key chunks S and their length: 1 chunk unless the q tiles
// are too few to fill the card and the keys are long; then about four
// blocks a SM, no chunk under MIN_CHUNK keys, a whole number of 64 keys
// (which every form's key tile divides).
int plan(int64_t B, int Lq, int Lk, int dh, int* chunk) {
  const int bq = dh == TDH ? TBQ : NT / simt_split(dh);
  const int64_t blocks = B * ((Lq + bq - 1) / bq);
  int64_t s = 1;
  if (blocks < 2 * SMS) {
    s = (4 * SMS + blocks - 1) / blocks;
    if (s > Lk / MIN_CHUNK) s = Lk / MIN_CHUNK;
    if (s < 1) s = 1;
  }
  const int len = ((int)((Lk + s - 1) / s) + 63) / 64 * 64;
  *chunk = len;
  return (Lk + len - 1) / len;
}

template <typename TQK, typename TV, int D, int SPLIT>
void launch_simt(const void* q, const void* k, const void* v, void* out,
                 Dest dst, int64_t B, int Lq, int Lk, int dh,
                 cudaStream_t stream) {
  constexpr int BQ = NT / SPLIT;
  const int ntiles = (Lq + BQ - 1) / BQ;
  dim3 grid((unsigned)(B * ntiles), dst.nsplit);
  attend_simt_kernel<TQK, TV, D, SPLIT><<<grid, NT, 0, stream>>>(
      (const TQK*)q, (const TQK*)k, (const TV*)v, (TV*)out, dst, Lq, Lk, dh,
      ntiles);
}

template <typename TQK, typename TV>
int dispatch(const void* q, const void* k, const void* v, void* out, Dest dst,
             int64_t B, int Lq, int Lk, int dh, cudaStream_t s) {
  if (dh == TDH) {
    constexpr int smem = tc_smem(sizeof(TQK) == 4, sizeof(TV) == 4);
    auto kernel = dst.nsplit == 1 ? attend_tc_kernel<TQK, TV>
                                  : attend_tc_split_kernel<TQK, TV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int ntiles = (Lq + TBQ - 1) / TBQ;
    dim3 grid((unsigned)(B * ntiles), dst.nsplit);
    kernel<<<grid, TNT, smem, s>>>((const TQK*)q, (const TQK*)k, (const TV*)v,
                                   (TV*)out, dst, Lq, Lk, ntiles);
  } else if (dh <= 8) {
    launch_simt<TQK, TV, 8, 1>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  } else if (dh <= 16) {
    launch_simt<TQK, TV, 16, 1>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  } else if (dh <= 32) {
    launch_simt<TQK, TV, 32, 1>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  } else if (dh <= 64) {
    launch_simt<TQK, TV, 32, 2>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  } else if (dh <= 128) {
    launch_simt<TQK, TV, 32, 4>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  } else {
    launch_simt<TQK, TV, 32, 8>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dst.nsplit == 1) return (int)err;
  const int64_t rows = B * Lq;
  const int64_t threads = rows * (dh / 4);
  combine_kernel<TV><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      dst, (TV*)out, rows, Lq, dh);
  return (int)cudaGetLastError();
}

bool valid(int64_t B, int Lq, int Lk, int dh) {
  return B >= 1 && Lq >= 1 && Lk >= 1 && dh >= 4 && dh <= 256 && dh % 4 == 0 &&
         B * ((Lq + 15) / 16) <= 2147483647LL;
}

}  // namespace

// The number of key chunks S that hp_attend_fwd will use at this shape (1:
// no split), or 0 for a shape it does not take.  With S > 1 the caller
// gives hp_attend_fwd a workspace of S * B * Lq * (dh + 2) floats.
extern "C" int hp_attend_plan(long long B, int Lq, int Lk, int dh) {
  if (!valid(B, Lq, Lk, dh)) return 0;
  int chunk;
  return plan(B, Lq, Lk, dh, &chunk);
}

// The length of hp_attend_plan's chunks (keys, a multiple of 64), 0 for a
// shape the kernel does not take.
extern "C" int hp_attend_chunk(long long B, int Lq, int Lk, int dh) {
  if (!valid(B, Lq, Lk, dh)) return 0;
  int chunk;
  plan(B, Lq, Lk, dh, &chunk);
  return chunk;
}

// q (B, Lq, dh), k and v (B, Lk, dh), out (B, Lq, dh), contiguous and
// 16-byte aligned, with dh % 4 == 0 and dh <= 256.  qk_bf16 / v_bf16 say
// whether q and k / v and out are bf16 (else f32); bf16 q and k with an f32
// v is not taken.  ws: hp_attend_plan's workspace (f32, 16-byte aligned),
// or null where the plan is one chunk.
extern "C" int hp_attend_fwd(const void* q, const void* k, const void* v,
                             void* out, void* ws, long long B, int Lq, int Lk,
                             int dh, int qk_bf16, int v_bf16, void* stream) {
  if (!valid(B, Lq, Lk, dh)) return (int)cudaErrorInvalidValue;
  Dest dst;
  dst.nsplit = plan(B, Lq, Lk, dh, &dst.chunk);
  if (dst.nsplit > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  dst.acc = (float*)ws;
  dst.ml = dst.acc + (int64_t)dst.nsplit * B * Lq * dh;
  cudaStream_t s = (cudaStream_t)stream;
  if (!qk_bf16 && !v_bf16)
    return dispatch<float, float>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  if (qk_bf16 && v_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, dst, B, Lq, Lk,
                                                  dh, s);
  if (!qk_bf16 && v_bf16)
    return dispatch<float, __nv_bfloat16>(q, k, v, out, dst, B, Lq, Lk, dh, s);
  return (int)cudaErrorInvalidValue;
}
