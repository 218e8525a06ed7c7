// The tile walk shared by K1 (conv3p.cu) and K5 (conv3p_adjoint.cu): a
// 3x3x3 stride-1 stencil over channels-planes volumes (B, C, D, H, W) in
// plain f32 FMAs.
//
//   out[b, cd, o] = epilogue(sum over source channels cs and taps t of
//                            w[cs][t][cd] * src[b, cs, pad(o + t - 1)])
//
// K1 is this on the conv's input with the DHWIO taps as they lie; K5 is
// this on dz with the taps flipped and the channel roles swapped (the
// flip and the swap happen while the taps are staged, so the arithmetic
// below is the forward conv's in both).  With edge padding K5 also folds
// the reads that the replicate pad clamped onto the faces of the volume:
// see FOLD below.
//
// One block owns an (H, W) tile of TH = thr * R rows by TW columns, CB
// destination channels and a run of `chunk` planes along D.  A thread
// owns one column of the tile and R neighbouring rows, for all CB
// channels, and walks down D:
//   - source plane p is staged once, by cp.async (16-byte copies along a
//     row where W % 4 == 0, 4-byte copies for the two halo columns and
//     otherwise; zero fill or a clamped source address for the padding),
//     into a ring of three slots, two units ahead of the FMAs (a deeper
//     ring changed no shape's time).  A
//     unit is one plane of up to `cg` source channels with their 27 x CB
//     taps, so wide convs stage a group of channels at a time; where the
//     taps of all source channels are few (`wres`) they are staged once
//     and stay resident.
//   - plane p feeds the three output planes p + 1, p, p - 1 (taps kd = 0,
//     1, 2), whose sums live in registers in three rotating slots: the
//     (R + 2) x 3 values a thread reads from shared memory feed 27 x R x
//     CB FMAs, the taps come as 16-byte broadcast loads, consecutive lanes
//     read consecutive words.  After plane p the output plane p - 1 is
//     complete and leaves through the epilogue.
//   - the source channels of a unit are dealt to `splits` thread groups
//     (small volumes with wide channels have too few voxels to fill the
//     card otherwise: one block a multiprocessor then holds up to 512
//     threads); their partial sums meet in shared memory and are added in
//     split order, so a result repeats bit for bit.
// The plan (tile, CB, chunk, splits, cg) comes from the caller:
// ops/kernels/conv3p.py::tile_plan.
//
// What bounds it (builds with one part left out, timed by
// scripts/torch_conv3p_tune.py --diag on an NVIDIA H100 80GB HBM3 at 700 W):
// neither pipe alone.  At 8 -> 4 channels @128^3, batch 2, the build without
// staging copies takes 0.22 ms (its FMAs run at 48% of the fp32 peak), the
// build without FMAs 0.13 ms (copies, barriers and epilogue), the build
// without either 0.04 ms, the shipped kernel 0.31 ms: FMAs and copies
// overlap only in part, since a block's warps meet at one barrier a unit.
// The taps' shared-memory loads cost a seventh (constants in their place:
// 0.27 ms); the values' loads nothing.  At one channel each way (34 MB moved,
// 0.010 ms at the memory rate) the kernel takes 0.038 ms, 0.029 without its
// FMAs and 0.015 without its copies too: the latency of a plane's wait,
// barrier and stores, with two blocks a multiprocessor to hide it.
//
// FOLD (K5 under edge padding): dz's tap t of output o lands on input
// clamp(o + t - 1).  Per axis an input on a face of the volume therefore
// takes, beside the three (offset, tap) pairs of a forward conv (whose
// member outside the volume reads the zero halo), one extra pair: its own
// position (offset 1) with the outward tap (staged tap 2 at index 0, 0 at
// index n - 1, both where n == 1).  Along D that is a uniform redirect:
// plane 0's tap that would land on plane -1 adds into plane 0's sums, plane
// D - 1's likewise.  Along H and W the extra pairs multiply out into a few
// more taps on values the thread already holds (own row x three columns,
// three rows x own column, own voxel), run by the lanes on a face only, in
// tiles that touch one (a branch uniform over the block); every other tile
// runs K1's code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "cp_async.cuh"

namespace conv3p_tile {

constexpr int MAX_THREADS = 512;
constexpr int NSLOT = 3;  // staged units: one computed, two in flight
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Args {
  const float* src;        // (B, cs, D, H, W)
  const float* k;          // (3, 3, 3, C_in, C_out), the forward's taps
  const float* bias;       // (cd,) or null
  const float* residual;   // (B, cd, D, H, W) or null
  const float* pre_scale;  // (cs,) with pre_mode
  const float* pre_shift;
  float* out;              // (B, cd, D, H, W)
  int B, cs, cd, D, H, W;
  int k_sc, k_sd;  // strides in k of the source and destination channel
  int flip;        // taps flipped (K5)
  int clamp;       // source halo clamped (K1 under edge padding)
  int act;         // 0 none, 1 relu, 2 leaky(0.2)
  int pre_mode;    // 0 none, 1 affine, 2 affine + relu, before the padding
  int thr, splits, chunk, cg, wres;  // the plan
  int vec, vecw;   // 16-byte copies of the planes / of the taps
  int vect;        // 16-byte loads of the taps along the source channels
  // K1 on bf16 volumes: the source, residual and output as bf16 in place
  // of src, residual and out (the taps, bias and sums stay f32).  A plane
  // is staged as raw bf16 by cp.async, like the f32 planes (16-byte copies
  // of 8 values where vec8: W % 8 == 0), and widened to f32 where the walk
  // reads it into its registers (see BF16 ROWS below).
  const uint16_t* src16 = nullptr;
  const uint16_t* res16 = nullptr;
  uint16_t* out16 = nullptr;
  int vec8 = 0;
};

// Pitch of a staged row: column w0 - 1 at index 3, the tile's own columns
// from index 4 (16-byte aligned), column w0 + TW at TW + 4.  Chosen so
// that the thread rows of one warp (R rows apart) fall into distinct
// banks.
__host__ __device__ constexpr int row_pitch(int tw, int r) {
  return tw == 32 ? 40 : (r == 4 ? 28 : 24);
}

// BF16 ROWS.  A staged bf16 row: column w0 - 1 + xx at index xx + 7, so
// the tile's own columns start at index 8 (16-byte aligned, one cp.async
// of 8 values each), the left halo column is the high half of the 4-byte
// pair (w0 - 2, w0 - 1) copied to index 6 and the right one the low half
// of (w0 + TW, w0 + TW + 1) at TW + 8.  The pitch (bf16 values, a multiple
// of 8) puts the two thread rows of a warp of a 16-wide tile (R rows
// apart) into distinct banks.  Under edge padding a column past a face is
// not staged: a thread reads the clamped column in its place, from the
// tile's own columns or halo.  The pre-affine is applied where a value is
// widened, and a padded position of a zero-padded volume is masked to 0
// after it (the affine precedes the padding).
__host__ __device__ constexpr int row_pitch16(int tw, int r) {
  return tw == 32 ? 48 : (r == 4 ? 40 : 48);
}

// Which faces of the (H, W) plane a thread's outputs lie on: bit rr of lo_h
// / hi_h for its row rr at index 0 / H - 1, lo_w / hi_w for its column.
struct Faces {
  unsigned lo_h, hi_h;
  bool lo_w, hi_w;
};

// What is uniform over a block, and a thread's place in it.
struct Ctx {
  float* smem;   // NSLOT units: cg planes, then the unit's taps unless resident
  int planes_floats;  // the cg planes of a slot (f32, or bf16 in pairs)
  float* wres;   // the resident taps of all source channels
  float* red;    // the splits' partial sums
  int tid, nthreads, lane_w, ty, split, npos;
  int TH, XH, XPLANE, slot_floats;
  int w0, h0, d0, d1, b, dst0;
  int G, pa, pb, nunits;
  bool w_resident, face;
  bool halo_zeroed;  // a zero-padded tile as wide as the volume
  int64_t plane;
};

// Start the copies of unit `u` = (plane pa + u / G, channel group u % G)
// into slot u % NSLOT (no wait).
template <int CB, int TW, int XW, int XW16, bool BF16>
__device__ __forceinline__ void stage(const Args& a, const Ctx& c, int u) {
  const int D = a.D, H = a.H, W = a.W;
  const int tid = c.tid, nthreads = c.nthreads, XH = c.XH;
  const int w0 = c.w0, h0 = c.h0;
  float* xs = c.smem + (u % NSLOT) * c.slot_floats;
  const int gp = min(max(c.pa + u / c.G, 0), D - 1);
  const int c0 = (u % c.G) * a.cg;
  const int nc = min(a.cg, a.cs - c0);
  const int64_t sp_off = (((int64_t)c.b * a.cs + c0) * D + gp) * c.plane;
  const float* sp = BF16 ? nullptr : a.src + sp_off;
  const int64_t cstride = (int64_t)D * c.plane;
  // Staged row `row` = (channel, yy): its source row (h clamped under edge
  // padding) or null where it is zero.
  auto src_row = [&](int row) -> const float* {
    int gh = h0 - 1 + row % XH;
    if (a.clamp) {
      gh = min(max(gh, 0), H - 1);
    } else if (gh < 0 || gh >= H) {
      return nullptr;
    }
    return sp + (row / XH) * cstride + (int64_t)gh * W;
  };
  if constexpr (BF16) {
    // bf16: raw values, widened where the walk reads them (BF16 ROWS)
    uint16_t* const xs16 = reinterpret_cast<uint16_t*>(xs);
    const uint16_t* sp16 = a.src16 + sp_off;
    auto row16 = [&](int row) -> const uint16_t* {
      int gh = h0 - 1 + row % XH;
      if (a.clamp) {
        gh = min(max(gh, 0), H - 1);
      } else if (gh < 0 || gh >= H) {
        return nullptr;
      }
      return sp16 + (row / XH) * cstride + (int64_t)gh * W;
    };
    if (a.vec8) {
      // the tile's own columns, eight at a time: W % 8 == 0, so the eight
      // lie inside the volume together or not at all
      constexpr int QW = TW / 8;
      for (int it = tid; it < nc * XH * QW; it += nthreads) {
        const int row = it / QW, gw = w0 + 8 * (it % QW);
        const uint16_t* src = row16(row);
        const bool in = src != nullptr && gw < W;
        cp_async16((uint32_t)__cvta_generic_to_shared(xs16 + row * XW16 + 8 +
                                                      8 * (it % QW)),
                   in ? src + gw : a.src16, in);
      }
      // the halo columns in their 4-byte pairs (W even: a pair lies inside
      // the volume together or not at all), unless zeroed once for all
      for (int it = tid; it < (c.halo_zeroed ? 0 : nc * XH * 2);
           it += nthreads) {
        const int row = it >> 1;
        const uint16_t* src = row16(row);
        const int gw = (it & 1) ? w0 + TW : w0 - 2;
        const bool in = src != nullptr && gw >= 0 && gw < W;
        cp_async4((uint32_t)__cvta_generic_to_shared(
                      xs16 + row * XW16 + ((it & 1) ? TW + 8 : 6)),
                  in ? src + gw : a.src16, in);
      }
    } else {
      // rows of any width: plain loads of the raw values, zero outside
      for (int it = tid; it < nc * XH * (TW + 2); it += nthreads) {
        const int row = it / (TW + 2), xx = it % (TW + 2);
        const uint16_t* src = row16(row);
        const int gw = w0 - 1 + xx;
        xs16[row * XW16 + xx + 7] =
            src != nullptr && gw >= 0 && gw < W ? __ldg(src + gw) : 0;
      }
    }
  } else if (a.pre_mode) {
    // the pre-affine cannot ride an asynchronous copy: plain loads
    for (int it = tid; it < nc * XH * (TW + 2); it += nthreads) {
      const int row = it / (TW + 2), xx = it % (TW + 2);
      const float* src = src_row(row);
      int gw = w0 - 1 + xx;
      if (a.clamp) gw = min(max(gw, 0), W - 1);
      float v = 0.f;
      if (src != nullptr && gw >= 0 && gw < W) {
        const int ch = c0 + row / XH;
        v = fmaf(src[gw], a.pre_scale[ch], a.pre_shift[ch]);
        if (a.pre_mode == 2) v = fmaxf(v, 0.f);
      }
      xs[row * XW + xx + 3] = v;
    }
  } else if (a.vec) {
    // the tile's own columns, four at a time: W % 4 == 0, so the four lie
    // inside the volume together or not at all
    constexpr int QW = TW / 4;
    for (int it = tid; it < nc * XH * QW; it += nthreads) {
      const int row = it / QW, gw = w0 + 4 * (it % QW);
      float* dst = xs + row * XW + 4 + 4 * (it % QW);
      const float* src = src_row(row);
      if (src != nullptr && gw >= W && a.clamp) {
        // past a ragged tile's last column: its first element is the
        // right neighbour of column W - 1
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(dst + q, src + W - 1, true);
      } else {
        const bool in = src != nullptr && gw < W;
        cp_async16(dst, in ? src + gw : a.src, in);
      }
    }
    // the two halo columns, unless they were zeroed once for all units
    for (int it = tid; it < (c.halo_zeroed ? 0 : nc * XH * 2);
         it += nthreads) {
      const int row = it >> 1;
      const float* src = src_row(row);
      int gw = (it & 1) ? w0 + TW : w0 - 1;
      if (a.clamp) gw = min(max(gw, 0), W - 1);
      const bool in = src != nullptr && gw >= 0 && gw < W;
      cp_async4(xs + row * XW + ((it & 1) ? TW + 4 : 3),
                in ? src + gw : a.src, in);
    }
  } else {
    for (int it = tid; it < nc * XH * (TW + 2); it += nthreads) {
      const int row = it / (TW + 2), xx = it % (TW + 2);
      const float* src = src_row(row);
      int gw = w0 - 1 + xx;
      if (a.clamp) gw = min(max(gw, 0), W - 1);
      const bool in = src != nullptr && gw >= 0 && gw < W;
      cp_async4(xs + row * XW + xx + 3, in ? src + gw : a.src, in);
    }
  }
  // the taps: ws[ch][t][j] = k[t or 26 - t][source c0 + ch][dest dst0 + j]
  // (of this unit's channels; where the taps stay resident, only while the
  // first plane's units are staged)
  if (!c.w_resident || u < c.G) {
    float* ws = c.w_resident ? c.wres + c0 * 27 * CB : xs + c.planes_floats;
    const int wc0 = c0, wn = nc;
    const int64_t tap_stride = (int64_t)a.cs * a.cd;
    if (a.vecw) {
      constexpr int QC = CB >= 4 ? CB / 4 : 1;
      for (int it = tid; it < wn * 27 * QC; it += nthreads) {
        const int j = 4 * (it % QC), ct = it / QC;
        const int t = ct % 27, ch = ct / 27;
        const bool in = c.dst0 + j < a.cd;
        cp_async16(ws + ct * CB + j,
                   in ? a.k + (a.flip ? 26 - t : t) * tap_stride +
                            (int64_t)(wc0 + ch) * a.k_sc + c.dst0 + j
                      : a.k,
                   in);
      }
    } else if (a.vect) {
      // K5: the source channels lie next to each other in k: four a load,
      // stored 27 x CB apart (plain loads: a cp.async cannot scatter)
      for (int it = tid; it < wn / 4 * 27 * CB; it += nthreads) {
        const int j = it % CB, ct = it / CB;
        const int t = ct % 27, ch = 4 * (ct / 27);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c.dst0 + j < a.cd)
          v = *reinterpret_cast<const float4*>(
              a.k + (a.flip ? 26 - t : t) * tap_stride + (wc0 + ch) +
              (int64_t)(c.dst0 + j) * a.k_sd);
        float* dst = ws + (ch * 27 + t) * CB + j;
        dst[0] = v.x;
        dst[27 * CB] = v.y;
        dst[2 * 27 * CB] = v.z;
        dst[3 * 27 * CB] = v.w;
      }
    } else {
      for (int it = tid; it < wn * 27 * CB; it += nthreads) {
        const int j = it % CB, ct = it / CB;
        const int t = ct % 27, ch = ct / 27;
        const bool in = c.dst0 + j < a.cd;
        cp_async4(ws + it,
                  in ? a.k + (a.flip ? 26 - t : t) * tap_stride +
                           (int64_t)(wc0 + ch) * a.k_sc +
                           (int64_t)(c.dst0 + j) * a.k_sd
                     : a.k,
                  in);
      }
    }
  }
}

// One tap plane (9 x CB taps at wc) of the values v into slot SLOT; with
// `fold`, also the extra taps of the outputs on the faces in f.
template <int SLOT, int CB, int R>
__device__ __forceinline__ void taps(float (&acc)[3][R][CB],
                                     const float (&v)[R + 2][3],
                                     const float* wc, bool fold,
                                     const Faces& f) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      float w[CB];
      if (CB >= 4) {
#pragma unroll
        for (int q = 0; q < CB / 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              wc + (kh * 3 + kw) * CB + 4 * q);
          w[4 * q] = w4.x;
          w[4 * q + 1] = w4.y;
          w[4 * q + 2] = w4.z;
          w[4 * q + 3] = w4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CB; ++j) w[j] = wc[(kh * 3 + kw) * CB + j];
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int j = 0; j < CB; ++j)
          acc[SLOT][rr][j] = fmaf(v[rr + kh][kw], w[j], acc[SLOT][rr][j]);
    }
  if (!fold) return;
  // value x the taps at wc + t * CB, into row rr
  auto add = [&](int rr, float x, int t) {
#pragma unroll
    for (int j = 0; j < CB; ++j)
      acc[SLOT][rr][j] = fmaf(x, wc[t * CB + j], acc[SLOT][rr][j]);
  };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int th = e == 0 ? 2 : 0;  // the outward tap at index 0 / H - 1
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      if (((e == 0 ? f.lo_h : f.hi_h) >> rr) & 1) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) add(rr, v[rr + 1][kw], th * 3 + kw);
        if (f.lo_w) add(rr, v[rr + 1][1], th * 3 + 2);
        if (f.hi_w) add(rr, v[rr + 1][1], th * 3);
      }
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      if (f.lo_w) add(rr, v[rr + kh][1], kh * 3 + 2);
      if (f.hi_w) add(rr, v[rr + kh][1], kh * 3);
    }
}

// Output plane t is complete in slot SLOT: fold the splits in split order,
// then bias, residual, activation, store.  With splits every thread group
// leaves its R x CB sums in shared memory and then finishes every
// `splits`-th of them.
template <int SLOT, int CB, int TW, int R, bool BF16>
__device__ __forceinline__ void emit(float (&acc)[3][R][CB], const Args& a,
                                     const Ctx& c, const float (&bias)[CB],
                                     int t) {
  const int pos = c.ty * TW + c.lane_w;
  const int w = c.w0 + c.lane_w;
  const int h = c.h0 + c.ty * R;
  const int64_t o0 = (((int64_t)c.b * a.cd + c.dst0) * a.D + t) * c.plane +
                     (int64_t)h * a.W + w;
  auto finish = [&](int rr, int j, float v, float bj) {
    if (w < a.W && h + rr < a.H && c.dst0 + j < a.cd) {
      const int64_t o = o0 + (int64_t)j * a.D * c.plane + rr * a.W;
      v += bj;
      if constexpr (BF16) {
        if (a.res16) v += bf16_widen(a.res16[o]);
      } else if (a.residual) {
        v += a.residual[o];
      }
      if (a.act == 1) {
        v = fmaxf(v, 0.f);
      } else if (a.act == 2) {
        v = v >= 0.f ? v : 0.2f * v;
      }
      if constexpr (BF16) {
        a.out16[o] = (uint16_t)bf16_bits(v);
      } else {
        a.out[o] = v;
      }
    }
  };
  if (a.splits == 1) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < CB; ++j) finish(rr, j, acc[SLOT][rr][j], bias[j]);
    return;
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int j = 0; j < CB; ++j)
      c.red[((c.split * R + rr) * CB + j) * c.npos + pos] = acc[SLOT][rr][j];
  __syncthreads();
  for (int i = c.split; i < R * CB; i += a.splits) {
    float v = c.red[i * c.npos + pos];
    for (int s = 1; s < a.splits; ++s)
      v += c.red[(s * R * CB + i) * c.npos + pos];
    const int co = c.dst0 + i % CB;
    finish(i / CB, i % CB, v, a.bias && co < a.cd ? a.bias[co] : 0.f);
  }
  __syncthreads();
}

template <int CB, int R, int TW, bool FOLD, bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
conv3p_tile_kernel(const Args a) {
  constexpr int XW = row_pitch(TW, R);
  constexpr int XW16 = row_pitch16(TW, R);
  // the sums' slots: output planes p - 1, p, p + 1 of source plane p
  constexpr int PREV = 0, SAME = 1, NEXT = 2;
  extern __shared__ __align__(16) float smem[];

  Ctx c;
  c.tid = threadIdx.x;
  c.nthreads = blockDim.x;
  c.lane_w = c.tid % TW;
  c.ty = (c.tid / TW) % a.thr;
  c.split = c.tid / (TW * a.thr);
  c.npos = TW * a.thr;
  c.TH = a.thr * R;
  c.XH = c.TH + 2;
  c.XPLANE = c.XH * XW;
  c.planes_floats = a.cg * (BF16 ? c.XH * XW16 / 2 : c.XPLANE);
  const int tiles_w = (a.W + TW - 1) / TW;
  const int groups = (a.cd + CB - 1) / CB;
  c.w0 = (blockIdx.x % tiles_w) * TW;
  c.h0 = (blockIdx.x / tiles_w) * c.TH;
  c.d0 = blockIdx.y * a.chunk;
  c.d1 = min(c.d0 + a.chunk, a.D);
  c.b = blockIdx.z / groups;
  c.dst0 = (blockIdx.z % groups) * CB;
  c.G = (a.cs + a.cg - 1) / a.cg;
  c.w_resident = a.wres;
  c.plane = (int64_t)a.H * a.W;
  // shared memory: NSLOT units (cg planes, then cg x 27 x CB taps unless
  // they are resident), the resident taps, the splits' partial sums
  const int wfloats = ((a.wres ? a.cs : a.cg) * 27 * CB + 3) & ~3;
  c.slot_floats = c.planes_floats + (c.w_resident ? 0 : wfloats);
  c.smem = smem;
  c.wres = smem + NSLOT * c.slot_floats;
  c.red = c.wres + (c.w_resident ? wfloats : 0);
  // source planes this block reads: d0 - 1 .. d1, inside the volume unless
  // the halo is clamped
  c.pa = c.d0 - 1;
  c.pb = c.d1;
  if (!a.clamp) {
    c.pa = max(c.pa, 0);
    c.pb = min(c.pb, a.D - 1);
  }
  c.nunits = (c.pb - c.pa + 1) * c.G;
  // A tile that spans the rows of a zero-padded volume never reads a halo
  // column from memory: zero both columns of every slot once.
  c.halo_zeroed = !a.clamp && a.W <= TW &&
                  (BF16 ? a.vec8 : !a.pre_mode && a.vec);
  if (c.halo_zeroed) {
    for (int it = c.tid; it < NSLOT * a.cg * c.XH; it += c.nthreads) {
      float* slot = smem + (it / (a.cg * c.XH)) * c.slot_floats;
      if constexpr (BF16) {  // the two 4-byte pairs of BF16 ROWS
        uint32_t* row = reinterpret_cast<uint32_t*>(slot) +
                        (it % (a.cg * c.XH)) * (XW16 / 2);
        row[3] = 0u;
        row[TW / 2 + 4] = 0u;
      } else {
        float* row = slot + (it % (a.cg * c.XH)) * XW;
        row[3] = 0.f;
        row[TW + 4] = 0.f;
      }
    }
  }
  // K5 under edge padding, a tile on a face of the volume: which of the
  // thread's outputs lie on one
  c.face = FOLD && (c.h0 == 0 || c.h0 + c.TH >= a.H || c.w0 == 0 ||
                    c.w0 + TW >= a.W);
  Faces f;
  f.lo_h = f.hi_h = 0;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int h = c.h0 + c.ty * R + rr;
    f.lo_h |= (unsigned)(h == 0) << rr;
    f.hi_h |= (unsigned)(h == a.H - 1) << rr;
  }
  f.lo_w = c.w0 + c.lane_w == 0;
  f.hi_w = c.w0 + c.lane_w == a.W - 1;
  // BF16 ROWS: the index of the thread's three columns in a staged row
  // (under edge padding the clamped column's), and which of its values lie
  // inside a zero-padded volume: bit yy of row_in, bit kw of col_in
  int col16[3] = {0, 0, 0};
  unsigned row_in = 0, col_in = 0;
  if constexpr (BF16) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int gw = c.w0 + c.lane_w - 1 + kw;
      col16[kw] = (a.clamp ? min(max(gw, 0), a.W - 1) : gw) - c.w0 + 8;
      col_in |= (unsigned)(a.clamp || (gw >= 0 && gw < a.W)) << kw;
    }
#pragma unroll
    for (int yy = 0; yy < R + 2; ++yy) {
      const int gh = c.h0 + c.ty * R - 1 + yy;
      row_in |= (unsigned)(a.clamp || (gh >= 0 && gh < a.H)) << yy;
    }
  }

  float bias[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j)
    bias[j] = a.bias && c.dst0 + j < a.cd ? a.bias[c.dst0 + j] : 0.f;
  float acc[3][R][CB];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[s][rr][j] = 0.f;

  // Unit u is computed NSLOT - 1 iterations after its copies start; the
  // iteration past the last unit only lets the last output plane leave.
  int p = c.pa, g = 0;
  for (int u = 1 - NSLOT; u <= c.nunits; ++u) {
    const bool real = u >= 0 && u < c.nunits;
    if (real) {
      cp_async_wait<NSLOT - 2>();
      __syncthreads();
    }
    // slot (u - 1) % NSLOT was last read for unit u - 1, before the barrier
    if (u + NSLOT - 1 < c.nunits)
      stage<CB, TW, XW, XW16, BF16>(a, c, u + NSLOT - 1);
    cp_async_commit();
    if (u < 0) continue;
    // where tap plane kd of source plane p lands: 0 nowhere in this
    // block's run, 1 on plane p + 1 - kd, 2 (FOLD, the clamped read) on
    // plane p itself
    const bool own = p >= c.d0 && p < c.d1;
    int m0 = p + 1 >= c.d0 && p + 1 < c.d1;
    int m2 = p - 1 >= c.d0 && p - 1 < c.d1;
    if (FOLD && own) {
      if (p + 1 >= a.D) m0 = 2;
      if (p - 1 < 0) m2 = 2;
    }
    if (real) {
      const float* xs = c.smem + (u % NSLOT) * c.slot_floats;
      const float* ws = c.w_resident ? c.wres + g * a.cg * 27 * CB
                                     : xs + c.planes_floats;
      const int nc = min(a.cg, a.cs - g * a.cg);
      for (int ch = c.split; ch < nc; ch += a.splits) {
        const float* wc = ws + ch * 27 * CB;
        float v[R + 2][3];
        if constexpr (BF16) {
          // BF16 ROWS: widen; the pre-affine on values inside the volume
          const uint16_t* xb = reinterpret_cast<const uint16_t*>(xs) +
                               (ch * c.XH + c.ty * R) * XW16;
#pragma unroll
          for (int yy = 0; yy < R + 2; ++yy)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
              v[yy][kw] = bf16_widen(xb[yy * XW16 + col16[kw]]);
          if (a.pre_mode) {
            const float ps = a.pre_scale[g * a.cg + ch];
            const float pt = a.pre_shift[g * a.cg + ch];
#pragma unroll
            for (int yy = 0; yy < R + 2; ++yy)
#pragma unroll
              for (int kw = 0; kw < 3; ++kw) {
                float x = fmaf(v[yy][kw], ps, pt);
                if (a.pre_mode == 2) x = fmaxf(x, 0.f);
                v[yy][kw] = (row_in >> yy) & (col_in >> kw) & 1u ? x : 0.f;
              }
          }
        } else {
          const float* xb =
              xs + ch * c.XPLANE + c.ty * R * XW + c.lane_w + 3;
#pragma unroll
          for (int yy = 0; yy < R + 2; ++yy)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) v[yy][kw] = xb[yy * XW + kw];
        }
        if (m0 == 1) taps<NEXT, CB, R>(acc, v, wc, c.face, f);
        if (FOLD && m0 == 2) taps<SAME, CB, R>(acc, v, wc, c.face, f);
        if (own) taps<SAME, CB, R>(acc, v, wc + 9 * CB, c.face, f);
        if (m2 == 1) taps<PREV, CB, R>(acc, v, wc + 18 * CB, c.face, f);
        if (FOLD && m2 == 2)
          taps<SAME, CB, R>(acc, v, wc + 18 * CB, c.face, f);
      }
      if (++g < c.G) continue;
    }
    // source plane p is done: output plane p - 1 is complete; the sums
    // move one slot down for source plane p + 1
    if (m2 == 1) emit<PREV, CB, TW, R, BF16>(acc, a, c, bias, p - 1);
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        acc[PREV][rr][j] = acc[SAME][rr][j];
        acc[SAME][rr][j] = acc[NEXT][rr][j];
        acc[NEXT][rr][j] = 0.f;
      }
    ++p;
    g = 0;
  }
}

// Whether an instance's shared-memory limit has been raised.  Internal
// linkage on purpose: a function's static local would be one symbol for
// every library a process loads, and a rebuilt library's kernels would
// stay at the 48 KB default.
namespace {
bool sized_flags[24];
}

// Shared memory of one block, bytes.
template <int CB, int R, int TW>
size_t smem_bytes(const Args& a) {
  // a plane of XH rows, in floats (bf16 values in pairs)
  const int xplane = (a.thr * R + 2) * (a.src16 ? row_pitch16(TW, R) / 2
                                                 : row_pitch(TW, R));
  const bool resident = a.wres;
  const int wfloats = ((resident ? a.cs : a.cg) * 27 * CB + 3) & ~3;
  const size_t slot = (size_t)a.cg * xplane + (resident ? 0 : wfloats);
  const size_t red =
      a.splits > 1 ? (size_t)a.splits * R * CB * TW * a.thr : 0;
  return (NSLOT * slot + (resident ? wfloats : 0) + red) * sizeof(float);
}

template <int CB, int R, int TW, bool FOLD, bool BF16>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int threads = TW * a.thr * a.splits;
  const size_t bytes = smem_bytes<CB, R, TW>(a);
  if (a.thr < 1 || a.splits < 1 || a.chunk < 1 || a.cg < a.splits ||
      threads > MAX_THREADS ||
      (a.cg >= a.cs && !a.wres) ||
      bytes > MAX_SMEM)
    return cudaErrorInvalidValue;
  // once per instance and library
  bool& sized = sized_flags[(((CB == 1 ? 0 : CB == 4 ? 1 : 2) * 2 +
                              (TW == 32)) * 2 + FOLD) * 2 + BF16];
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3p_tile_kernel<CB, R, TW, FOLD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int tiles = ((a.W + TW - 1) / TW) * ((a.H + a.thr * R - 1) /
                                              (a.thr * R));
  dim3 grid(tiles, (a.D + a.chunk - 1) / a.chunk,
            a.B * ((a.cd + CB - 1) / CB));
  conv3p_tile_kernel<CB, R, TW, FOLD, BF16><<<grid, threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// The instance for a plan's (cb, r, tw): cb channels by r rows a thread
// (27 x r x cb sums in three slots stay in registers), tw 16 or 32; K1 on
// bf16 volumes has instances of its own (a runtime branch on the planes'
// type made the f32 walk slower).
template <bool FOLD, bool BF16>
cudaError_t dispatch_as(int cb, int r, int tw, const Args& a,
                        cudaStream_t s) {
#define HP_TILE(CB, R, TW) \
  if (cb == CB && r == R && tw == TW) return launch<CB, R, TW, FOLD, BF16>(a, s)
  HP_TILE(1, 4, 16); HP_TILE(1, 4, 32);
  HP_TILE(4, 4, 16); HP_TILE(4, 4, 32);
  HP_TILE(8, 2, 16); HP_TILE(8, 2, 32);
#undef HP_TILE
  return cudaErrorInvalidValue;
}

template <bool FOLD>
cudaError_t dispatch(int cb, int r, int tw, const Args& a, cudaStream_t s) {
  if constexpr (!FOLD) {
    if (a.src16) return dispatch_as<false, true>(cb, r, tw, a, s);
  }
  return dispatch_as<FOLD, false>(cb, r, tw, a, s);
}

}  // namespace conv3p_tile
