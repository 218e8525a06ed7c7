// K6: the kernel and bias gradients of K1 (conv3p.cu).
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes_wgrad (kernel
// bodies _conv3p_wgrad_kernel / _conv3p_wgrad_kernel_db).  Contract, with
// x (B, C_in, D, H, W), dz (B, C_out, D, H, W) = dL/d(pre-activation):
//   dk[t, ci, co] = sum over b and voxels o of pad(x)[b, ci, o + t - 1]
//                   * dz[b, co, o]                     (3, 3, 3, C_in, C_out)
//   db[co]        = sum over b and o of dz[b, co, o]
// where pad is zero or edge (replicate).  The TPU kernel takes
// C_in * C_out <= 32 and leaves wider convs to XLA; this one takes any.
//
// What bounds it on the card: a reduction of 27 * C_in * C_out (+ C_out)
// outputs over B * D * H * W voxel samples (4.2 M at 128^3, batch 2).  At
// the path's 1-64 channels the operands are read once and each output is a
// long dot product: fp32 FMAs fed from shared memory, so what counts is
// how many FMAs each shared-memory load feeds.  (C_in * C_out <= 32 at the
// large volumes: nothing for a tensor-core tile to fill, and plain FMAs
// keep the sums exact f32.)
// Design: two passes, both in a fixed order, so a result repeats exactly
// from run to run (no float atomics).
//   1. Lanes run over voxels.  Voxel tiles of 4 (D) x 8 (H) x TW (W; 32,
//      16 or 8, the widest that W fills) are dealt out in contiguous runs,
//      one run to each of `chunks` block columns.  A block owns `cib`
//      (1, 2 or 4) input channels and COT (1 or 4) output channels; per
//      tile it stages the 6 x 10 x (TW + 2) halo of each of its input
//      channels (padding applied) and its dz tiles once in shared memory,
//      with cp.async copies (zero-filled outside the volume; 16 bytes each
//      where W % 4 == 0, the halo's two outer columns and every other case
//      4 bytes) into the other of two buffers while it computes on this
//      one, so no warp waits on a load it has just started and staging
//      costs few instructions.  A warp takes one input channel
//      and every (4 / cib)-th group of 64 voxels; a lane takes two voxels
//      one above the other in D, walks the four x planes they touch (9
//      loads a plane, each feeding both voxels) and adds into 27 x COT
//      sums held in registers: 44 shared-memory loads feed 216 FMAs at
//      COT = 4, and consecutive lanes read consecutive words.  After its
//      run the block folds the lanes' sums by shuffles (a butterfly, fixed
//      by lane index), then the warps' sums of one input channel in warp
//      order, and writes one partial row per output.
//   2. One thread per output sums its `chunks` partials in chunk order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TD = 4;
constexpr int TH = 8;
constexpr int ROWS = TD * TH;           // (d, h) rows of a tile
constexpr int XD = TD + 2;
constexpr int XH = TH + 2;
constexpr int NWARP = 4;
constexpr int NTHREADS = 32 * NWARP;

template <int COT, int TW>
struct Shape {
  // A halo row in shared memory: column w0 - 1 at index 3, the tile's
  // own columns from index 4 (16-byte aligned), column w0 + TW at TW + 4.
  static constexpr int XW = TW + 8;
  static constexpr int XPLANE = XD * XH * XW;  // halo floats, one channel
  static constexpr int TV = ROWS * TW;         // voxels of a tile
  static constexpr int RW = 32 / TW;           // tile rows a warp covers
  static constexpr int NGROUP = TV / 64;       // groups of 2 x 32 voxels
  static constexpr int NACC = 27 * COT;
  // floats of one buffer: the halos of cib channels, then the dz tiles
  static constexpr __host__ __device__ int buffer(int cib) {
    return cib * XPLANE + COT * TV;
  }
};

template <int COT, int TW>
__global__ void __launch_bounds__(NTHREADS)
conv3p_wgrad_partial(const float* __restrict__ x,
                     const float* __restrict__ dz, float* __restrict__ partial,
                     int B, int cin, int cout, int D, int H, int W, int edge,
                     int chunks, int cib, int vec) {
  using S = Shape<COT, TW>;
  constexpr int XW = S::XW, XPLANE = S::XPLANE, TV = S::TV, RW = S::RW;
  constexpr int NGROUP = S::NGROUP, NACC = S::NACC;
  extern __shared__ __align__(16) float smem[];
  const int buffer = S::buffer(cib);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * cib;
  const int co0 = blockIdx.z * COT;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_d = (D + TD - 1) / TD;
  const int64_t ntiles = (int64_t)B * tiles_d * tiles_h * tiles_w;
  const int64_t t_begin = ntiles * chunk / chunks;
  const int64_t t_end = ntiles * (chunk + 1) / chunks;
  const int64_t plane = (int64_t)H * W;

  // This warp's input channel (of the block's cib) and which groups of
  // voxels of a tile it takes.
  const int cl = warp % cib;
  const int slab = warp / cib, nslab = NWARP / cib;
  const int lrow = lane / TW, vw = lane % TW;

  // Start the copies of one tile into buffer `buf` (no wait).
  auto stage = [&](int64_t tile, int buf) {
    float* xs = smem + buf * buffer;
    float* zs = xs + cib * XPLANE;
    int64_t r = tile;
    const int wt = (int)(r % tiles_w);
    r /= tiles_w;
    const int ht = (int)(r % tiles_h);
    r /= tiles_h;
    const int dt = (int)(r % tiles_d);
    const int b = (int)(r / tiles_d);
    const int d0 = dt * TD, h0 = ht * TH, w0 = wt * TW;
    // Halo row `row` = (channel, zd, yy): its source row (d and h clamped
    // for edge padding) or null where it is zero.
    auto src_row = [&](int row) -> const float* {
      const int c = row / (XD * XH);
      int gd = d0 - 1 + (row / XH) % XD, gh = h0 - 1 + row % XH;
      if (ci0 + c >= cin) return nullptr;
      if (edge) {
        gd = min(max(gd, 0), D - 1);
        gh = min(max(gh, 0), H - 1);
      } else if (gd < 0 || gd >= D || gh < 0 || gh >= H) {
        return nullptr;
      }
      return x + (((int64_t)b * cin + ci0 + c) * D + gd) * plane +
             (int64_t)gh * W;
    };
    // One element of a halo row, column gw of the volume, to index col.
    auto copy1 = [&](int row, int gw, int col) {
      const float* src = src_row(row);
      if (edge) gw = min(max(gw, 0), W - 1);
      const bool in = src != nullptr && gw >= 0 && gw < W;
      cp_async4(xs + row * XW + col, in ? src + gw : x, in);
    };
    if (vec) {
      // the tile's own columns, four at a time: W % 4 == 0, so the four
      // lie inside the volume together or not at all
      constexpr int QW = TW / 4;
      for (int it = tid; it < cib * XD * XH * QW; it += NTHREADS) {
        const int row = it / QW, gw = w0 + 4 * (it % QW);
        float* dst = xs + row * XW + 4 + 4 * (it % QW);
        const float* src = src_row(row);
        if (src != nullptr && gw >= W && edge) {
          // past a ragged tile's last column: its first element is the
          // right neighbour of column W - 1
#pragma unroll
          for (int k = 0; k < 4; ++k) cp_async4(dst + k, src + W - 1, true);
        } else {
          const bool in = src != nullptr && gw < W;
          cp_async16(dst, in ? src + gw : x, in);
        }
      }
      for (int it = tid; it < cib * XD * XH * 2; it += NTHREADS)
        copy1(it >> 1, (it & 1) ? w0 + TW : w0 - 1, (it & 1) ? TW + 4 : 3);
      for (int it = tid; it < COT * TV / 4; it += NTHREADS) {
        const int j = it / (TV / 4), v4 = 4 * (it % (TV / 4));
        const int trow = v4 / TW;
        const int gd = d0 + trow / TH, gh = h0 + trow % TH;
        const int gw = w0 + v4 % TW, co = co0 + j;
        const bool in = co < cout && gd < D && gh < H && gw < W;
        cp_async16(zs + j * TV + v4,
                   in ? dz + (((int64_t)b * cout + co) * D + gd) * plane +
                            (int64_t)gh * W + gw
                      : dz,
                   in);
      }
    } else {
      for (int it = tid; it < cib * XD * XH * (TW + 2); it += NTHREADS) {
        const int xx = it % (TW + 2);
        copy1(it / (TW + 2), w0 - 1 + xx, xx + 3);
      }
      for (int it = tid; it < COT * TV; it += NTHREADS) {
        const int j = it / TV, v = it % TV;
        const int trow = v / TW;
        const int gd = d0 + trow / TH, gh = h0 + trow % TH;
        const int gw = w0 + v % TW, co = co0 + j;
        const bool in = co < cout && gd < D && gh < H && gw < W;
        cp_async4(zs + j * TV + v,
                  in ? dz + (((int64_t)b * cout + co) * D + gd) * plane +
                           (int64_t)gh * W + gw
                     : dz,
                  in);
      }
    }
    cp_async_commit();
  };

  float acc[NACC];
  float accb[COT];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < COT; ++j) accb[j] = 0.f;

  if (t_begin < t_end) stage(t_begin, 0);
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int buf = (int)((tile - t_begin) & 1);
    if (tile + 1 < t_end) {
      stage(tile + 1, buf ^ 1);  // free since the barrier that ended tile - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + buf * buffer + cl * XPLANE;
    const float* zs = smem + buf * buffer + cib * XPLANE;
    // Group g: the voxels of tile rows (2 dp + {0, 1}, hq RW + lrow), with
    // dp = g / (TH / RW), hq = g % (TH / RW).
    for (int grp = slab; grp < NGROUP; grp += nslab) {
      const int dp = grp / (TH / RW), hq = grp % (TH / RW);
      const int vh = hq * RW + lrow;
      float z[2][COT];
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int j = 0; j < COT; ++j) {
          z[v][j] = zs[j * TV + ((2 * dp + v) * TH + vh) * TW + vw];
          accb[j] += z[v][j];
        }
      const float* xb = xs + ((2 * dp) * XH + vh) * XW + vw + 3;
#pragma unroll
      for (int pd = 0; pd < 4; ++pd) {  // x planes 2 dp - 1 + pd
        float xv[9];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            xv[kh * 3 + kw] = xb[(pd * XH + kh) * XW + kw];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int kd = pd - v;  // the tap of voxel v that reads plane pd
          if (kd < 0 || kd > 2) continue;
#pragma unroll
          for (int t = 0; t < 9; ++t)
#pragma unroll
            for (int j = 0; j < COT; ++j)
              acc[(kd * 9 + t) * COT + j] =
                  fmaf(xv[t], z[v][j], acc[(kd * 9 + t) * COT + j]);
        }
      }
    }
    __syncthreads();
  }

  // Fold the lanes (butterfly: the order is fixed by lane index), then the
  // warps that share an input channel, in warp order.
  float (*red)[NACC + COT] = reinterpret_cast<float (*)[NACC + COT]>(smem);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    float v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][i] = v;
  }
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    float v = accb[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][NACC + j] = v;
  }
  __syncthreads();
  const int64_t rows = 27LL * cin * cout + cout;
  float* prow = partial + (int64_t)chunk * rows;
  for (int i = tid; i < cib * NACC; i += NTHREADS) {
    const int c = i / NACC, a = i % NACC;
    const int t = a / COT, j = a % COT;
    const int ci = ci0 + c, co = co0 + j;
    if (ci >= cin || co >= cout) continue;
    float s = 0.f;
    for (int sl = 0; sl < nslab; ++sl) s += red[sl * cib + c][a];
    prow[((int64_t)t * cin + ci) * cout + co] = s;
  }
  // the bias sums: the block of input channel 0, its channel-0 warps
  if (blockIdx.y == 0 && tid < COT && co0 + tid < cout) {
    float s = 0.f;
    for (int sl = 0; sl < nslab; ++sl) s += red[sl * cib][NACC + tid];
    prow[27LL * cin * cout + co0 + tid] = s;
  }
}

__global__ void conv3p_wgrad_reduce(const float* __restrict__ partial,
                                    float* __restrict__ dk,
                                    float* __restrict__ db, int64_t n_dk,
                                    int64_t rows, int chunks) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * rows + r];
  if (r < n_dk) {
    dk[r] = s;
  } else if (db) {
    db[r - n_dk] = s;
  }
}

template <int COT, int TW>
cudaError_t launch_partial(const float* x, const float* dz, float* partial,
                           int B, int cin, int cout, int D, int H, int W,
                           int pad_mode, int chunks, int cib,
                           cudaStream_t s) {
  using S = Shape<COT, TW>;
  static_assert(NWARP * (S::NACC + COT) <= S::buffer(1),
                "the folded sums must fit in a buffer");
  const int bytes = 2 * S::buffer(cib) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv3p_wgrad_partial<COT, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // 16-byte copies: rows of x and dz start 16-byte aligned
  const int vec = W % 4 == 0 && ((uintptr_t)x | (uintptr_t)dz) % 16 == 0;
  dim3 grid(chunks, (cin + cib - 1) / cib, (cout + COT - 1) / COT);
  conv3p_wgrad_partial<COT, TW><<<grid, NTHREADS, bytes, s>>>(
      x, dz, partial, B, cin, cout, D, H, W, pad_mode, chunks, cib, vec);
  return cudaGetLastError();
}

}  // namespace

// x (B, C_in, D, H, W), dz (B, C_out, D, H, W); partial: scratch of
// chunks * (27 * C_in * C_out + C_out) floats; dk (3, 3, 3, C_in, C_out);
// db (C_out,) or null.  pad_mode 0 zero, 1 edge.  The plan comes from the
// caller (ops/kernels/conv3p.py::wgrad_plan): tw 32, 16 or 8, the tile's
// width; cib 1, 2 or 4 input channels a block; cot 1 or 4 output channels
// a block; chunks block columns, at most the number of tiles.
extern "C" int hp_conv3p_wgrad(const float* x, const float* dz,
                               float* partial, float* dk, float* db, int B,
                               int cin, int cout, int D, int H, int W,
                               int pad_mode, int chunks, int tw, int cib,
                               int cot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((cib != 1 && cib != 2 && cib != 4) || chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define HP_WGRAD(COT, TW)                                                  \
  err = launch_partial<COT, TW>(x, dz, partial, B, cin, cout, D, H, W,     \
                                pad_mode, chunks, cib, s)
  if (cot == 1 && tw == 32) HP_WGRAD(1, 32);
  else if (cot == 1 && tw == 16) HP_WGRAD(1, 16);
  else if (cot == 1 && tw == 8) HP_WGRAD(1, 8);
  else if (cot == 4 && tw == 32) HP_WGRAD(4, 32);
  else if (cot == 4 && tw == 16) HP_WGRAD(4, 16);
  else if (cot == 4 && tw == 8) HP_WGRAD(4, 8);
  else return (int)cudaErrorInvalidValue;
#undef HP_WGRAD
  if (err != cudaSuccess) return (int)err;
  const int64_t n_dk = 27LL * cin * cout;
  const int64_t rows = n_dk + cout;
  const int threads = 256;
  conv3p_wgrad_reduce<<<(unsigned)((rows + threads - 1) / threads), threads,
                        0, s>>>(partial, dk, db, n_dk, rows, chunks);
  return (int)cudaGetLastError();
}
