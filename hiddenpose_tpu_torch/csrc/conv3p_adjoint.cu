// K5: dx of K1 (conv3p.cu), the adjoint of "pad (zero or edge), then VALID
// 3x3x3 conv" on channels-planes volumes.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes_adjoint
// (kernel bodies _conv3p_adj_kernel / _conv3p_adj_kernel_db).  Contract:
//   dx[b, ci, i] = sum over (o, t) whose padded read lands on i of
//                  sum_co k[t, ci, co] * dz[b, co, o]
// with dz (B, C_out, D, H, W), the forward's DHWIO kernel
// (3, 3, 3, C_in, C_out) and dx (B, C_in, D, H, W).  With zero padding this
// is the correlation of dz with the flipped taps.  With edge padding a
// boundary voxel also collects the reads that the replicate pad clamped
// onto it; per axis the (o, t) pairs that land on i are always three, so a
// corner voxel takes 27 folded terms like any other, only from other taps.
//
// What bounds it on the card: K1's arithmetic with the channel roles
// swapped (27 * C_out FMAs per input voxel per C_in): bytes at one channel
// each way, fp32 FMAs from four channels on.
// Design: K1 on flipped, swapped taps (conv3p_tile.cuh stages them so),
// wherever no clamped read lands: with zero padding that is everywhere and
// the instances are K1's own; with edge padding the FOLD instances redirect
// the first and last plane's outward tap along D, and only a tile that
// touches a face of the volume reads its (offset, tap) pairs from
// registers.

#include "conv3p_tile.cuh"

namespace conv3p_tile {
// built with conv3p.cu
extern template cudaError_t dispatch<false>(int, int, int, const Args&,
                                            cudaStream_t);
}  // namespace conv3p_tile

// dz (B, C_out, D, H, W), k (3, 3, 3, C_in, C_out) DHWIO (the forward
// kernel), dx (B, C_in, D, H, W).  The integers come as one array, p = {B,
// C_in, C_out, D, H, W, pad_mode, tw, cb, r, thr, splits, chunk, cg, wres}:
// pad_mode 0 zero, 1 edge; the plan as for hp_conv3p_fwd with the roles
// swapped: cb input channels a block, splits and cg over the output
// channels.
extern "C" int hp_conv3p_adjoint(const float* dz, const float* k, float* dx,
                                 const int* p, void* stream) {
  conv3p_tile::Args a;
  a.src = dz; a.k = k; a.bias = nullptr; a.residual = nullptr;
  a.pre_scale = nullptr; a.pre_shift = nullptr; a.out = dx;
  a.B = p[0]; a.cs = p[2]; a.cd = p[1]; a.D = p[3]; a.H = p[4]; a.W = p[5];
  a.k_sc = 1; a.k_sd = a.cs; a.flip = 1; a.clamp = 0;
  a.act = 0; a.pre_mode = 0;
  const int pad_mode = p[6], tw = p[7], cb = p[8], r = p[9];
  a.thr = p[10]; a.splits = p[11]; a.chunk = p[12]; a.cg = p[13];
  a.wres = p[14];
  a.vec = a.W % 4 == 0 && (uintptr_t)dz % 16 == 0;
  // the input channels of k lie C_out floats apart; the output channels,
  // K5's source, next to each other
  a.vecw = 0;
  a.vect = a.cs % 4 == 0 && a.cg % 4 == 0 && (uintptr_t)k % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(pad_mode ? conv3p_tile::dispatch<true>(cb, r, tw, a, s)
                        : conv3p_tile::dispatch<false>(cb, r, tw, a, s));
}
