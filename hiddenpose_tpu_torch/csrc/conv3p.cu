// K1: SAME 3x3x3 stride-1 convolution on channels-planes volumes
// (B, C_in, D, H, W) with a DHWIO kernel, f32 accumulation.
//
// Replaces hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes (kernel bodies
// _conv3p_kernel / _conv3p_kernel_db).  Same contract:
//   out = act(conv(pad(pre(x)), k) + bias [+ residual])
//   pre(x) = [relu](x * pre_scale + pre_shift) per input channel (optional)
//   pad    = zero (torch SAME) or edge (ReplicationPad3d)
//   act    = none / relu / leaky(0.2), applied after the residual add.
//
// What bounds it on the card: with one input and one output channel the
// bytes (a 128^3 batch-2 call moves 34 MB); from four channels on the
// 27 * C_in * C_out fp32 FMAs a voxel, which outweigh the bytes at the
// card's 20 FLOP a byte.  At 1-64 channels a K of 27 * C_in gives the
// tensor cores nothing that a 3xTF32 split would not eat, and plain FMAs
// keep the sums exact f32.
// On bf16 volumes (the bfloat16 model's FeatureExtraction and UNet) the
// source, the residual and the output are bf16 and everything else f32:
// the JAX kernel's contract for a bf16 x (f32 weights and sums, the result
// in x's type).  Those calls run instances of their own, which stage the
// raw bf16 planes by cp.async and widen them where a thread reads them
// (BF16 ROWS in conv3p_tile.cuh).
// Design: the tile walk of conv3p_tile.cuh (each input plane staged once
// by asynchronous copies, a register tile of R rows x CB output channels x
// three planes in flight, channel blocks of 1, 4 or 8 that fit C_out, the
// input channels of small wide volumes split over thread groups and folded
// in a fixed order).

#include "conv3p_tile.cuh"

namespace conv3p_tile {
// the instances without the edge fold, which conv3p_adjoint.cu also calls
template cudaError_t dispatch<false>(int, int, int, const Args&,
                                     cudaStream_t);
}  // namespace conv3p_tile

// x (B, C_in, D, H, W), k (3, 3, 3, C_in, C_out), out (B, C_out, D, H, W);
// bias / residual / pre_scale / pre_shift may be null.  The integers come
// as one array, p = {B, C_in, C_out, D, H, W, pad_mode, act, pre_mode, tw,
// cb, r, thr, splits, chunk, cg, wres, bf16}: pad_mode 0 zero, 1 edge; act 0
// none, 1 relu, 2 leaky(0.2); pre_mode 0 no pre-affine, 1 affine, 2 affine
// + relu; then the plan of ops/kernels/conv3p.py::tile_plan: tw 32 or 16,
// the tile's width; cb output channels a block and r rows a thread (one of
// the forms conv3p_tile::dispatch lists); thr thread rows (the tile is
// thr * r rows); splits thread groups over the input channels; chunk
// planes of D a block; cg input channels staged at a time (a multiple of
// splits, or C_in); wres whether the taps of all input channels stay in
// shared memory; bf16 1: x, residual and out are bf16 (the taps, bias and
// pre-affine stay f32, and so do the sums).
extern "C" int hp_conv3p_fwd(const float* x, const float* k, const float* bias,
                             const float* residual, const float* pre_scale,
                             const float* pre_shift, float* out, const int* p,
                             void* stream) {
  conv3p_tile::Args a;
  a.src = x; a.k = k; a.bias = bias; a.residual = residual;
  a.pre_scale = pre_scale; a.pre_shift = pre_shift; a.out = out;
  a.B = p[0]; a.cs = p[1]; a.cd = p[2]; a.D = p[3]; a.H = p[4]; a.W = p[5];
  a.k_sc = a.cd; a.k_sd = 1; a.flip = 0; a.clamp = p[6];
  a.act = p[7]; a.pre_mode = p[8];
  const int tw = p[9], cb = p[10], r = p[11];
  a.thr = p[12]; a.splits = p[13]; a.chunk = p[14]; a.cg = p[15];
  a.wres = p[16];
  // 16-byte copies: rows of x, and runs of four output channels of k,
  // start 16-byte aligned
  a.vec = a.W % 4 == 0 && (uintptr_t)x % 16 == 0;
  a.vecw = cb >= 4 && a.cd % 4 == 0 && (uintptr_t)k % 16 == 0;
  a.vect = 0;
  if (p[17]) {
    a.src16 = reinterpret_cast<const uint16_t*>(x);
    a.res16 = reinterpret_cast<const uint16_t*>(residual);
    a.out16 = reinterpret_cast<uint16_t*>(out);
    a.src = nullptr;
    a.residual = nullptr;
    a.out = nullptr;
    a.vec = 0;
    a.vec8 = a.W % 8 == 0 && (uintptr_t)x % 16 == 0;
  }
  return (int)conv3p_tile::dispatch<false>(cb, r, tw, a,
                                           (cudaStream_t)stream);
}
