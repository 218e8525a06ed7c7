"""K4: 3x3x3 stride-1 pad-1 conv, channels-last, fused BN affine + ReLU.

Replaces ``hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu`` (body
``_conv3mxu_kernel``): the Bottleneck conv2 of the stride-1 c64 @64^3,
c128 @32^3 and c256 @16^3 blocks, with the eval BatchNorm affine and the
ReLU as an epilogue.  Same argument order and NDHWC / DHWIO layouts as the
JAX function.  The arithmetic is the GPU's counterpart of the JAX path's
``compute_dtype='f32'`` (multi-pass ``precision=HIGHEST`` matmuls on the
matrix unit): **three TF32 passes with f32 accumulation (3xTF32), never
one**.  Each f32 operand is split into two TF32 parts, a = a_hi + a_lo
(:func:`tf32_split`), and a * b is taken as a_lo * b_hi + a_hi * b_lo +
a_hi * b_hi on the tensor cores; the dropped a_lo * b_lo is about 2^-22 of
|a||b|, f32's own rounding.  :func:`conv3_mxu_3xtf32_ref` emulates that
arithmetic in plain PyTorch; :func:`conv3_mxu_ref` stays the plain version
everything is held against.  The CUDA source is ``csrc/conv3mxu.cu``; its
header says what bounds it (TF32 MMA issue at three passes) and what the
design does about it.

The kernel reads the weights in the order of its B fragments:
:func:`prepare_weights` splits them and lays them out, once per call
(for dx with the tap flip and the in/out swap folded in).

Its gradient (:class:`Conv3Mxu`, the port of ``conv3_mxu_diff`` /
``_conv3_bwd``, ``hiddenpose_tpu/ops/pallas/conv3mxu.py:524-589``) runs
the same kernel for dx, on the spatially flipped, in/out-swapped weights
(:func:`conv3_mxu_dx`, counted apart), and leaves dk to the library's
weight gradient, as the JAX package leaves it to XLA's native one.

:func:`conv3_mxu_bf16` is K4 of the bfloat16 model, the JAX kernel's
default ``compute_dtype='bf16'``: bf16 operands, one pass on the tensor
cores with f32 sums, the affine and ReLU in f32, a bf16 result.  Its own
kernel, ``csrc/conv3mxu_bf16.cu``; :func:`prepare_weights_bf16_ref` and
:func:`conv3_mxu_bf16_tiled_ref` write its bookkeeping out in plain
PyTorch.  The same kernel on the flipped, swapped taps is
:func:`conv3_mxu_dx_bf16` (K4-dx-bf16, counted apart): the input gradient
of the train step at the JAX package's default precision, where the JAX
router takes 'bwd' (the library's forward, :class:`Conv3MxuBwd`) and
resolves the kernel's compute dtype to bf16 (:func:`route`,
:func:`compute_dtype`).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  A wrapper also raises when an input
requires grad and grad mode is on: under autograd only
:func:`conv3_mxu_diff` may call it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build
from hiddenpose_tpu_torch.ops.kernels._tf32 import (  # noqa: F401
    tf32_round,  # re-exported beside tf32_split, as before the move
    tf32_split,
)


def conv3mxu_supported(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes (its 16-deep k-slices lie inside one
    tap; its 64-wide output tiles never straddle C_out)."""
    return cin % 16 == 0 and cout % 64 == 0 and cin > 0 and cout > 0


# The JAX router's packed-weight budget of one call (``_KB_BUDGET``): a
# shape whose f32 operand exceeds it needs a C_out split, which the router
# leaves off the path (layer4's c512).
_ROUTER_WEIGHT_BUDGET = 12 * 1024 * 1024


def router_admits(shape, cin: int, cout: int) -> bool:
    """The shapes the JAX router sends to its kernel, ``conv3mxu_supported``
    (``hiddenpose_tpu/ops/pallas/conv3mxu.py:72-114``) without its
    environment overrides: ``shape`` (B, D, H, W, C_in); C_out a multiple
    of 64; C_in 64 with W / 2 a multiple of 8, or a multiple of 128 with W
    a multiple of 8; H >= 3; the packed f32 weights within one call's
    budget.  A train step routes a Bottleneck conv2 through K4 or
    K4-dx-bf16 exactly where this holds, so that it rounds at the JAX
    step's convs at every size (at t128 all 11 calls; at tiny(32) not
    c256 @4^3)."""
    _, d, h, w, _ = shape
    if cout % 64 or cout < 64:
        return False
    if cin == 64:
        if w % 2 or (w // 2) % 8 or w // 2 < 8:
            return False
    elif cin % 128 or w % 8:
        return False
    if h < 3 or d < 1:
        return False
    lanes = 2 * cout if cin == 64 else cout
    return 3 * max(cin, 128) * 9 * lanes * 4 <= _ROUTER_WEIGHT_BUDGET


def _conv_ndhwc(x, k):
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 k.float().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def _epilogue(y, scale, shift, relu):
    if scale is not None:
        y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()


def conv3_mxu_ref(x, k, scale=None, shift=None, relu=False):
    """Plain version: ``F.conv3d(pad=1)`` + affine + ReLU in float32, NDHWC
    in/out, the result in ``x``'s type (bfloat16 operands are widened
    exactly and the result rounded once: K4's bf16 contract)."""
    return _epilogue(_conv_ndhwc(x, k), scale, shift, relu).to(x.dtype)


def conv3_mxu_3xtf32_ref(x, k, scale=None, shift=None, relu=False):
    """The kernel's arithmetic in plain PyTorch: the three products of the
    split operands as three f32 convs, the two small terms summed first,
    then the epilogue.  ``conv3_mxu_3xtf32_ref(dz, flip_swap(k))`` is the
    emulation of :func:`conv3_mxu_dx`."""
    xh, xl = tf32_split(x.float())
    kh, kl = tf32_split(k.float())
    y = (_conv_ndhwc(xl, kh) + _conv_ndhwc(xh, kl)) + _conv_ndhwc(xh, kh)
    return _epilogue(y, scale, shift, relu)


def flip_swap(k):
    """The dx weights of a SAME 3^3 conv: taps flipped, in/out swapped."""
    return torch.flip(k, (0, 1, 2)).transpose(3, 4).contiguous()


# The kernel's weight operand.  A k-step of the implicit GEMM is 16 input
# channels of one tap (k-block kb = tap * C_in / 16 + channel block), run as
# two k8 MMAs (kk = 0, 1) of a 64-wide block of output channels; each MMA
# reads its B operand (8 k x 64 n, hi or lo) from shared memory as 2 x 8
# "core matrices" of 4 k x 8 n, each 128 contiguous bytes (n-row r at 16 r
# bytes, its 4 k values).  Neither index has to follow memory order, so the
# kernel numbers them for wide accesses: k slot j of MMA kk is input channel
# 4 (j % 4) + 2kk + j / 4 of the k-block (a lane's A values of both MMAs are
# then one 16-byte read), and column r of n-tile ng = 2p + q is output
# channel 16p + 4(r / 2) + 2q + r % 2 (a lane's accumulators of two n-tiles
# are then 4 consecutive channels, one 16-byte store).  The operand holds,
# for each (kb, 64-wide n-block), the four matrices (hi, lo) x (kk 0, 1)
# core matrix by core matrix: a block's tile of one k-step is one
# contiguous 8 KB run, copied as it is.
def prepare_weights_ref(k, transposed=False):
    """Plain version of :func:`prepare_weights`: ``k`` (3, 3, 3, C_in,
    C_out) DHWIO, or with ``transposed`` its :func:`flip_swap`, split by
    :func:`tf32_split` and laid out as (27 * C_in / 16, C_out / 64, 2 parts,
    2 kk, 2 core matrices along k, 8 along n, 8 rows, 4) float32 (C_in,
    C_out: the conv's that the kernel runs)."""
    w = flip_swap(k) if transposed else k
    cin, cout = w.shape[3], w.shape[4]
    parts = torch.stack(tf32_split(w.float()))
    # (part, tap, c16, e, kk, kc, n-block, p, r / 2, q, r % 2)
    parts = parts.reshape(2, 27, cin // 16, 4, 2, 2, cout // 64, 4, 4, 2, 2)
    # (tap, c16, n-block, part, kk, kc, p, q, r / 2, r % 2, e)
    parts = parts.permute(1, 2, 6, 0, 4, 5, 7, 9, 8, 10, 3)
    return parts.reshape(27 * cin // 16, cout // 64, 2, 2, 2, 8, 8,
                         4).contiguous()


def unpack_weights(wp):
    """(hi, lo), each (3, 3, 3, C_in, C_out): the inverse of
    :func:`prepare_weights_ref`'s layout."""
    cin, cout = wp.shape[0] // 27 * 16, wp.shape[1] * 64
    parts = wp.reshape(27, cin // 16, cout // 64, 2, 2, 2, 4, 2, 4, 2, 4)
    parts = parts.permute(3, 0, 1, 10, 4, 5, 2, 6, 8, 7, 9)
    parts = parts.reshape(2, 3, 3, 3, cin, cout)
    return parts[0].contiguous(), parts[1].contiguous()


def prepare_weights(k, transposed=False):
    """The kernel's weight operand (see :func:`prepare_weights_ref`), made
    by one small kernel of ``csrc/conv3mxu.cu`` for a CUDA tensor."""
    if k.device.type == "cpu":
        return prepare_weights_ref(k, transposed)
    if k.device.type != "cuda":
        raise ValueError(f"prepare_weights: unsupported device {k.device}")
    cin, cout = (k.shape[4], k.shape[3]) if transposed else k.shape[3:]
    wp = torch.empty((27 * cin // 16, cout // 64, 2, 2, 2, 8, 8, 4),
                     device=k.device, dtype=torch.float32)
    _build.launch("hp_conv3_mxu_prep", k.data_ptr(), wp.data_ptr(), cin, cout,
                  int(transposed))
    return wp


def conv3_mxu(x, k, scale=None, shift=None, relu=False):
    """x (B, D, H, W, C_in); k (3, 3, 3, C_in, C_out) DHWIO; optional
    per-C_out ``scale``/``shift`` (both or neither) then optional ReLU.
    Returns (B, D, H, W, C_out) float32."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if k.dim() != 5 or tuple(k.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"k must be (3, 3, 3, {cin}, C_out), "
                         f"got {tuple(k.shape)}")
    cout = k.shape[4]
    if not conv3mxu_supported(cin, cout):
        raise ValueError(f"conv3_mxu takes C_in % 16 == 0 and C_out % 64 == 0,"
                         f" got {cin} -> {cout}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    _build.no_grad_inputs("conv3_mxu", x, k, scale, shift,
                          use="conv3_mxu_diff")
    dev = x.device
    _build.check(x, "x", device=dev, aligned=True)
    _build.check(k, "k", device=dev, aligned=True)
    if scale is not None:
        _build.check(scale, "scale", shape=(cout,), device=dev)
        _build.check(shift, "shift", shape=(cout,), device=dev)
    if dev.type == "cpu":
        return conv3_mxu_ref(x, k, scale, shift, relu)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu: unsupported device {dev}")

    out = _launch(x, k, scale, shift, relu)
    conv3_mxu.launches += 1
    return out


conv3_mxu.launches = 0


def _launch(x, k, scale=None, shift=None, relu=False, transposed=False):
    b, d, h, w, cin = x.shape
    wp = prepare_weights(k, transposed)
    cout = wp.shape[1] * 64
    out = torch.empty((b, d, h, w, cout), device=x.device,
                      dtype=torch.float32)
    _build.launch(
        "hp_conv3_mxu_fwd", x.data_ptr(), wp.data_ptr(), _build.ptr(scale),
        _build.ptr(shift), out.data_ptr(), b, d, h, w, cin, cout,
        int(bool(relu)))
    return out


def conv3_mxu_dx_ref(dz, k):
    """Plain version: ``torch.nn.grad.conv3d_input``, NDHWC in/out."""
    b, d, h, w, _ = dz.shape
    dx = torch.nn.grad.conv3d_input(
        (b, k.shape[3], d, h, w), k.detach().float().permute(4, 3, 0, 1, 2),
        dz.detach().float().permute(0, 4, 1, 2, 3), padding=1)
    return dx.permute(0, 2, 3, 4, 1).contiguous()


def conv3_mxu_dx(dz, k):
    """dL/dx of :func:`conv3_mxu` (no epilogue) given dz (B, D, H, W,
    C_out): the K4 kernel on :func:`flip_swap` of k, which the weight
    preparation folds in.  Returns (B, D, H, W, C_in)."""
    if dz.dim() != 5 or k.dim() != 5 or tuple(k.shape[:3]) != (3, 3, 3) \
            or k.shape[4] != dz.shape[4]:
        raise ValueError(f"dz {tuple(dz.shape)} must be (B, D, H, W, C_out) "
                         f"of k (3, 3, 3, C_in, C_out), got {tuple(k.shape)}")
    cin, cout = k.shape[3], k.shape[4]
    if not conv3mxu_supported(cout, cin):
        raise ValueError(f"conv3_mxu_dx runs the kernel {cout} -> {cin}: "
                         "needs C_out % 16 == 0 and C_in % 64 == 0")
    _build.no_grad_inputs("conv3_mxu_dx", dz, k, use="conv3_mxu_diff")
    dev = dz.device
    _build.check(dz, "dz", device=dev, aligned=True)
    _build.check(k, "k", device=dev)
    if dev.type == "cpu":
        return conv3_mxu_dx_ref(dz, k)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu_dx: unsupported device {dev}")
    out = _launch(dz, k, transposed=True)
    conv3_mxu_dx.launches += 1
    return out


conv3_mxu_dx.launches = 0


class Conv3Mxu(torch.autograd.Function):
    """Differentiable K4 without epilogue (the 'full' route): forward K4,
    dx K4 on the flipped, swapped taps, dk the library's weight gradient.
    For bfloat16 x and k (the bf16 model under 'high' or 'highest', where
    the JAX kernel computes in f32: ``conv3mxu.py:396`` widens, ``:453``
    writes x's type) both kernels take the widened operands and their f32
    result is rounded once to bf16."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return conv3_mxu(x.float(), k.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        need_x, need_k = ctx.needs_input_grad
        dx = (conv3_mxu_dx(g.float().contiguous(), k.float()).to(x.dtype)
              if need_x else None)
        dk = _library_dk(x, k, g) if need_k else None
        return dx, dk


def conv3_mxu_diff(x, k):
    """Differentiable :func:`conv3_mxu` (no epilogue: training applies BN
    with batch statistics to the raw conv output)."""
    return Conv3Mxu.apply(x, k)


# ------------------------------------------------------------------- bf16
# The bf16 kernel (csrc/conv3mxu_bf16.cu) multiplies in one bf16 pass,
# wgmma m64n64k16.  A tile is 256 output voxels of one output plane
# (:func:`bf16_tile`) by 64 output channels; its work comes in
# stages of one input plane kd and 32 input channels: the stage's halo of
# that plane, (TH + 2) x (TW + 2) voxels of 32 channels, is staged once,
# and its nine (kh, kw) taps read their A rows from it, two k-steps s of 16
# each.  Neither k nor n of an MMA has to follow memory order: k slot k of
# k-step s is input channel 8 ((k % 8) / 2) + 4s + 2 (k / 8) + k % 2 of the
# stage's 32, so that a lane's A of both k-steps is one 16-byte read of 8
# consecutive channels per row, and column r of n-tile ng = 4p + q is
# output channel 32p + 8(r / 2) + 2q + r % 2, so that its accumulators of
# four n-tiles are 8 consecutive channels (one 16-byte store of bf16).  B
# (16 k x 64 n, K-major) is 2 x 8 core matrices of 8 n x 8 k, 128 bytes
# each: element (k, n) at byte 2 (k % 8) + 16 (n % 8) + 1024 (k / 8) +
# 128 (n / 8); a tap's two k-steps are 4 KB, a stage's nine taps one
# contiguous 36 KB run of the prepared weights.
BF16_UNIT = 32
BF16_TILE_VOXELS = 256


def conv3mxu_bf16_supported(cin: int, cout: int) -> bool:
    """Channel counts the bf16 kernel takes (a stage of 32 input channels
    lies inside one tap; 64-wide output tiles never straddle C_out)."""
    return cin % BF16_UNIT == 0 and cout % 64 == 0 and cin > 0 and cout > 0


def bf16_tile(h: int, w: int):
    """(TH, TW): the bf16 kernel's output tile of 256 voxels of a plane,
    four 8 x 8 patches, TW the narrowest of 8, 16 and 32 that covers W (32
    for wider volumes).  The path's c64 @64^3, c128 @32^3 and c256 @16^3
    take 8 x 32, 8 x 32 and 16 x 16: 2048, 512 and 128 tiles of 64 output
    channels, which one persistent block a multiprocessor walks through."""
    tw = 32 if w > 16 else 16 if w > 8 else 8
    return BF16_TILE_VOXELS // tw, tw


def bf16_row_voxels(tile):
    """(y, x), each (256,): the tile voxel of each row m of the block's
    MMAs.  Warpgroup m / 64 owns 8 x 8 patch m / 64 of the tile (patches
    TW / 8 a row), warp (m % 64) / 16 its rows 2w and 2w + 1: row g and
    row g + 8 of a warp are one column, H rows y and y + 1, so that a
    lane's tap (kh, kw) of row g + 8 is its tap (kh + 1, kw) of row g."""
    th, tw = tile
    m = torch.arange(BF16_TILE_VOXELS)
    q, w, half, g = m // 64, (m % 64) // 16, (m % 16) // 8, m % 8
    return (q // (tw // 8)) * 8 + 2 * w + half, (q % (tw // 8)) * 8 + g


def unit_channels_bf16():
    """(2 k-steps, 16 k slots): the input channel of the stage's 32 each
    slot holds."""
    s = torch.arange(2)[:, None]
    k = torch.arange(16)[None, :]
    return 8 * ((k % 8) // 2) + 4 * s + 2 * (k // 8) + k % 2


def column_channels_bf16():
    """The output channel (within a 64-wide block) of each of the bf16
    MMA's 64 columns (K4-bf16's and K2-bf16's)."""
    n = torch.arange(64)
    ng, r = n // 8, n % 8
    return 32 * (ng // 4) + 8 * (r // 2) + 2 * (ng % 4) + r % 2


def b_offsets_bf16():
    """(16 k, 64 n): the element of a k-step's B (2 x 8 core matrices of
    8 n x 8 k bf16, K-major) that the MMA's descriptor reads as (k, n), for
    K4-bf16 and K2-bf16."""
    k = torch.arange(16)[:, None]
    n = torch.arange(64)[None, :]
    return k % 8 + 8 * (n % 8) + 512 * (k // 8) + 64 * (n // 8)


def prepare_weights_bf16_ref(k, transposed=False):
    """Plain version of :func:`prepare_weights_bf16`: ``k`` (3, 3, 3, C_in,
    C_out) DHWIO bf16, or with ``transposed`` its :func:`flip_swap`, laid
    out as (3 kd, C_in / 32, C_out / 64, 9 taps (kh, kw), 2 k-steps, 2 core
    matrices along k, 8 along n, 8 rows, 8) bf16 (C_in, C_out: the conv's
    that the kernel runs): a stage's (kd, 32-channel block, n-block) B is
    one run."""
    if transposed:
        k = flip_swap(k)
    cin, cout = k.shape[3], k.shape[4]
    c32, nb = cin // BF16_UNIT, cout // 64
    w = k.reshape(3, 9, c32, BF16_UNIT, nb, 64)
    w = w[:, :, :, unit_channels_bf16()]       # (kd, khw, c, s, k, nb, 64)
    w = w[..., column_channels_bf16()]         # columns in MMA order
    # (kd, khw, c, s, kc, e, nb, ng, r) -> (kd, c, nb, khw, s, kc, ng, r, e)
    w = w.reshape(3, 9, c32, 2, 2, 8, nb, 8, 8)
    w = w.permute(0, 2, 6, 1, 3, 4, 7, 8, 5)
    return w.contiguous()


def prepare_weights_bf16(k, transposed=False):
    """The bf16 kernel's weight operand (see
    :func:`prepare_weights_bf16_ref`), made by one small kernel of
    ``csrc/conv3mxu_bf16.cu`` for a CUDA tensor (the tap flip and the
    channel swap folded into its reads)."""
    if k.device.type == "cpu":
        return prepare_weights_bf16_ref(k, transposed)
    if k.device.type != "cuda":
        raise ValueError(f"prepare_weights_bf16: unsupported device "
                         f"{k.device}")
    cin, cout = (k.shape[4], k.shape[3]) if transposed else k.shape[3:]
    wp = torch.empty((3, cin // BF16_UNIT, cout // 64, 9, 2, 2, 8, 8, 8),
                     device=k.device, dtype=torch.bfloat16)
    _build.launch("hp_conv3_mxu_bf16_prep", k.data_ptr(), wp.data_ptr(), cin,
                  cout, int(transposed), device=k.device)
    return wp


def bf16_halos(x, tile):
    """Each block's halo planes as the kernel stages them: x (B, D, H, W,
    C) -> (B, D + 2, tiles, (TH + 2) (TW + 2), C), input plane p at index
    p + 1, tile (i, j) at index i * tiles_w + j, halo voxel (hy, wx) at
    hy (TW + 2) + wx = input voxel (i TH - 1 + hy, j TW - 1 + wx), zero
    outside the volume."""
    b, d, h, w, c = x.shape
    th, tw = tile
    nth, ntw = -(-h // th), -(-w // tw)
    xp = F.pad(x, (0, 0, 1, 1 + ntw * tw - w, 1, 1 + nth * th - h, 1, 1))
    halos = xp.unfold(2, th + 2, th).unfold(3, tw + 2, tw)
    # (b, D + 2, nth, ntw, c, th + 2, tw + 2) -> voxels then channels
    halos = halos.permute(0, 1, 2, 3, 5, 6, 4)
    return halos.reshape(b, d + 2, nth * ntw, (th + 2) * (tw + 2), c)


def bf16_tap_rows(tile, kh, kw):
    """(256,): the halo voxel that each row m of the block's MMAs (tile
    voxel :func:`bf16_row_voxels`) reads for tap (kh, kw)."""
    y, x = bf16_row_voxels(tile)
    return (y + kh) * (tile[1] + 2) + x + kw


def conv3_mxu_bf16_tiled_ref(x, k, scale=None, shift=None, relu=False,
                             out_dtype=torch.bfloat16, tile=None):
    """The bf16 kernel's bookkeeping in plain PyTorch: every block's halo
    of each stage (:func:`bf16_halos`), the A rows of each tap gathered
    from it (:func:`bf16_tap_rows`) with their slots in the kernel's
    channel order, the B operands of :func:`prepare_weights_bf16_ref` read
    back through the descriptor, one f32 partial a stage (9 taps x 2
    k-steps of exact products of bf16 values, kw by kw) added in stage
    order, the rows put back into the tiles (:func:`bf16_row_voxels`) and
    the columns in channel order, the tiles into the volume, the affine
    and ReLU in f32, one rounding to ``out_dtype``.  ``tile``: a (TH, TW)
    of the kernel's, by default :func:`bf16_tile`'s."""
    b, d, h, w, cin = x.shape
    cout = k.shape[4]
    th, tw = tile or bf16_tile(h, w)
    nth, ntw = -(-h // th), -(-w // tw)
    c32, nb = cin // BF16_UNIT, cout // 64
    halos = bf16_halos(x.float(), (th, tw))
    bm = prepare_weights_bf16_ref(k).reshape(3, c32, nb, 9, 2, 1024)
    bm = bm[..., b_offsets_bf16()].float()      # (kd, c, nb, tap, s, 16, 64)
    acc = 0.0
    for kd in range(3):
        # output plane o reads input plane o + kd - 1: halo index o + kd
        hal = halos[:, kd:kd + d].reshape(-1, *halos.shape[3:])
        for c in range(c32):
            chans = c * BF16_UNIT + unit_channels_bf16()
            part = 0.0
            for kw in range(3):
                for kh in range(3):
                    a = hal[:, bf16_tap_rows((th, tw), kh, kw)][..., chans]
                    for s in range(2):  # (blocks, 256, 16) @ (nb, 16, 64)
                        part = part + a[:, None, :, s] @ bm[kd, c, :,
                                                            3 * kh + kw, s]
            acc = acc + part                      # (blocks, nb, 256, 64)
    y = torch.empty_like(acc)
    y[..., column_channels_bf16()] = acc
    ry, rx = bf16_row_voxels((th, tw))
    tiles = torch.empty((acc.shape[0], th, tw, cout))
    tiles[:, ry, rx] = y.permute(0, 2, 1, 3).reshape(-1, 256, cout)
    y = tiles.reshape(b, d, nth, ntw, th, tw, cout)
    y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, d, nth * th, ntw * tw,
                                               cout)[:, :, :h, :w]
    return _epilogue(y, scale, shift, relu).to(out_dtype)


def conv3_mxu_bf16(x, k, scale=None, shift=None, relu=False, out_dtype=None):
    """K4 of the bfloat16 model: x (B, D, H, W, C_in) and k (3, 3, 3, C_in,
    C_out) DHWIO bfloat16; optional float32 per-C_out ``scale``/``shift``
    then optional ReLU.  Returns (B, D, H, W, C_out) bfloat16: the products
    exact, the sums, affine and ReLU in f32, one rounding.
    ``out_dtype=torch.float32`` keeps the f32 result unrounded: a check's
    form of the forward (a bf16 store would hide a fault of the sums), and
    the form :func:`conv3_mxu_dx_bf16` takes for the f32 model."""
    out_dtype = _bf16_out_dtype(out_dtype)
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if k.dim() != 5 or tuple(k.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"k must be (3, 3, 3, {cin}, C_out), "
                         f"got {tuple(k.shape)}")
    cout = k.shape[4]
    if not conv3mxu_bf16_supported(cin, cout):
        raise ValueError(f"conv3_mxu_bf16 takes C_in % 32 == 0 and "
                         f"C_out % 64 == 0, got {cin} -> {cout}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    _build.no_grad_inputs("conv3_mxu_bf16", x, k, scale, shift,
                          use="conv3_mxu_diff (float32)")
    dev = x.device
    _build.check(x, "x", device=dev, aligned=True, dtype=torch.bfloat16)
    _build.check(k, "k", device=dev, dtype=torch.bfloat16)
    if scale is not None:
        _build.check(scale, "scale", shape=(cout,), device=dev, aligned=True)
        _build.check(shift, "shift", shape=(cout,), device=dev, aligned=True)
    if dev.type == "cpu":
        return conv3_mxu_ref(x.float(), k, scale, shift, relu).to(out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu_bf16: unsupported device {dev}")

    out = _launch_bf16(x, k, cin, cout, scale, shift, relu, out_dtype,
                       transposed=False)
    conv3_mxu_bf16.launches += 1
    return out


conv3_mxu_bf16.launches = 0


def _bf16_out_dtype(out_dtype):
    out_dtype = torch.bfloat16 if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, "
                         f"got {out_dtype}")
    return out_dtype


def _launch_bf16(x, k, cin, cout, scale, shift, relu, out_dtype, transposed):
    """One call of the bf16 kernel for the conv C_in -> C_out that it runs:
    it lays the weights out into wp (as :func:`prepare_weights_bf16`, with
    ``transposed`` from the forward weights of a dx) and runs the conv."""
    b, d, h, w, _ = x.shape
    dev = x.device
    wp = torch.empty((3, cin // BF16_UNIT, cout // 64, 9, 2, 2, 8, 8, 8),
                     device=dev, dtype=torch.bfloat16)
    out = torch.empty((b, d, h, w, cout), device=dev, dtype=out_dtype)
    _build.launch(
        "hp_conv3_mxu_bf16_fwd", x.data_ptr(), k.data_ptr(), wp.data_ptr(),
        _build.ptr(scale), _build.ptr(shift), out.data_ptr(),
        _build.int_args(b, d, h, w, cin, cout, int(bool(relu)),
                        int(out_dtype == torch.float32), *bf16_tile(h, w),
                        int(transposed)),
        device=dev)
    return out


# ------------------------------------------------- the train step's routes
# The JAX package picks, at trace time, how a K4-eligible Bottleneck conv2
# runs in a train step from the ambient matmul precision.  Both of its
# choices are ported without their environment overrides (TPU A/B knobs).
# The ambient precision is this module's, set for a block by
# :func:`matmul_precision` (the train step's scope) and process-wide, as
# the library's TF32 flags that the step sets beside it.
PRECISIONS = ("default", "high", "highest")
_ambient = ["highest"]


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return precision


def current_precision() -> str:
    """The ambient matmul precision: 'highest' outside a
    :func:`matmul_precision` block."""
    return _ambient[0]


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``precision`` is the ambient one for the duration of the block (as
    ``jax.default_matmul_precision`` is for a trace)."""
    saved = _ambient[0]
    _ambient[0] = check_precision(precision)
    try:
        yield
    finally:
        _ambient[0] = saved


def route(precision: str | None = None) -> str:
    """``_route_policy`` (``hiddenpose_tpu/ops/pallas/conv3mxu.py:
    639-659``) at ``precision`` (the ambient one if None): 'full' (K4
    forward, K4-dx: :class:`Conv3Mxu`) under 'high' and 'highest', which
    ``kernel_dot_precision`` escalates to HIGHEST; 'bwd' (the library's
    forward, K4-dx-bf16: :class:`Conv3MxuBwd`) under 'default'."""
    precision = current_precision() if precision is None else precision
    return "bwd" if check_precision(precision) == "default" else "full"


def compute_dtype(precision: str) -> str:
    """``resolve_compute_dtype`` (``:592-610``): the kernel multiplies f32
    operands ('f32': three TF32 passes here) under 'high' and 'highest',
    bf16-rounded ones under 'default'."""
    return "bf16" if check_precision(precision) == "default" else "f32"


def conv3_mxu_dx_bf16_ref(dz, k, out_dtype=torch.float32):
    """Plain version of :func:`conv3_mxu_dx_bf16`: ``conv3d_input`` of dz
    and k rounded to bf16, in float32 (products of bf16 values are exact
    there), the result in ``out_dtype``."""
    bf16 = torch.bfloat16
    dx = conv3_mxu_dx_ref(dz.detach().to(bf16).float(),
                          k.detach().to(bf16).float())
    return dx.to(out_dtype)


def conv3_mxu_dx_bf16(dz, k, out_dtype=torch.float32):
    """K4-dx-bf16, the input gradient of the train step at the default
    precision (``_conv3_bwd`` into ``conv3_mxu`` at ``compute_dtype=
    'bf16'``, ``hiddenpose_tpu/ops/pallas/conv3mxu.py:569-576``): dz (B, D,
    H, W, C_out) and the forward's k (3, 3, 3, C_in, C_out), float32 or
    bfloat16, both rounded to bf16 (dz by a cast before the kernel, as the
    JAX wrapper's ``astype``; k in the weight preparation, which also flips
    the taps and swaps the channels), one pass of the bf16 kernel with f32
    sums.  Returns (B, D, H, W, C_in) in ``out_dtype``: float32 for the
    f32 model (the kernel's f32-output form), bfloat16 for the bf16
    model."""
    out_dtype = _bf16_out_dtype(out_dtype)
    if dz.dim() != 5 or k.dim() != 5 or tuple(k.shape[:3]) != (3, 3, 3) \
            or k.shape[4] != dz.shape[4]:
        raise ValueError(f"dz {tuple(dz.shape)} must be (B, D, H, W, C_out) "
                         f"of k (3, 3, 3, C_in, C_out), got {tuple(k.shape)}")
    cin, cout = k.shape[3], k.shape[4]
    if not conv3mxu_bf16_supported(cout, cin):
        raise ValueError(f"conv3_mxu_dx_bf16 runs the kernel {cout} -> {cin}: "
                         "needs C_out % 32 == 0 and C_in % 64 == 0")
    for t, name in ((dz, "dz"), (k, "k")):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: expected float32 or bfloat16, got "
                            f"{t.dtype}")
    _build.no_grad_inputs("conv3_mxu_dx_bf16", dz, k, use="conv3_mxu_bwd_diff")
    dev = dz.device
    if dev.type == "cpu":
        return conv3_mxu_dx_bf16_ref(dz, k, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu_dx_bf16: unsupported device {dev}")
    dzb, kb = dz.to(torch.bfloat16), k.to(torch.bfloat16)
    _build.check(dzb, "dz", device=dev, aligned=True, dtype=torch.bfloat16)
    _build.check(kb, "k", device=dev, dtype=torch.bfloat16)
    out = _launch_bf16(dzb, kb, cout, cin, None, None, False, out_dtype,
                       transposed=True)
    conv3_mxu_dx_bf16.launches += 1
    return out


conv3_mxu_dx_bf16.launches = 0


def conv3_library(x, k):
    """The library's SAME 3^3 conv of NDHWC x and DHWIO k, in x's type
    (the JAX package's ``_conv3_native``: a bf16 conv returns bf16)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _library_dk(x, k, g):
    """The library's weight gradient in x's type (``_conv3_dk_native``:
    f32 sums), in k's type and DHWIO."""
    dk = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3), (k.shape[4], k.shape[3], 3, 3, 3),
        g.to(x.dtype).permute(0, 4, 1, 2, 3), padding=1)
    return dk.permute(2, 3, 4, 1, 0).to(k.dtype)


class Conv3MxuBwd(torch.autograd.Function):
    """The 'bwd' route (``conv3_mxu_bwd_diff``, ``:544-589``): the
    library's forward in x's type, dx by :func:`conv3_mxu_dx_bf16` in x's
    type (its plain version with ``plain``), dk by the library's weight
    gradient."""

    @staticmethod
    def forward(ctx, x, k, plain):
        ctx.save_for_backward(x, k)
        ctx.plain = plain
        return conv3_library(x, k)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        need_x, need_k = ctx.needs_input_grad[:2]
        g = g.contiguous()
        dx_fn = conv3_mxu_dx_bf16_ref if ctx.plain else conv3_mxu_dx_bf16
        dx = dx_fn(g, k, out_dtype=x.dtype) if need_x else None
        dk = _library_dk(x, k, g) if need_k else None
        return dx, dk, None


def conv3_mxu_bwd_diff(x, k, plain=False):
    """The library's conv of NDHWC x and DHWIO k (float32, or bfloat16 in
    and out), differentiable, with K4-dx-bf16 for dx (its plain version
    with ``plain``)."""
    return Conv3MxuBwd.apply(x, k, plain)
