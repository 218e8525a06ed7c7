"""K2: the fused inference stem, Conv3d(1 -> 64, 7^3, pad 3) + eval BN + ReLU.

Replaces ``hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas``
(body ``_stem_kernel``).  The TPU kernel takes the raw volume and a
space-to-depth 5^3 kernel and returns the result in space-to-depth form;
this one takes the raw (B, D, H, W, 1) volume and the raw 7^3 DHWIO kernel
and writes the full-resolution NDHWC (B, D, H, W, 64) output, which the
pool (K3) and the channels-last backbone read directly.  The CUDA source
is ``csrc/stem_conv.cu``; its header says what bounds it (TF32 MMA issue at
three passes) and what the design does about it.

The arithmetic is that of K4 (``conv3mxu.py``): an implicit GEMM on the
tensor cores in **three TF32 passes with f32 sums (3xTF32), never one**.
The kernel's bookkeeping is written out in plain PyTorch here:
:func:`prepare_weights_ref` (the weights split and laid out in the MMA's
operand order, kw padded from 7 to 8; :func:`prepare_weights` runs the
preparation kernel on a CUDA tensor, one small launch a call) and
:func:`stem_conv_tiled_ref` (the input's halo split into hi and lo, each
lane's A values gathered from it as the kernel's warps do, the B operands
read back through the MMA's descriptor, the three passes summed a kd at a
time).  :func:`stem_conv_raw_ref` stays the plain version everything is
held against.

On a CPU tensor the wrapper runs :func:`stem_conv_raw_ref`; on a CUDA
tensor it launches the kernel or raises.  It is the serving stem only: it
raises when an input requires grad and grad mode is on.

:func:`stem_conv_raw_bf16` is the stem of the bfloat16 model, the JAX
kernel's arithmetic on bf16 operands (one bf16 MXU pass, f32 sums, the
affine and ReLU in f32, the result in bf16): its own kernel,
``csrc/stem_conv_bf16.cu``, one bf16 ``wgmma`` pass with f32 sums, the
channels as M and the voxels as N.  Its bookkeeping is written out in plain
PyTorch too (:func:`prepare_weights_bf16_ref`,
:func:`expanded_planes_bf16`, :func:`b_offsets_stem_bf16`,
:func:`stem_conv_bf16_tiled_ref`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build
from hiddenpose_tpu_torch.ops.kernels._tf32 import tf32_split

COUT = 64
# The kernel's block tile: two warpgroups, each an 8 x 8 patch of output
# voxels of a plane, side by side along W.
TILE_H, TILE_W = 8, 16
# The three products of a 3xTF32 MMA, in the order the kernel issues them.
TERMS = ("lo_hi", "hi_lo", "hi_hi")


def stem_conv_raw_ref(x, kernel, scale, shift, relu=True):
    """Plain version: ``F.conv3d(pad=3)`` + affine + ReLU in float32, NDHWC
    out in ``x``'s type (bfloat16 operands are widened exactly and the
    result rounded once: K2's bf16 contract)."""
    xc = x.float().permute(0, 4, 1, 2, 3)
    w = kernel.float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(xc, w, padding=3)
    y = y * scale[None, :, None, None, None] + shift[None, :, None, None, None]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


# The kernel's weight operand.  A k-step of the implicit GEMM is one (kd, kh)
# row of taps; its 8 k slots are kw 0..7, the eighth weight 0.  Each MMA
# reads its B operand (8 k x 64 n, hi or lo) from shared memory as 2 x 8
# "core matrices" of 4 k x 8 n, each 128 contiguous bytes (n-row r at 16 r
# bytes, its 4 k values): element (k, n) at k % 4 + 4 (n % 8) + 256 (k / 4)
# + 32 (n / 8) floats.  Column r of n-tile ng = 2p + q is output channel
# 16p + 4(r / 2) + 2q + r % 2, so that a lane's accumulators of two n-tiles
# are 4 consecutive channels (one 16-byte store), as in K4.
def prepare_weights_ref(kernel):
    """Plain version of :func:`prepare_weights`: the (7, 7, 7, 1, 64) DHWIO
    kernel, kw padded to 8, split by :func:`tf32_split` and laid out as (49
    k-steps, 2 parts, 2 core matrices along k, 8 along n, 8 rows, 4)."""
    w = F.pad(kernel.float().reshape(7, 7, 7, COUT), (0, 0, 0, 1))
    parts = torch.stack(tf32_split(w))
    # (part, kd, kh, kc, e, p, r / 2, q, r % 2)
    parts = parts.reshape(2, 7, 7, 2, 4, 4, 4, 2, 2)
    # -> (kd, kh, part, kc, p, q, r / 2, r % 2, e)
    parts = parts.permute(1, 2, 0, 3, 5, 7, 6, 8, 4)
    return parts.reshape(49, 2, 2, 8, 8, 4).contiguous()


def prepare_weights(kernel):
    """The kernel's weight operand (see :func:`prepare_weights_ref`), made
    by one small kernel of ``csrc/stem_conv.cu`` for a CUDA tensor."""
    if kernel.device.type == "cpu":
        return prepare_weights_ref(kernel)
    if kernel.device.type != "cuda":
        raise ValueError(f"prepare_weights: unsupported device {kernel.device}")
    wp = torch.empty((49, 2, 2, 8, 8, 4), device=kernel.device,
                     dtype=torch.float32)
    _build.launch("hp_stem_conv_prep", kernel.data_ptr(), wp.data_ptr(),
                  device=kernel.device)
    return wp


def operand_b(wp):
    """B of each (kd, kh, part) as the MMA reads it through its descriptor:
    (7, 7, 2, 8 k, 64 columns)."""
    k = torch.arange(8)[:, None]
    n = torch.arange(64)[None, :]
    off = k % 4 + 4 * (n % 8) + 256 * (k // 4) + 32 * (n // 8)
    return wp.reshape(7, 7, 2, 512)[..., off]


def column_channels():
    """The output channel of each of the MMA's 64 columns."""
    n = torch.arange(64)
    ng, r = n // 8, n % 8
    return 16 * (ng // 2) + 4 * (r // 2) + 2 * (ng % 2) + r % 2


@functools.lru_cache(maxsize=1)
def a_gather():
    """Where the kernel's lanes load A from: for each warpgroup of the block
    tile, k-step kh of a kd, row m and k slot of the MMA's A, the (hy, wx)
    of the halo plane (hy 0..13, wx 0..22: the tile's rows and columns
    from -3 on, the last column zeros), as (2, 7, 64, 8) each.  Lane (g, t)
    of warp w loads halo rows 2w + j (j 0..7), columns g + t and g + t + 4
    of its warpgroup's patch, and hands them to the MMA as the A fragment of
    k-step kh: (row 16w + g, k t) row j = kh, (16w + g + 8, t) row kh + 1,
    (16w + g, t + 4) and (16w + g + 8, t + 4) likewise at + 4."""
    hy = torch.full((2, 7, 64, 8), -1, dtype=torch.long)
    wx = torch.full((2, 7, 64, 8), -1, dtype=torch.long)
    for wg in range(2):
        for kh in range(7):
            for w in range(4):
                for g in range(8):
                    for t in range(4):
                        for reg in range(4):
                            j = kh + reg % 2
                            c = reg // 2
                            m = 16 * w + g + 8 * (reg % 2)
                            k = t + 4 * c
                            hy[wg, kh, m, k] = 2 * w + j
                            wx[wg, kh, m, k] = 8 * wg + g + t + 4 * c
    assert (hy >= 0).all() and (wx >= 0).all()  # every (m, k) loaded once
    return hy, wx


def stem_conv_tiled_ref(x, kernel, scale, shift, relu=True, terms=TERMS):
    """The kernel's bookkeeping in plain PyTorch: the block tiles of each
    plane, the input's halo split into (hi, lo), each warpgroup's A gathered
    as its lanes load it (:func:`a_gather`), the B operands of
    :func:`prepare_weights_ref` read back through the descriptor, the
    products of ``terms`` summed a kd at a time (f32 matrix products), the
    seven kd partials added in order, the columns put back in channel order,
    then the affine and ReLU.  Same arguments and result as
    :func:`stem_conv_raw_ref`."""
    b, d, h, w, _ = x.shape
    th, tw = -(-h // TILE_H), -(-w // TILE_W)
    pad = (3, 3 + tw * TILE_W - w + 1, 3, 3 + th * TILE_H - h, 3, 3)
    halo = dict(zip(("hi", "lo"), tf32_split(F.pad(x[..., 0].float(), pad))))
    bmat = operand_b(prepare_weights_ref(kernel))  # (kd, kh, part, 8, 64)
    bmat = {"hi": bmat[:, :, 0], "lo": bmat[:, :, 1]}
    hy, wx = a_gather()
    # halo indices, broadcast to (b, d, th, tw, wg, kh, m, k)
    ti = (torch.arange(th) * TILE_H).view(th, 1, 1, 1, 1, 1)
    tj = (torch.arange(tw) * TILE_W).view(tw, 1, 1, 1, 1)
    iy, ix = ti + hy, tj + wx
    ib = torch.arange(b).view(b, 1, 1, 1, 1, 1, 1, 1)
    acc = 0.0
    for kd in range(7):
        iz = (torch.arange(d) + kd).view(d, 1, 1, 1, 1, 1, 1)
        a = {p: halo[p][ib, iz, iy, ix] for p in ("hi", "lo")}
        part = 0.0
        for term in terms:
            pa, pb = term.split("_")
            # sum over (kh, k): (..., wg, kh, m, k) x (kh, k, n)
            am = a[pa].permute(0, 1, 2, 3, 4, 6, 5, 7).flatten(-2)
            part = part + am @ bmat[pb][kd].reshape(56, 64)
        acc = acc + part  # (b, d, th, tw, wg, m, n)
    y = torch.empty_like(acc)
    y[..., column_channels()] = acc
    # row m = 16 w + 8 half + g of warpgroup wg is the voxel (2w + half,
    # 8 wg + g) of the block tile: (.., wg, w, half, g, n) -> (b, d, th, w,
    # half, tw, wg, g, n)
    y = y.view(b, d, th, tw, 2, 4, 2, 8, COUT)
    y = y.permute(0, 1, 2, 5, 6, 3, 4, 7, 8)
    y = y.reshape(b, d, th * TILE_H, tw * TILE_W, COUT)[:, :, :h, :w]
    y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()


def stem_conv_raw(x, kernel, scale, shift, relu=True):
    """x (B, D, H, W, 1) raw volume; kernel (7, 7, 7, 1, 64) DHWIO;
    scale/shift (64,) folded eval-BN affine.  Returns
    relu(conv7^3(x) * scale + shift) as (B, D, H, W, 64), float32."""
    if x.dim() != 5 or x.shape[-1] != 1:
        raise ValueError(f"x must be (B, D, H, W, 1), got {tuple(x.shape)}")
    b, d, h, w, _ = x.shape
    # Eval only: training keeps the library stem conv (posenet3d.py).
    _build.no_grad_inputs("stem_conv_raw", x, kernel, scale, shift,
                          use="the library conv (training has no fused stem)")
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(kernel, "kernel", shape=(7, 7, 7, 1, COUT), device=dev)
    _build.check(scale, "scale", shape=(COUT,), device=dev, aligned=True)
    _build.check(shift, "shift", shape=(COUT,), device=dev, aligned=True)
    if dev.type == "cpu":
        return stem_conv_raw_ref(x, kernel, scale, shift, relu)
    if dev.type != "cuda":
        raise ValueError(f"stem_conv_raw: unsupported device {dev}")

    wp = prepare_weights(kernel)
    out = torch.empty((b, d, h, w, COUT), device=dev, dtype=torch.float32)
    _build.launch(
        "hp_stem_conv_fwd", x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), b, d, h, w, int(bool(relu)),
        device=dev)
    stem_conv_raw.launches += 1
    return out


stem_conv_raw.launches = 0


# ------------------------------------------------------------------- bf16
# The bf16 kernel (csrc/stem_conv_bf16.cu) swaps the roles of K2's GEMM: M
# is the 64 output channels (the weights, resident in shared memory), N is
# 128 voxels of an output plane (8 H rows x 16 W columns, one warpgroup's
# half of a 16 x 16 block tile), K is the taps, on wgmma m64n128k16 with
# both operands read from shared memory by descriptor.  A k-step is 16
# taps: rows 2j and 2j + 1 of the 49 (kd, kh) rows (row r = 7 kd + kh; row
# 49 is zero weights), kw 0..7 in each (kw 7 zero), so 25 k-steps where
# 24.5 would do.  The voxels' operand is the *expanded* halo plane: for
# each halo row and output column the 16 bytes of the 8 inputs its kw taps
# read, x[.., w - 3 + kw] for kw 0..7, so an MMA reads its B (16 k x 128 n,
# K-major) as core matrices of 8 voxels x 8 kw: row r0 of the k-step at
# the descriptor's start, row r1 LBO bytes on (one expanded row, or, where
# the k-step straddles two kd, the distance to the next plane's slot: the
# ring of plane slots is mirrored so that the seven planes of an output
# plane lie at consecutive slots).  The accumulator's rows are the
# channels in order; the epilogue transposes it through shared memory.
BF16_TH, BF16_TW = 16, 16       # the block tile: two warpgroups of 8 x 16
BF16_KSTEPS = 25
BF16_STAGES = 2                 # f32 partials a plane: k-steps 0..12, 13..24
BF16_ROWS = BF16_TH + 7         # expanded rows of a plane slot (last: zero)
BF16_ROW = BF16_TW * 8          # bf16 of an expanded row
BF16_SLOT = BF16_ROWS * BF16_ROW  # bf16 of a plane slot


def prepare_weights_bf16_ref(kernel):
    """Plain version of :func:`prepare_weights_bf16`: the (7, 7, 7, 1, 64)
    DHWIO bf16 kernel as the MMA's A operand, (25 k-steps, 2 halves along
    k, 8 core matrices along the channels, 8 channels, 8 kw) bf16: element
    (j, half, g, r, kw) is tap (kd, kh) = divmod(2j + half, 7), kw, of
    channel 8g + r; row 49 and kw 7 are zero."""
    w = F.pad(kernel.reshape(49, 7, COUT), (0, 0, 0, 1, 0, 1))  # (50, 8, 64)
    w = w.reshape(BF16_KSTEPS, 2, 8, 8, 8)  # (j, half, kw, g, r)
    return w.permute(0, 1, 3, 4, 2).contiguous()


def prepare_weights_bf16(kernel):
    """The bf16 kernel's weight operand (see
    :func:`prepare_weights_bf16_ref`), made by one small kernel of
    ``csrc/stem_conv_bf16.cu`` for a CUDA tensor."""
    if kernel.device.type == "cpu":
        return prepare_weights_bf16_ref(kernel)
    if kernel.device.type != "cuda":
        raise ValueError(f"prepare_weights_bf16: unsupported device "
                         f"{kernel.device}")
    wp = torch.empty((BF16_KSTEPS, 2, 8, 8, 8), device=kernel.device,
                     dtype=torch.bfloat16)
    _build.launch("hp_stem_conv_bf16_prep", kernel.data_ptr(), wp.data_ptr(),
                  device=kernel.device)
    return wp


def operand_a_bf16(wp):
    """A of each k-step as the MMA reads it through its descriptor (K-major,
    1024 bytes between the halves along k, 128 between the core matrices
    along the channels): (25, 64 channels, 16 k)."""
    m = torch.arange(COUT)[:, None]
    k = torch.arange(16)[None, :]
    off = k % 8 + 8 * (m % 8) + 512 * (k // 8) + 64 * (m // 8)
    return wp.reshape(BF16_KSTEPS, 1024)[:, off]


def b_row_offsets_bf16():
    """(start, lbo) of each warpgroup's B descriptor for each k-step, in
    bf16 from the slot of the output plane's first input plane (kd 0): row
    (kd, kh) of warpgroup wg is slot kd, expanded row 8 wg + kh; row 49,
    the zero weights', reads expanded row 8 wg + 7 of slot 6 (the slot's
    zero row for warpgroup 1).  Two (2, 25) long tensors."""
    rows = [divmod(r, 7) for r in range(49)] + [(6, 7)]
    start = torch.empty((2, BF16_KSTEPS), dtype=torch.long)
    lbo = torch.empty((2, BF16_KSTEPS), dtype=torch.long)
    for wg in range(2):
        off = [kd * BF16_SLOT + (8 * wg + kh) * BF16_ROW for kd, kh in rows]
        for j in range(BF16_KSTEPS):
            start[wg, j] = off[2 * j]
            lbo[wg, j] = off[2 * j + 1] - off[2 * j]
    assert (lbo > 0).all()  # a descriptor's offsets are unsigned
    return start, lbo


@functools.lru_cache(maxsize=1)
def b_offsets_stem_bf16():
    """(2 warpgroups, 25 k-steps, 16 k, 128 n): the bf16 of the seven
    consecutive plane slots that the MMA's B descriptor reads as (k, n),
    element (k % 8) + 8 (n % 8) + lbo (k / 8) + 64 (n / 8) from the
    k-step's start (16-byte rows of one voxel's 8 kw, 128 bytes between
    the core matrices of 8 voxels): voxel n is (H row n / 16, W column n %
    16) of the warpgroup's 8 x 16."""
    start, lbo = b_row_offsets_bf16()
    k = torch.arange(16)[:, None]
    n = torch.arange(128)[None, :]
    return (start[..., None, None] + k % 8 + 8 * (n % 8)
            + lbo[..., None, None] * (k // 8) + 64 * (n // 8))


def expanded_planes_bf16(x):
    """The kernel's plane slots for every (batch, input plane, block tile):
    (B, D + 6, tiles_h, tiles_w, 23 rows, 16 columns, 8 kw) in x's dtype,
    slot (b, p) holding input plane p - 3; its (row, w, kw) is x[h0 - 3 +
    row, w0 - 3 + w + kw] of the tile at (h0, w0), zero outside the volume
    and in row 22."""
    b, d, h, w, _ = x.shape
    th, tw = -(-h // BF16_TH), -(-w // BF16_TW)
    pad = (3, BF16_TW * tw + 4 - w, 3, BF16_TH * th + 3 - h, 3, 3)
    xp = F.pad(x[..., 0], pad)
    rows = (torch.arange(th) * BF16_TH)[:, None] + torch.arange(BF16_ROWS - 1)
    cols = ((torch.arange(tw) * BF16_TW)[:, None, None]
            + torch.arange(BF16_TW)[:, None] + torch.arange(8))
    e = xp[:, :, rows][..., cols]  # (b, d + 6, th, 22, tw, 16, 8)
    e = F.pad(e.permute(0, 1, 2, 4, 3, 5, 6), (0, 0, 0, 0, 0, 1))
    return e.contiguous()


def stem_conv_bf16_tiled_ref(x, kernel, scale, shift, relu=True,
                             out_dtype=torch.bfloat16):
    """The bf16 kernel's bookkeeping in plain PyTorch: the expanded plane
    slots of each block tile (:func:`expanded_planes_bf16`), the seven of an
    output plane side by side as the mirrored ring holds them, each
    warpgroup's B read through its descriptors
    (:func:`b_offsets_stem_bf16`), A through its own
    (:func:`operand_a_bf16` of :func:`prepare_weights_bf16_ref`), the
    k-steps of each stage (13, then 12) summed into an f32 partial (f32
    matrix products of bf16 values), the partials added in order, the voxels put back in place,
    then the affine and ReLU in f32 and one rounding to ``out_dtype``.
    Same arguments and result as :func:`stem_conv_raw_ref` on bf16
    operands."""
    b, d, h, w, _ = x.shape
    e = expanded_planes_bf16(x).float()
    th, tw = e.shape[2], e.shape[3]
    e = e.reshape(b, d + 6, th, tw, BF16_SLOT)
    ring = torch.stack([e[:, kd:kd + d] for kd in range(7)], dim=4)
    ring = ring.reshape(b, d, th, tw, 7 * BF16_SLOT)
    bmat = ring[..., b_offsets_stem_bf16()]  # (b, d, th, tw, 2, 25, 16, 128)
    amat = operand_a_bf16(prepare_weights_bf16_ref(kernel)).float()
    acc = 0.0
    for s in range(BF16_STAGES):
        js = slice(*(-(-t * BF16_KSTEPS // BF16_STAGES) for t in (s, s + 1)))
        a = amat[js].permute(1, 0, 2).reshape(COUT, -1)  # (64, 16 k-steps)
        bs = bmat[..., js, :, :].flatten(-3, -2)         # (.., 16 k-steps, 128)
        acc = acc + a @ bs                               # (.., wg, 64, 128)
    # (b, d, th, tw, wg, c, row, col) -> (b, d, th, wg, row, tw, col, c)
    y = acc.view(b, d, th, tw, 2, COUT, 8, BF16_TW)
    y = y.permute(0, 1, 2, 4, 6, 3, 7, 5)
    y = y.reshape(b, d, th * BF16_TH, tw * BF16_TW, COUT)[:, :, :h, :w]
    y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(out_dtype).contiguous()


def stem_conv_raw_bf16(x, kernel, scale, shift, relu=True, out_dtype=None):
    """The stem of the bfloat16 model: x (B, D, H, W, 1) and kernel
    (7, 7, 7, 1, 64) DHWIO bfloat16, scale / shift (64,) float32.  Returns
    relu(conv7^3(x) * scale + shift) as (B, D, H, W, 64) bfloat16: the
    products exact, the sums, affine and ReLU in f32, one rounding.
    ``out_dtype=torch.float32`` keeps the f32 result unrounded: a check's
    form of the same kernel (a bf16 store would hide a fault of the sums),
    never the model's."""
    out_dtype = torch.bfloat16 if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, "
                         f"got {out_dtype}")
    if x.dim() != 5 or x.shape[-1] != 1:
        raise ValueError(f"x must be (B, D, H, W, 1), got {tuple(x.shape)}")
    b, d, h, w, _ = x.shape
    _build.no_grad_inputs("stem_conv_raw_bf16", x, kernel, scale, shift,
                          use="the library conv (training has no fused stem)")
    dev = x.device
    _build.check(x, "x", device=dev, dtype=torch.bfloat16)
    _build.check(kernel, "kernel", shape=(7, 7, 7, 1, COUT), device=dev,
                 dtype=torch.bfloat16)
    _build.check(scale, "scale", shape=(COUT,), device=dev, aligned=True)
    _build.check(shift, "shift", shape=(COUT,), device=dev, aligned=True)
    if dev.type == "cpu":
        return stem_conv_raw_ref(x.float(), kernel, scale, shift,
                                 relu).to(out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"stem_conv_raw_bf16: unsupported device {dev}")

    wp = prepare_weights_bf16(kernel)
    out = torch.empty((b, d, h, w, COUT), device=dev, dtype=out_dtype)
    _build.launch(
        "hp_stem_conv_bf16_fwd", x.data_ptr(), wp.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b, d, h, w,
        int(bool(relu)), int(out_dtype == torch.float32), device=dev)
    stem_conv_raw_bf16.launches += 1
    return out


stem_conv_raw_bf16.launches = 0
