"""K1: SAME 3x3x3 stride-1 stencil convolution on channels-planes volumes.

Replaces ``hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes`` (the Pallas
bodies ``_conv3p_kernel`` / ``_conv3p_kernel_db``), with the same argument
order, the same (B, C, D, H, W) planes layout (which is PyTorch's NCDHW)
and a DHWIO kernel.  The CUDA source is ``csrc/conv3p.cu``, a front of the
tile walk in ``csrc/conv3p_tile.cuh``, whose header says how a block walks
down D with each input plane staged once and what bounds it on the card
(bytes at one channel each way, fp32 FMAs from four channels on).
:func:`tile_plan` cuts a call into blocks; :func:`conv3_planes_tiled_ref`
and :func:`conv3_planes_adjoint_tiled_ref` are that walk in plain PyTorch,
for the CPU tests.

The TPU kernel's eligibility limits (``cin * cout <= 64``, ``W <= 128``,
``H % 8 == 0``) were limits of its compiler, not of the contract: this
kernel takes any shape, so every FeatureExtraction and UNet 3^3 conv uses
it.

Its gradient (:class:`Conv3Planes`, the port of ``_conv3p_diff``) runs two
more kernels: K5 (:func:`conv3_planes_adjoint`, ``csrc/conv3p_adjoint.cu``:
the same tile walk on flipped, swapped taps, with the edge padding's fold
onto the faces) for dx and K6 (:func:`conv3_planes_wgrad`,
``csrc/conv3p_wgrad.cu``) for the kernel and bias gradients.  Their TPU
counterparts take ``cin * cout <= 64`` and ``<= 32`` and leave the rest to
XLA; both Hopper kernels take every shape of the path.

On a CPU tensor each wrapper runs its plain PyTorch version (``*_ref``); on
a CUDA tensor it launches the kernel or raises.  A wrapper also raises when
an input requires grad and grad mode is on: under autograd only
:func:`conv3_planes_diff` may call it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build

_ACTS = {"none": 0, "relu": 1, "leaky": 2}
_PADS = {"zero": 0, "edge": 1}


def _activation(out, act):
    # torch.relu's gradient at exactly 0 is 0, as the JAX backward's
    # ``out > 0`` mask; clamp_min's would be 1.
    if act == "relu":
        return torch.relu(out)
    if act == "leaky":
        return torch.where(out >= 0.0, out, 0.2 * out)
    return out


def conv3_planes_ref(x, kernel, bias=None, residual=None, pre_scale=None,
                     pre_shift=None, *, act="none", pad_mode="zero",
                     pre_relu=None):
    """Plain version: pre-affine, pad, ``F.conv3d``, bias, residual, act,
    all in float32; the result in ``x``'s type (a bfloat16 x and residual
    are widened first and the result rounded once, K1's bf16 contract)."""
    dtype = x.dtype
    x = x.float()
    if pre_relu is not None:
        x = x * pre_scale[None, :, None, None, None] \
            + pre_shift[None, :, None, None, None]
        if pre_relu:
            x = torch.relu(x)
    mode = "replicate" if pad_mode == "edge" else "constant"
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode=mode)
    w = kernel.float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    out = F.conv3d(xp, w, bias)
    if residual is not None:
        out = out + residual.float()
    return _activation(out, act).to(dtype)


# The tile walk of K1 and K5 (``csrc/conv3p_tile.cuh``).  A block is cut
# down along D, then in H, until the call has this many blocks: the first
# count while a block keeps at least TILE_LONG_CHUNK planes (a short run
# re-reads its two halo planes more often), the second at any cost.
TILE_BLOCKS_LONG = 264      # two a multiprocessor of the H100
TILE_LONG_CHUNK = 2
TILE_BLOCKS = 128
TILE_POSITIONS = 128         # columns x thread rows of a tile, at most
TILE_SMS = 132               # multiprocessors of the H100
TILE_SM_THREADS = 512        # threads of 128 registers one of them holds
TILE_MAX_THREADS = 512       # of a block
TILE_SLOT_BYTES = 64 * 1024  # one staged unit, at most
TILE_TAPS_BYTES = 64 * 1024  # taps of all source channels that may stay
TILE_MAX_SMEM = 232448       # bytes a block may use on the H100
# (channels a block, rows a thread) a conv to more than one channel may
# take (27 x rows x channels sums in three slots stay in registers): the
# one that pads the channels least, the first on a tie
TILE_FORMS = ((8, 2), (4, 4))
_ROW_PITCH = {(32, 2): 40, (32, 4): 40, (16, 2): 24, (16, 4): 28}


class TilePlan(NamedTuple):
    """How one call of K1 or K5 is cut (see :func:`tile_plan`)."""
    tw: int       # tile width: 32, or 16 where W is no wider
    cb: int       # destination channels a block holds in registers
    r: int        # rows of one column a thread owns
    thr: int      # thread rows
    splits: int   # thread groups the source channels are dealt to
    chunk: int    # planes of D a block walks
    cg: int       # source channels staged at a time
    wres: int     # 1: the taps of all source channels stay resident

    @property
    def th(self):
        return self.thr * self.r

    @property
    def threads(self):
        return self.tw * self.thr * self.splits

    def grid(self, b, dst, d, h, w):
        """(H x W tiles, D chunks, B x channel groups)."""
        return (-(-h // self.th) * -(-w // self.tw), -(-d // self.chunk),
                b * -(-dst // self.cb))

    def smem_bytes(self, src):
        xplane = (self.th + 2) * _ROW_PITCH[self.tw, self.r]
        resident = bool(self.wres)
        taps = -(-(src if resident else self.cg) * 27 * self.cb // 4) * 4
        slot = self.cg * xplane + (0 if resident else taps)
        red = (self.splits * self.r * self.cb * self.tw * self.thr
               if self.splits > 1 else 0)
        return 4 * (3 * slot + (taps if resident else 0) + red)


@functools.lru_cache(maxsize=None)
def tile_plan(b, src, dst, d, h, w):
    """The :class:`TilePlan` of a 3^3 stencil from ``src`` to ``dst``
    channels over (b, d, h, w): K1 with (C_in, C_out), K5 with
    (C_out, C_in).  The channel block is the one of ``TILE_FORMS`` that
    pads ``dst`` least (1 for one channel); the tile is cut until the card
    has blocks enough, and the source channels are split where the voxels
    alone give too few threads."""
    tw = 32 if w > 16 else 16
    cb, r = (1, 4) if dst == 1 else min(
        TILE_FORMS, key=lambda f: -(-dst // f[0]) * f[0])
    # a one-channel block moves bytes, not FMAs: twice the rows
    thr = min((2 if cb == 1 else 1) * TILE_POSITIONS // tw, -(-h // r))
    chunk = d

    def blocks():
        return (b * -(-dst // cb) * -(-h // (thr * r)) * -(-w // tw)
                * -(-d // chunk))

    while blocks() < TILE_BLOCKS_LONG and chunk > TILE_LONG_CHUNK:
        chunk = -(-chunk // 2)
    while blocks() < TILE_BLOCKS:
        if chunk > 2:
            chunk = -(-chunk // 2)
        elif thr > 1:
            thr = -(-thr // 2)
        elif chunk > 1:
            chunk = 1
        else:
            break
    # The source channels are dealt to 1, 2, 4, ... thread groups: the
    # count that keeps most threads busy on a multiprocessor (as many
    # blocks as their shared memory and 128 registers a thread let it
    # hold, and the call gives it), the smaller on a tie.  A unit holds all
    # source channels where they fit its share of the shared memory, else
    # a multiple of the splits; the taps stay resident where all source
    # channels' are few, or one unit holds them all.
    per_sm = min(4, -(-blocks() // TILE_SMS))
    xplane = 4 * (thr * r + 2) * _ROW_PITCH[tw, r]
    best, busy = None, 0
    splits = 1
    while (splits <= min(src, r * cb)
           and tw * thr * splits <= TILE_MAX_THREADS):
        threads = tw * thr * splits
        red = 4 * splits * r * cb * tw * thr if splits > 1 else 0
        taps = 4 * 27 * cb  # a channel's
        wres = src * taps <= TILE_TAPS_BYTES
        slot = min(TILE_SLOT_BYTES,
                   (TILE_MAX_SMEM // per_sm - red - wres * src * taps) // 3)
        channel = xplane + (0 if wres else taps)  # bytes of a slot
        cg = src
        if src * channel > slot:
            cg = max(1, slot // channel)
            cg = -(-src // -(-src // cg))  # groups of equal size
            cg = min(src, -(-cg // splits) * splits)
        wres = wres or cg >= src
        plan = TilePlan(tw, cb, r, thr, splits, chunk, cg, int(wres))
        smem = plan.smem_bytes(src)
        if smem <= TILE_MAX_SMEM:
            held = min(per_sm, TILE_SM_THREADS // threads,
                       TILE_MAX_SMEM // smem) * threads
            if held > busy:
                best, busy = plan, held
        splits *= 2
    if best is None:
        raise ValueError(f"tile_plan: no plan for {(b, src, dst, d, h, w)} "
                         "fits the shared memory")
    return best


def fold_taps(i, n):
    """The extra taps of input ``i`` of ``n`` along one axis under K5's
    edge fold (``conv3p_tile.cuh``): beside a forward conv's three (source
    offset, staged tap) pairs (0, 0), (1, 1), (2, 2), whose member outside
    the volume reads a zero, a voxel on a face takes its own position
    (offset 1) with the outward tap: staged tap 2 at index 0, 0 at index
    n - 1, both where n == 1.  Staged taps are the forward's, flipped."""
    return [2] * (i == 0) + [0] * (i == n - 1)


def tile_is_face(plan, h0, w0, h, w):
    """Whether the tile at (h0, w0) touches a face of the (h, w) plane: K5
    under edge padding adds the extra taps of :func:`fold_taps` there."""
    return (h0 == 0 or h0 + plan.th >= h or w0 == 0 or w0 + plan.tw >= w)


def _tile_walk_ref(src, taps, plan, *, clamp, fold):
    """``conv3p_tile.cuh`` in plain PyTorch, block by block: ``src``
    (B, cs, D, H, W), ``taps`` (3, 3, 3, cs, cd) as staged (K5: flipped and
    swapped).  Source plane p adds tap plane kd into output plane
    p + 1 - kd (under ``fold`` the planes 0 and D - 1 keep their outward
    tap, and a tile on a face adds its extra taps); each split sums its own channels of every unit, and the splits'
    sums are added in split order."""
    b, cs, d, h, w = src.shape
    cd = taps.shape[4]
    sp = F.pad(src, (1,) * 6, mode="replicate" if clamp else "constant")
    out = torch.zeros((b, cd, d, h, w), dtype=src.dtype)
    th, tw = plan.th, plan.tw
    # each split's channels, in the order it meets them: every
    # ``splits``-th of every unit
    chans = [[c for g in range(0, cs, plan.cg)
              for c in range(g + s, min(g + plan.cg, cs), plan.splits)]
             for s in range(plan.splits)]
    sps = [sp[:, ch] for ch in chans]
    for j0 in range(0, cd, plan.cb):
        j1 = min(j0 + plan.cb, cd)
        # per split, the three tap planes as one conv2d weight
        wks = [taps[:, :, :, ch, j0:j1] for ch in chans]
        w2d = [wk.permute(0, 4, 3, 1, 2).reshape(3 * (j1 - j0), len(ch), 3, 3)
               for wk, ch in zip(wks, chans)]
        for d0 in range(0, d, plan.chunk):
            d1 = min(d0 + plan.chunk, d)
            pa, pb = d0 - 1, d1
            if not clamp:
                pa, pb = max(pa, 0), min(pb, d - 1)
            for h0 in range(0, h, th):
                for w0 in range(0, w, tw):
                    h1, w1 = min(h0 + th, h), min(w0 + tw, w)
                    face = fold and tile_is_face(plan, h0, w0, h, w)
                    acc = None
                    for s in range(plan.splits):
                        part = torch.zeros((b, j1 - j0, d1 - d0, h1 - h0,
                                            w1 - w0), dtype=src.dtype)
                        for p in range(pa, pb + 1):
                            # padded coordinates: plane p is sp's p + 1
                            reg = sps[s][:, :, p + 1, h0:h1 + 2, w0:w1 + 2]
                            y = F.conv2d(reg, w2d[s]).unflatten(
                                1, (3, j1 - j0))
                            for kd in range(3):
                                t = p + 1 - kd
                                if fold and d0 <= p < d1:
                                    t = min(max(t, 0), d - 1)
                                if not d0 <= t < d1:
                                    continue
                                part[:, :, t - d0] += y[:, kd]
                                if face:
                                    part[:, :, t - d0] += _plane_extras(
                                        reg, wks[s][kd], h0, w0, h, w)
                        acc = part if acc is None else acc + part
                    out[:, j0:j1, d0:d1, h0:h1, w0:w1] = acc
    return out


def _plane_extras(reg, wk, h0, w0, h, w):
    """The extra taps of one tap plane on a face tile: own row x three
    columns, three rows x own column, own voxel, each with the outward
    tap(s) of :func:`fold_taps`.  ``reg`` (B, C, rows + 2, cols + 2),
    ``wk`` (3, 3, C, cb)."""
    rows, cols = reg.shape[2] - 2, reg.shape[3] - 2
    out = torch.zeros((reg.shape[0], wk.shape[3], rows, cols),
                      dtype=reg.dtype)
    for i in range(rows):
        for th in fold_taps(h0 + i, h):
            for kw in range(3):
                out[:, :, i] += torch.einsum(
                    "bcw,cj->bjw", reg[:, :, i + 1, kw:kw + cols], wk[th, kw])
            for j in range(cols):
                for tw in fold_taps(w0 + j, w):
                    out[:, :, i, j] += reg[:, :, i + 1, j + 1] @ wk[th, tw]
    for j in range(cols):
        for tw in fold_taps(w0 + j, w):
            for kh in range(3):
                out[:, :, :, j] += torch.einsum(
                    "bch,cj->bjh", reg[:, :, kh:kh + rows, j + 1], wk[kh, tw])
    return out


def conv3_planes_tiled_ref(x, kernel, bias=None, residual=None,
                           pre_scale=None, pre_shift=None, *, act="none",
                           pad_mode="zero", pre_relu=None, plan=None):
    """:func:`conv3_planes` by K1's tile walk in plain PyTorch (the blocks,
    D runs, channel units and split fold of ``plan``, by default
    :func:`tile_plan`'s), for the CPU tests."""
    b, cin, d, h, w = x.shape
    cout = kernel.shape[4]
    plan = plan or tile_plan(b, cin, cout, d, h, w)
    x = x.float()
    if pre_relu is not None:  # before the padding
        x = x * pre_scale[None, :, None, None, None] \
            + pre_shift[None, :, None, None, None]
        if pre_relu:
            x = torch.relu(x)
    out = _tile_walk_ref(x, kernel.float(), plan,
                         clamp=pad_mode == "edge", fold=False)
    if bias is not None:
        out = out + bias[None, :, None, None, None]
    if residual is not None:
        out = out + residual
    return _activation(out, act)


def conv3_planes_adjoint_tiled_ref(dz, kernel, *, pad_mode="zero",
                                   plan=None):
    """:func:`conv3_planes_adjoint` by K5's tile walk in plain PyTorch:
    K1's on flipped, swapped taps, with the fold of the clamped reads
    under edge padding."""
    b, cout, d, h, w = dz.shape
    cin = kernel.shape[3]
    plan = plan or tile_plan(b, cout, cin, d, h, w)
    taps = kernel.float().flip(0, 1, 2).transpose(3, 4)
    return _tile_walk_ref(dz.float(), taps, plan, clamp=False,
                          fold=pad_mode == "edge")


def row_pitch16(tw, r):
    """Values of a staged bf16 row (``conv3p_tile.cuh``'s BF16 ROWS): a
    multiple of 8 that puts the two thread rows of a warp of a 16-wide tile
    into distinct banks."""
    return 48 if tw == 32 else (40 if r == 4 else 48)


def bf16_staged_rows(x, plan, b, c, p, h0, *, clamp, w0):
    """Plane ``p`` of channel ``c`` of batch ``b`` as K1-bf16 leaves it in
    a ring slot for the block at (h0, w0): (XH, row_pitch16) float32 values
    of the bf16 ``x``, NaN where the kernel writes nothing.  Column
    w0 - 1 + xx at index xx + 7; where W % 8 == 0 the tile's own columns
    arrive as 8-value copies (zero past W) and the halo columns as the
    4-byte pairs (w0 - 2, w0 - 1) at 6 and (w0 + TW, w0 + TW + 1) at TW + 8
    (zero where a pair leaves the volume), else as single values (zero
    outside); a row outside a zero-padded volume is zero, under edge
    padding the clamped row."""
    _, _, d, h, w = x.shape
    tw = plan.tw
    rows = torch.full((plan.th + 2, row_pitch16(tw, plan.r)), float("nan"))
    for yy in range(plan.th + 2):
        gh = h0 - 1 + yy
        if clamp:
            gh = min(max(gh, 0), h - 1)
        src = (x[b, c, p, gh].float() if 0 <= gh < h
               else torch.zeros(w))
        if w % 8 == 0:
            cols = [(8 + j, w0 + j) for j in range(tw)]
            for at, gw in ((6, w0 - 2), (tw + 8, w0 + tw)):
                pair_in = 0 <= gw < w
                cols += [(at, gw if pair_in else -1),
                         (at + 1, gw + 1 if pair_in else -1)]
        else:
            cols = [(xx + 7, w0 - 1 + xx) for xx in range(tw + 2)]
        for at, gw in cols:
            rows[yy, at] = src[gw] if 0 <= gw < w else 0.0
    return rows


def bf16_read_columns(plan, w0, w, *, clamp):
    """(TW, 3): the index in a staged bf16 row that lane ``lane_w`` reads
    for tap column kw (under edge padding the clamped column's), and
    (TW, 3) whether that column lies inside the volume."""
    gw = w0 + torch.arange(plan.tw)[:, None] - 1 + torch.arange(3)[None, :]
    inside = (gw >= 0) & (gw < w)
    if clamp:
        gw = gw.clamp(0, w - 1)
    return gw - w0 + 8, inside | clamp


def conv3_planes_bf16_staged_ref(x, kernel, bias=None, residual=None,
                                 pre_scale=None, pre_shift=None, *,
                                 act="none", pad_mode="zero", pre_relu=None,
                                 plan=None):
    """K1-bf16's staging in plain PyTorch, for the CPU tests: each block's
    planes as :func:`bf16_staged_rows` leaves them, each thread's values
    read through :func:`bf16_read_columns`, widened, the pre-affine applied
    and a padded position of a zero-padded volume masked to 0, the taps in
    f32, then bias, residual, act and one rounding to bf16.  A read of a
    position the kernel never writes turns the output NaN."""
    b, cin, d, h, w = x.shape
    cout = kernel.shape[4]
    plan = plan or tile_plan(b, cin, cout, d, h, w)
    clamp = pad_mode == "edge"
    th, tw = plan.th, plan.tw
    k = kernel.float()
    out = torch.zeros((b, cout, d, h, w))
    for bi in range(b):
        for h0 in range(0, h, th):
            rin = torch.arange(h0 - 1, h0 + th + 1)
            rin = (rin >= 0) & (rin < h) | clamp
            for w0 in range(0, w, tw):
                cols, cin_ = bf16_read_columns(plan, w0, w, clamp=clamp)
                mask = (rin[:, None, None] & cin_[None]).float()
                # every plane's values as the threads read them:
                # (D, C_in, TH + 2, TW, 3), zero planes outside the volume
                vals = torch.zeros((d + 2, cin, th + 2, tw, 3))
                for p in range(-1, d + 1):
                    if not 0 <= p < d and not clamp:
                        continue
                    gp = min(max(p, 0), d - 1)
                    for c in range(cin):
                        v = bf16_staged_rows(x, plan, bi, c, gp, h0,
                                             clamp=clamp, w0=w0)[:, cols]
                        if pre_relu is not None:
                            v = v * pre_scale[c] + pre_shift[c]
                            if pre_relu:
                                v = torch.relu(v)
                            v = v * mask
                        vals[p + 1, c] = v
                tile = torch.zeros((cout, d, th, tw))
                for kd in range(3):
                    for kh in range(3):
                        tile += torch.einsum(
                            "dcyxk,kco->odyx", vals[kd:kd + d, :, kh:kh + th],
                            k[kd, kh])
                hh, ww = min(th, h - h0), min(tw, w - w0)
                out[bi, :, :, h0:h0 + hh, w0:w0 + ww] = tile[..., :hh, :ww]
    if bias is not None:
        out = out + bias[None, :, None, None, None]
    if residual is not None:
        out = out + residual.float()
    return _activation(out, act).to(torch.bfloat16)


def conv3_planes(x, kernel, bias=None, residual=None, pre_scale=None,
                 pre_shift=None, *, act="none", pad_mode="zero",
                 pre_relu=None):
    """SAME 3^3 stride-1 conv on (B, C_in, D, H, W).

    out = act(conv(pre(x), kernel) + bias [+ residual]), where
    pre(x) = [relu](x * pre_scale + pre_shift) per input channel when
    ``pre_relu`` is not None (``pre_relu`` chooses the ReLU).  kernel
    (3, 3, 3, C_in, C_out) DHWIO; bias (C_out,); residual
    (B, C_out, D, H, W).  ``pad_mode`` 'zero' or 'edge' (replicate);
    ``act`` 'none', 'relu' or 'leaky' (slope 0.2, after the residual).
    All float32 and contiguous; f32 accumulation.
    """
    return _conv3_planes(conv3_planes, x, kernel, bias, residual, pre_scale,
                         pre_shift, act, pad_mode, pre_relu, torch.float32)


conv3_planes.launches = 0


def conv3_planes_bf16(x, kernel, bias=None, residual=None, pre_scale=None,
                      pre_shift=None, *, act="none", pad_mode="zero",
                      pre_relu=None):
    """K1 on bfloat16 volumes, the JAX kernel's contract for a bf16 ``x``
    (``conv3_planes`` widens x and the residual, keeps the weights, bias
    and sums in float32 and returns x's type): x and residual bfloat16,
    kernel, bias and pre-affine float32, the result bfloat16, rounded once
    after the activation.  Otherwise as :func:`conv3_planes`; the tile
    walk of ``csrc/conv3p.cu`` in instances of its own, its planes staged
    raw by ``cp.async`` and widened where a thread reads them
    (:func:`conv3_planes_bf16_staged_ref`), counted apart."""
    return _conv3_planes(conv3_planes_bf16, x, kernel, bias, residual,
                         pre_scale, pre_shift, act, pad_mode, pre_relu,
                         torch.bfloat16)


conv3_planes_bf16.launches = 0


def _conv3_planes(wrapper, x, kernel, bias, residual, pre_scale, pre_shift,
                  act, pad_mode, pre_relu, dtype):
    """Checks, then the plain version for a CPU tensor or one launch of K1
    (counted on ``wrapper``) for a CUDA one; ``dtype`` is x's and the
    residual's."""
    name = wrapper.__name__
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if pad_mode not in _PADS:
        raise ValueError(f"pad_mode must be 'zero' or 'edge', got {pad_mode!r}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, C, D, H, W), got {tuple(x.shape)}")
    b, cin, d, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, 3, {cin}, C_out), "
                         f"got {tuple(kernel.shape)}")
    cout = kernel.shape[4]
    _build.no_grad_inputs(name, x, kernel, bias, residual,
                          pre_scale, pre_shift, use="conv3_planes_diff")
    dev = x.device
    _build.check(x, "x", device=dev, dtype=dtype)
    _build.check(kernel, "kernel", device=dev)
    if bias is not None:
        _build.check(bias, "bias", shape=(cout,), device=dev)
    if residual is not None:
        _build.check(residual, "residual", shape=(b, cout, d, h, w),
                     device=dev, dtype=dtype)
    if pre_relu is not None:
        if pre_scale is None or pre_shift is None:
            raise ValueError("pre_relu given without pre_scale/pre_shift")
        _build.check(pre_scale, "pre_scale", shape=(cin,), device=dev)
        _build.check(pre_shift, "pre_shift", shape=(cin,), device=dev)
    if dev.type == "cpu":
        return conv3_planes_ref(
            x, kernel, bias, residual, pre_scale, pre_shift, act=act,
            pad_mode=pad_mode, pre_relu=pre_relu)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")

    out = x.new_empty((b, cout, d, h, w))
    pre_mode = 0 if pre_relu is None else (2 if pre_relu else 1)
    use_pre = pre_relu is not None
    _build.launch(
        "hp_conv3p_fwd", x.data_ptr(), kernel.data_ptr(), _build.ptr(bias),
        _build.ptr(residual), _build.ptr(pre_scale if use_pre else None),
        _build.ptr(pre_shift if use_pre else None), out.data_ptr(),
        _build.int_args(b, cin, cout, d, h, w, _PADS[pad_mode], _ACTS[act],
                        pre_mode, *tile_plan(b, cin, cout, d, h, w),
                        int(dtype == torch.bfloat16)),
        device=dev)
    wrapper.launches += 1
    return out


def _pad_name(pad_mode):
    if pad_mode not in _PADS:
        raise ValueError(f"pad_mode must be 'zero' or 'edge', got {pad_mode!r}")
    return "replicate" if pad_mode == "edge" else "constant"


def conv3_planes_adjoint_ref(dz, kernel, *, pad_mode="zero"):
    """Plain version: the VJP of "pad, then VALID conv" by autograd."""
    b, _, d, h, w = dz.shape
    mode = _pad_name(pad_mode)
    wt = kernel.detach().float().permute(4, 3, 0, 1, 2)
    with torch.enable_grad():
        x = torch.zeros((b, kernel.shape[3], d, h, w), device=dz.device,
                        requires_grad=True)
        out = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1), mode=mode), wt)
        (dx,) = torch.autograd.grad(out, x, dz.detach().float())
    return dx


def conv3_planes_adjoint(dz, kernel, *, pad_mode="zero"):
    """dL/dx of :func:`conv3_planes` given dz = dL/d(pre-activation).

    dz (B, C_out, D, H, W), kernel (3, 3, 3, C_in, C_out): the FORWARD
    kernel.  Returns (B, C_in, D, H, W) float32: dx[i] = sum of
    k[t] . dz[o] over every (o, t) whose padded read lands on i (with edge
    padding the boundary voxels also collect the clamped halo reads)."""
    _pad_name(pad_mode)
    if dz.dim() != 5:
        raise ValueError(f"dz must be (B, C, D, H, W), got {tuple(dz.shape)}")
    b, cout, d, h, w = dz.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) \
            or kernel.shape[4] != cout:
        raise ValueError(f"kernel must be (3, 3, 3, C_in, {cout}), "
                         f"got {tuple(kernel.shape)}")
    cin = kernel.shape[3]
    _build.no_grad_inputs("conv3_planes_adjoint", dz, kernel,
                          use="conv3_planes_diff")
    dev = dz.device
    _build.check(dz, "dz", device=dev)
    _build.check(kernel, "kernel", device=dev)
    if dev.type == "cpu":
        return conv3_planes_adjoint_ref(dz, kernel, pad_mode=pad_mode)
    if dev.type != "cuda":
        raise ValueError(f"conv3_planes_adjoint: unsupported device {dev}")

    dx = dz.new_empty((b, cin, d, h, w))
    _build.launch(
        "hp_conv3p_adjoint", dz.data_ptr(), kernel.data_ptr(), dx.data_ptr(),
        _build.int_args(b, cin, cout, d, h, w, _PADS[pad_mode],
                        *tile_plan(b, cout, cin, d, h, w)),
        device=dev)
    conv3_planes_adjoint.launches += 1
    return dx


conv3_planes_adjoint.launches = 0


def conv3_planes_wgrad_ref(x, dz, *, pad_mode="zero", has_bias=True):
    """Plain version: ``conv3d_weight`` of the padded input, and the sum
    of dz over (B, D, H, W)."""
    mode = _pad_name(pad_mode)
    xp = F.pad(x.detach().float(), (1, 1, 1, 1, 1, 1), mode=mode)
    dz = dz.detach().float()
    dk = torch.nn.grad.conv3d_weight(
        xp, (dz.shape[1], x.shape[1], 3, 3, 3), dz)
    db = dz.sum(dim=(0, 2, 3, 4)) if has_bias else None
    return dk.permute(2, 3, 4, 1, 0).contiguous(), db


# K6's voxel tile is 4 (D) x 8 (H) x tw (W)
WGRAD_TILE_DH = (4, 8)
# about how many blocks K6's first pass is cut into: four a multiprocessor
# of the H100 (of 528, 792, 1024, 1584 and 2112 the fastest over the t128
# train step's 24 calls)
WGRAD_BLOCKS = 528


def wgrad_plan(b, cin, cout, d, h, w):
    """How K6's first pass is cut (``csrc/conv3p_wgrad.cu``): ``tw`` the
    tile's width (32, 16 or 8: the widest that W fills), ``cot`` output
    channels a block (4, or 1 for a single output channel), ``cib`` input
    channels a block (4, 2 or 1: a warp each, the largest that C_in
    fills), ``tiles`` (B, D, H, W tile counts) and ``chunks``, the number
    of block columns, each summing a contiguous run of tiles into one
    partial row per output: about ``WGRAD_BLOCKS`` blocks in all, so that the wide
    convs at small volumes split over channel groups and the narrow ones
    at large volumes over voxels."""
    tw = 32 if w > 16 else (16 if w > 8 else 8)
    cot = 1 if cout == 1 else 4
    cib = 4 if cin >= 4 else (2 if cin >= 2 else 1)
    td, th = WGRAD_TILE_DH
    tiles = (b, -(-d // td), -(-h // th), -(-w // tw))
    ntiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    groups = -(-cin // cib) * -(-cout // cot)
    chunks = max(1, min(ntiles, WGRAD_BLOCKS // groups))
    return dict(tw=tw, cot=cot, cib=cib, tiles=tiles, chunks=chunks)


def wgrad_chunk_masks(plan, shape):
    """For each block column of :func:`wgrad_plan`, the (B, 1, D, H, W)
    0/1 mask of the voxels whose tiles it sums: the kernel's tile order
    (W fastest, then H, D, B) and its contiguous runs
    ``[tiles * c // chunks, tiles * (c + 1) // chunks)``."""
    b, d, h, w = shape
    td, th = WGRAD_TILE_DH
    tw, chunks = plan["tw"], plan["chunks"]
    _, nd, nh, nw = plan["tiles"]
    ntiles = b * nd * nh * nw
    masks = []
    for c in range(chunks):
        m = torch.zeros((b, 1, d, h, w))
        for tile in range(ntiles * c // chunks, ntiles * (c + 1) // chunks):
            wt, r = tile % nw, tile // nw
            ht, r = r % nh, r // nh
            dt, bi = r % nd, r // nd
            m[bi, 0, dt * td:(dt + 1) * td, ht * th:(ht + 1) * th,
              wt * tw:(wt + 1) * tw] = 1.0
        masks.append(m)
    return masks


def conv3_planes_wgrad_fold_ref(x, dz, *, pad_mode="zero", has_bias=True):
    """K6's two passes in plain PyTorch, for the CPU tests: one partial
    (dk, db) per block column over that column's voxels, then their sum in
    column order."""
    b, cin, d, h, w = x.shape
    plan = wgrad_plan(b, cin, dz.shape[1], d, h, w)
    dk = db = None
    for m in wgrad_chunk_masks(plan, (b, d, h, w)):
        pk, pb = conv3_planes_wgrad_ref(x, dz * m.to(dz), pad_mode=pad_mode,
                                        has_bias=has_bias)
        dk = pk if dk is None else dk + pk
        if has_bias:
            db = pb if db is None else db + pb
    return dk, db


def conv3_planes_wgrad(x, dz, *, pad_mode="zero", has_bias=True):
    """dL/dkernel (3, 3, 3, C_in, C_out) and dL/dbias (C_out,) (or None)
    of :func:`conv3_planes`, from x (B, C_in, D, H, W) and
    dz (B, C_out, D, H, W) = dL/d(pre-activation).  Summed in a fixed
    order on the GPU, so a result repeats exactly from run to run."""
    _pad_name(pad_mode)
    if x.dim() != 5 or dz.dim() != 5 or x.shape[0] != dz.shape[0] \
            or x.shape[2:] != dz.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and dz {tuple(dz.shape)} must "
                         "be (B, C, D, H, W) with equal B, D, H, W")
    b, cin, d, h, w = x.shape
    cout = dz.shape[1]
    _build.no_grad_inputs("conv3_planes_wgrad", x, dz,
                          use="conv3_planes_diff")
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(dz, "dz", device=dev)
    if dev.type == "cpu":
        return conv3_planes_wgrad_ref(x, dz, pad_mode=pad_mode,
                                      has_bias=has_bias)
    if dev.type != "cuda":
        raise ValueError(f"conv3_planes_wgrad: unsupported device {dev}")

    plan = wgrad_plan(b, cin, cout, d, h, w)
    rows = 27 * cin * cout + cout
    partial = torch.empty((plan["chunks"], rows), device=dev,
                          dtype=torch.float32)
    dk = torch.empty((3, 3, 3, cin, cout), device=dev, dtype=torch.float32)
    db = (torch.empty((cout,), device=dev, dtype=torch.float32)
          if has_bias else None)
    _build.launch("hp_conv3p_wgrad", x.data_ptr(), dz.data_ptr(),
                  partial.data_ptr(), dk.data_ptr(), _build.ptr(db), b, cin,
                  cout, d, h, w, _PADS[pad_mode], plan["chunks"], plan["tw"],
                  plan["cib"], plan["cot"])
    conv3_planes_wgrad.launches += 1
    return dk, db


conv3_planes_wgrad.launches = 0


class Conv3Planes(torch.autograd.Function):
    """Differentiable K1: the port of ``_conv3p_diff``
    (``hiddenpose_tpu/ops/pallas/conv3p.py:1242-1317``).

    Forward K1 (K1-bf16 for a bfloat16 x and residual), saving the output
    when ``act != 'none'``.  Backward, in f32 as the JAX one (``g`` widened,
    ``:1263``): dz = g masked by ``out > 0`` (relu) or ``out >= 0 -> 1,
    else 0.2`` (leaky), ``out`` the saved output in x's type; dx by K5
    (only when x needs a gradient), dk and db by K6 on x widened; dx and
    dres = dz in x's and the residual's type, dk and db in f32 (the
    kernel's and bias's).  So a bf16 step runs the f32 K5 and K6 behind
    the JAX wrapper's casts."""

    @staticmethod
    def forward(ctx, x, kernel, bias, residual, act, pad_mode):
        fwd = conv3_planes_bf16 if x.dtype == torch.bfloat16 else conv3_planes
        out = fwd(x, kernel, bias, residual, act=act, pad_mode=pad_mode)
        ctx.act, ctx.pad_mode = act, pad_mode
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(x, kernel, out if act != "none" else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, out = ctx.saved_tensors
        need_x, need_k, need_b, need_res = ctx.needs_input_grad[:4]
        g = g.float().contiguous()
        if ctx.act == "relu":
            dz = torch.where(out > 0, g, 0.0)
        elif ctx.act == "leaky":
            dz = g * torch.where(out >= 0, 1.0, 0.2)
        else:
            dz = g
        dx = (conv3_planes_adjoint(dz, kernel, pad_mode=ctx.pad_mode)
              .to(x.dtype) if need_x else None)
        dk = db = None
        if need_k or need_b:
            dk, db = conv3_planes_wgrad(x.float(), dz, pad_mode=ctx.pad_mode,
                                        has_bias=need_b)
        dres = dz.to(ctx.res_dtype) if need_res else None
        return dx, dk if need_k else None, db, dres, None, None


def conv3_planes_diff(x, kernel, bias=None, residual=None, *, act="none",
                      pad_mode="zero"):
    """Differentiable :func:`conv3_planes` (no pre-affine, as the JAX
    package's ``conv3_planes_diff``); :func:`conv3_planes_bf16` for a
    bfloat16 x."""
    return Conv3Planes.apply(x, kernel, bias, residual, act, pad_mode)
