"""K3: MaxPool3d(3, stride 2, padding 1) on the stem output, NDHWC.

Replaces ``hiddenpose_tpu/ops/pallas/phase_pool.py::phase_maxpool_pallas``
(body ``_phase_pool_fwd_kernel``).  The TPU kernel pools the stem output
in its space-to-depth phase layout (B, D/2, H/2, W/2, 8C); the port's stem
writes full resolution, so this pool takes (B, D, H, W, C) and returns
(B, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1, C).  Padded positions never win,
as with the TPU kernel's float32-min padding.  The CUDA source is
``csrc/phase_pool.cu``; its header says what bounds it (device memory
bandwidth) and how its access pattern answers that.

The gradient (:class:`MaxPoolK3S2P1`) is the port of the TPU pair
``phase_maxpool_diff`` / ``phase_maxpool_vjp_pallas``: K7
(:func:`maxpool3d_k3s2p1_vjp`, ``csrc/phase_pool_vjp.cu``).  Its contract
is the autodiff of the separable ``maximum`` chain of
``hiddenpose_tpu/ops/space_to_depth.py::phase_maxpool_k3s2``: per axis
(W, then H, then D) ``max(max(x[2m], x[2m+1]), x[2m-1])``, where every
``maximum`` splits a tie 0.5/0.5.  The stem output is post-ReLU and mostly
zeros, so ties are the common case.  The plain version
:func:`maxpool3d_k3s2p1_ref` is that chain in ``torch.maximum``, which
splits ties the same way; its values equal ``F.max_pool3d``'s, but not
its gradient (``max_pool3d`` sends a tie's whole gradient to one input).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  A wrapper also raises when an input
requires grad and grad mode is on: under autograd only
:func:`maxpool3d_k3s2p1_diff` may call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build


def pooled_extent(n: int) -> int:
    return (n - 1) // 2 + 1


def _axis_max(t, axis):
    """One stage of the chain along ``axis``: out[m] =
    max(max(t[2m], t[2m+1]), t[2m-1]), with -inf outside the volume."""
    n = t.shape[axis]
    if n % 2:
        pad = [0] * (2 * (t.dim() - axis))
        pad[-1] = 1  # one -inf slab after the end of `axis`
        t = F.pad(t, pad, value=float("-inf"))
    pairs = t.unflatten(axis, (-1, 2))
    a0, a1 = pairs.select(axis + 1, 0), pairs.select(axis + 1, 1)
    edge = torch.full_like(a1.narrow(axis, 0, 1), float("-inf"))
    a1m = torch.cat([edge, a1.narrow(axis, 0, a1.shape[axis] - 1)], axis)
    return torch.maximum(torch.maximum(a0, a1), a1m)


def maxpool3d_k3s2p1_ref(y):
    """Plain version: the separable ``torch.maximum`` chain over W, H, D
    of (B, D, H, W, C), in float32 and returned in ``y``'s type (a maximum
    is exact in either); its autograd is the JAX package's VJP."""
    out = _axis_max(_axis_max(_axis_max(y.float(), 3), 2), 1)
    return out.to(y.dtype).contiguous()


def maxpool3d_k3s2p1(y):
    """y (B, D, H, W, C) float32 contiguous, C % 4 == 0 -> pooled NDHWC."""
    if y.dim() != 5:
        raise ValueError(f"y must be (B, D, H, W, C), got {tuple(y.shape)}")
    b, d, h, w, c = y.shape
    if c % 4:
        raise ValueError(f"channels must be a multiple of 4, got {c}")
    _build.no_grad_inputs("maxpool3d_k3s2p1", y,
                          use="maxpool3d_k3s2p1_diff")
    dev = y.device
    _build.check(y, "y", device=dev, aligned=True)
    if dev.type == "cpu":
        return maxpool3d_k3s2p1_ref(y)
    if dev.type != "cuda":
        raise ValueError(f"maxpool3d_k3s2p1: unsupported device {dev}")

    od, oh, ow = pooled_extent(d), pooled_extent(h), pooled_extent(w)
    out = torch.empty((b, od, oh, ow, c), device=dev, dtype=torch.float32)
    _build.launch("hp_maxpool3d_k3s2p1", y.data_ptr(), out.data_ptr(),
                  b, d, h, w, c, od, oh, ow)
    maxpool3d_k3s2p1.launches += 1
    return out


maxpool3d_k3s2p1.launches = 0


def maxpool3d_k3s2p1_bf16(y):
    """K3 on a bfloat16 volume (the serving stem's output in the bf16
    model): y (B, D, H, W, C) bfloat16 contiguous, C % 8 == 0 -> pooled
    NDHWC bfloat16, exact (a maximum rounds nothing).  Its own kernel of
    ``csrc/phase_pool.cu`` reads 8 channels a 16-byte load."""
    if y.dim() != 5:
        raise ValueError(f"y must be (B, D, H, W, C), got {tuple(y.shape)}")
    b, d, h, w, c = y.shape
    if c % 8:
        raise ValueError(f"channels must be a multiple of 8, got {c}")
    _build.no_grad_inputs("maxpool3d_k3s2p1_bf16", y,
                          use="maxpool3d_k3s2p1_diff (float32)")
    dev = y.device
    _build.check(y, "y", device=dev, aligned=True, dtype=torch.bfloat16)
    if dev.type == "cpu":
        return maxpool3d_k3s2p1_ref(y)
    if dev.type != "cuda":
        raise ValueError(f"maxpool3d_k3s2p1_bf16: unsupported device {dev}")

    od, oh, ow = pooled_extent(d), pooled_extent(h), pooled_extent(w)
    out = torch.empty((b, od, oh, ow, c), device=dev, dtype=torch.bfloat16)
    _build.launch("hp_maxpool3d_k3s2p1_bf16", y.data_ptr(), out.data_ptr(),
                  b, d, h, w, c, od, oh, ow)
    maxpool3d_k3s2p1_bf16.launches += 1
    return out


maxpool3d_k3s2p1_bf16.launches = 0


def maxpool3d_k3s2p1_vjp_ref(y, g):
    """Plain version: autograd of :func:`maxpool3d_k3s2p1_ref`."""
    with torch.enable_grad():
        y = y.detach().float().requires_grad_()
        (dy,) = torch.autograd.grad(maxpool3d_k3s2p1_ref(y), y,
                                    g.detach().float())
    return dy


def _tie(p, q):
    """Gradient weight of a ``maximum``'s operand p against q."""
    return torch.where(p > q, 1.0, torch.where(p < q, 0.0, 0.5))


def _windows(t, axis):
    """The operands (c, a0, a1) = (t[2j], t[2j + 1], t[2j + 2]) of the
    n + 1 windows of a halo tile's 2n + 3 entries along ``axis`` (entry 0
    is the predecessor of the tile's even origin)."""
    n = (t.shape[axis] - 3) // 2
    return (t.index_select(axis, torch.arange(k, 2 * n + k + 1, 2,
                                              device=t.device))
            for k in range(3))


def _axis_max_halo(t, axis):
    """A stage's maxima of a halo tile, one per window."""
    c, a0, a1 = _windows(t, axis)
    return torch.maximum(torch.maximum(a0, a1), c)


def _axis_grad(op, gr, axis):
    """K7's per-axis step on a tile: ``op`` the stage's operands along
    ``axis`` with their halo, ``gr`` the gradients of the tile's n + 1
    windows (zero for a window that does not exist).  Tile index 2j is the
    first operand (a0) of window j, 2j + 1 its second (a1) and the third
    (c) of window j + 1.  Returns the 2n gradients of the tile's indices."""
    n = gr.shape[axis] - 1
    c, a0, a1 = _windows(op, axis)
    t = torch.maximum(a0, a1)
    w_c = _tie(c, t) * gr
    w_a0 = _tie(t, c) * _tie(a0, a1) * gr
    w_a1 = _tie(t, c) * _tie(a1, a0) * gr
    even = w_a0.narrow(axis, 0, n)
    odd = w_a1.narrow(axis, 0, n) + w_c.narrow(axis, 1, n)
    return torch.stack([even, odd], axis + 1).flatten(axis, axis + 1)


def maxpool3d_k3s2p1_vjp_tiled_ref(y, g, th=16, tw=16):
    """K7's bookkeeping in plain PyTorch, for the CPU tests: tile by tile
    as ``csrc/phase_pool_vjp.cu`` cuts the volume (``th`` x ``tw`` input
    columns with a halo of one voxel before and two after, -inf outside,
    all of D at once), the stage maxima u and v once per tile, then dv, du
    and dx by :func:`_axis_grad`.  Bit-identical to
    :func:`maxpool3d_k3s2p1_vjp_ref`."""
    b, d, h, w, c = y.shape
    od, oh, ow = pooled_extent(d), pooled_extent(h), pooled_extent(w)
    inf = float("inf")
    nh, nw = -(-h // th), -(-w // tw)
    # planes -1 .. 2 od + 1, rows -1 .. nh th + 1, columns alike
    yp = F.pad(y.float(), (0, 0, 1, nw * tw + 2 - w, 1, nh * th + 2 - h,
                           1, 2 * od + 2 - d), value=-inf)
    gp = F.pad(g.float(), (0, 0, 0, nw * tw // 2 + 1 - ow,
                           0, nh * th // 2 + 1 - oh, 0, 1))
    dy = torch.empty_like(yp[:, 1:2 * od + 1, 1:nh * th + 1, 1:nw * tw + 1])
    for h0 in range(0, h, th):
        for w0 in range(0, w, tw):
            yt = yp[:, :, h0:h0 + th + 3, w0:w0 + tw + 3]
            u = _axis_max_halo(yt, 3)
            v = _axis_max_halo(u, 2)
            gt = gp[:, :, h0 // 2:h0 // 2 + th // 2 + 1,
                    w0 // 2:w0 // 2 + tw // 2 + 1]
            dv = _axis_grad(v, gt, 1)
            du = _axis_grad(u[:, 1:2 * od + 1], dv, 2)
            dy[:, :, h0:h0 + th, w0:w0 + tw] = _axis_grad(
                yt[:, 1:2 * od + 1, 1:th + 1], du, 3)
    return dy[:, :d, :h, :w].contiguous()


def maxpool3d_k3s2p1_vjp(y, g):
    """dL/dy of :func:`maxpool3d_k3s2p1` given g = dL/d(pooled):
    y (B, D, H, W, C), g (B, OD, OH, OW, C), C % 4 == 0 -> (B, D, H, W, C),
    with the chain's 0.5/0.5 split at every tie."""
    if y.dim() != 5:
        raise ValueError(f"y must be (B, D, H, W, C), got {tuple(y.shape)}")
    b, d, h, w, c = y.shape
    if c % 4:
        raise ValueError(f"channels must be a multiple of 4, got {c}")
    od, oh, ow = pooled_extent(d), pooled_extent(h), pooled_extent(w)
    _build.no_grad_inputs("maxpool3d_k3s2p1_vjp", y, g,
                          use="maxpool3d_k3s2p1_diff")
    dev = y.device
    _build.check(y, "y", device=dev, aligned=True)
    _build.check(g, "g", shape=(b, od, oh, ow, c), device=dev, aligned=True)
    if dev.type == "cpu":
        return maxpool3d_k3s2p1_vjp_ref(y, g)
    if dev.type != "cuda":
        raise ValueError(f"maxpool3d_k3s2p1_vjp: unsupported device {dev}")

    if h * w * c // 4 >= 2 ** 31:
        raise ValueError("maxpool3d_k3s2p1_vjp: a plane of y must hold fewer "
                         f"than 2^31 float4s, got {h} x {w} x {c // 4}")
    dy = torch.empty_like(y)
    _build.launch("hp_maxpool3d_k3s2p1_vjp", y.data_ptr(), g.data_ptr(),
                  dy.data_ptr(), b, d, h, w, c, od, oh, ow)
    maxpool3d_k3s2p1_vjp.launches += 1
    return dy


maxpool3d_k3s2p1_vjp.launches = 0


class MaxPoolK3S2P1(torch.autograd.Function):
    """Differentiable stem pool: forward K3 (K3-bf16 for a bfloat16 y),
    backward K7.  On bf16 the backward is the f32 K7 on y and g widened,
    its result rounded to bf16, as the JAX pair does (``phase_pool.py:376,
    412`` cast to f32 before the pallas_call, ``:433`` back to y2's type)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        if y.dtype == torch.bfloat16:
            return maxpool3d_k3s2p1_bf16(y)
        return maxpool3d_k3s2p1(y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return maxpool3d_k3s2p1_vjp(y.float(),
                                    g.float().contiguous()).to(y.dtype)


def maxpool3d_k3s2p1_diff(y):
    """Differentiable :func:`maxpool3d_k3s2p1` (float32 or bfloat16)."""
    return MaxPoolK3S2P1.apply(y)
