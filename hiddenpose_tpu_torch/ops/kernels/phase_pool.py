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
    of (B, D, H, W, C); its autograd is the JAX package's VJP."""
    return _axis_max(_axis_max(_axis_max(y.float(), 3), 2), 1).contiguous()


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


def maxpool3d_k3s2p1_vjp_ref(y, g):
    """Plain version: autograd of :func:`maxpool3d_k3s2p1_ref`."""
    with torch.enable_grad():
        y = y.detach().float().requires_grad_()
        (dy,) = torch.autograd.grad(maxpool3d_k3s2p1_ref(y), y,
                                    g.detach().float())
    return dy


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

    dy = torch.empty_like(y)
    _build.launch("hp_maxpool3d_k3s2p1_vjp", y.data_ptr(), g.data_ptr(),
                  dy.data_ptr(), b, d, h, w, c, od, oh, ow)
    maxpool3d_k3s2p1_vjp.launches += 1
    return dy


maxpool3d_k3s2p1_vjp.launches = 0


class MaxPoolK3S2P1(torch.autograd.Function):
    """Differentiable stem pool: forward K3, backward K7."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return maxpool3d_k3s2p1(y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return maxpool3d_k3s2p1_vjp(y, g.contiguous())


def maxpool3d_k3s2p1_diff(y):
    """Differentiable :func:`maxpool3d_k3s2p1`."""
    return MaxPoolK3S2P1.apply(y)
