"""K8: the backward of the UNet's MaxPool3d(2) on (B, C, D, H, W).

Replaces ``hiddenpose_tpu/ops/pallas/pool2p.py::pool2_bwd_planes_pallas``
(body ``_pool2_bwd_kernel``), the custom VJP of the UNet pool
(``hiddenpose_tpu/models/unet3d.py:159-164``): the cotangent of each
non-overlapping 2^3 window goes to the FIRST maximum of the window in
(d, h, w) order, with the maximum recomputed from x; every other element
gets 0.  All-equal windows are common (wherever the UNet input is flat),
so the rule is part of the contract.  The plain version is the autograd
of ``F.max_pool3d(x, 2)``, whose forward records that same first maximum
on the CPU and on CUDA.  The CUDA source is ``csrc/pool2p.cu``; its
header says what bounds it (device memory bandwidth) and how it answers.

:class:`MaxPool2` is the differentiable pool: its forward is
``F.max_pool3d(x, 2)``, as the UNet's inference path runs it, and its
backward is K8.  On a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel or raises.  The wrapper also raises when
an input requires grad and grad mode is on: under autograd only
:func:`max_pool2_diff` may call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build


def max_pool2_bwd_ref(x, dy):
    """Plain version: autograd of ``F.max_pool3d(x, 2)``."""
    with torch.enable_grad():
        x = x.detach().float().requires_grad_()
        (dx,) = torch.autograd.grad(F.max_pool3d(x, 2), x, dy.detach().float())
    return dx


def max_pool2_bwd(x, dy):
    """dL/dx of ``F.max_pool3d(x, 2)``: x (B, C, D, H, W),
    dy (B, C, D//2, H//2, W//2) -> (B, C, D, H, W) float32."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, C, D, H, W), got {tuple(x.shape)}")
    b, c, d, h, w = x.shape
    od, oh, ow = d // 2, h // 2, w // 2
    _build.no_grad_inputs("max_pool2_bwd", x, dy, use="max_pool2_diff")
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(dy, "dy", shape=(b, c, od, oh, ow), device=dev)
    if dev.type == "cpu":
        return max_pool2_bwd_ref(x, dy)
    if dev.type != "cuda":
        raise ValueError(f"max_pool2_bwd: unsupported device {dev}")

    dx = torch.empty_like(x)
    _build.launch("hp_maxpool2_bwd", x.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), b * c, d, h, w, od, oh, ow)
    max_pool2_bwd.launches += 1
    return dx


max_pool2_bwd.launches = 0


class MaxPool2(torch.autograd.Function):
    """Differentiable MaxPool3d(2): library forward, backward K8."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool3d(x, 2)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool2_bwd(x, g.contiguous())


def max_pool2_diff(x):
    """Differentiable ``F.max_pool3d(x, 2)`` whose backward is K8."""
    return MaxPool2.apply(x)
