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


def window_indices(n, d, h, w):
    """The kernel's index math (``csrc/pool2p.cu``), in plain PyTorch: one
    thread per 2^3 window, in the order of dy's elements (its plane pair
    (n, od) from the block's position, (oh, ow) from one division of its
    index).  Returns the flat indices of each thread's 8 window voxels in
    scan order (d, h, w), (threads, 8), and of the voxels that no window
    covers at an odd extent, each zeroed by the window that ends beside it,
    (extra,); int32 arithmetic throughout."""
    od, oh, ow = d // 2, h // 2, w // 2
    i32 = dict(dtype=torch.int32)
    nn = torch.arange(n, **i32).view(n, 1, 1)
    dd = torch.arange(od, **i32).view(1, od, 1)
    i = torch.arange(oh * ow, **i32).view(1, 1, oh * ow)
    hh = torch.div(i, ow, rounding_mode="floor")
    ww = i - hh * ow
    base = (((nn * d + 2 * dd) * h + 2 * hh) * w + 2 * ww).reshape(-1)
    hw = h * w
    window = base[:, None] + torch.tensor(
        [0, 1, w, w + 1, hw, hw + 1, hw + w, hw + w + 1], **i32)
    # the thread's extent along each axis: 3 at the last window of an odd one
    ext = [torch.where(c == last, size - 2 * c, 2).expand(n, od, oh * ow)
           .reshape(-1) for c, last, size in ((dd, od - 1, d),
                                               (hh, oh - 1, h),
                                               (ww, ow - 1, w))]
    extra = torch.cat([
        (base + a * hw + b * w + c)[(ext[0] > a) & (ext[1] > b) & (ext[2] > c)]
        for a in range(3) for b in range(3) for c in range(3)
        if 2 in (a, b, c)])
    return window, extra


def max_pool2_bwd_windows_ref(x, dy):
    """K8 thread by thread in plain PyTorch: each window's 8 values read by
    :func:`window_indices`, the first maximum found by the kernel's scan,
    dy written to it and 0 to the others, the uncovered voxels zeroed.  A
    voxel no thread writes stays NaN."""
    n, d, h, w = x.shape[0] * x.shape[1], *x.shape[2:]
    window, extra = window_indices(n, d, h, w)
    v = x.detach().float().reshape(-1)[window.long()]
    m, arg = v[:, 0], torch.zeros(len(v), dtype=torch.long)
    for k in range(1, 8):
        take = (v[:, k] > m) | torch.isnan(v[:, k])
        m = torch.where(take, v[:, k], m)
        arg = torch.where(take, k, arg)
    g = dy.detach().float().reshape(-1)
    dx = torch.full((x.numel(),), float("nan"))
    dx[window.long()] = torch.where(
        torch.arange(8) == arg[:, None], g[:, None], 0.0)
    dx[extra.long()] = 0.0
    return dx.view(x.shape)


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
    if x.numel() >= 2 ** 31 or b * c >= 2 ** 16 or od >= 2 ** 16:
        raise ValueError(f"max_pool2_bwd: {tuple(x.shape)} is beyond the "
                         "kernel's 32-bit indices and grid")

    dx = torch.empty_like(x)
    _build.launch("hp_maxpool2_bwd", x.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), b * c, d, h, w, od, oh, ow, device=dev)
    max_pool2_bwd.launches += 1
    return dx


max_pool2_bwd.launches = 0


class MaxPool2(torch.autograd.Function):
    """Differentiable MaxPool3d(2): library forward, backward K8.  On
    bf16 the backward is the f32 K8 on x and g widened (a widening keeps
    every window's order), its result in x's type, as the JAX wrapper
    casts (``pool2p.py:140-141, 181``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool3d(x, 2)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool2_bwd(x.float(), g.float().contiguous()).to(x.dtype)


def max_pool2_diff(x):
    """Differentiable ``F.max_pool3d(x, 2)`` (float32 or bfloat16) whose
    backward is K8."""
    return MaxPool2.apply(x)
