"""K2: the fused inference stem, Conv3d(1 -> 64, 7^3, pad 3) + eval BN + ReLU.

Replaces ``hiddenpose_tpu/ops/pallas/stem_conv.py::stem_conv_raw_pallas``
(body ``_stem_kernel``).  The TPU kernel takes the raw volume and a
space-to-depth 5^3 kernel and returns the result in space-to-depth form;
this one takes the raw (B, D, H, W, 1) volume and the raw 7^3 DHWIO kernel
and writes the full-resolution NDHWC (B, D, H, W, 64) output, which the
pool (K3) and the channels-last backbone read directly.  The CUDA source
is ``csrc/stem_conv.cu``; its header says what bounds it (fp32 FMA issue)
and how the tiling answers that.

On a CPU tensor the wrapper runs :func:`stem_conv_raw_ref`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build

COUT = 64


def stem_conv_raw_ref(x, kernel, scale, shift, relu=True):
    """Plain version: ``F.conv3d(pad=3)`` + affine + ReLU, NDHWC out."""
    xc = x.float().permute(0, 4, 1, 2, 3)
    w = kernel.float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(xc, w, padding=3)
    y = y * scale[None, :, None, None, None] + shift[None, :, None, None, None]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def stem_conv_raw(x, kernel, scale, shift, relu=True):
    """x (B, D, H, W, 1) raw volume; kernel (7, 7, 7, 1, 64) DHWIO;
    scale/shift (64,) folded eval-BN affine.  Returns
    relu(conv7^3(x) * scale + shift) as (B, D, H, W, 64), float32."""
    if x.dim() != 5 or x.shape[-1] != 1:
        raise ValueError(f"x must be (B, D, H, W, 1), got {tuple(x.shape)}")
    b, d, h, w, _ = x.shape
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(kernel, "kernel", shape=(7, 7, 7, 1, COUT), device=dev,
                 aligned=True)
    _build.check(scale, "scale", shape=(COUT,), device=dev)
    _build.check(shift, "shift", shape=(COUT,), device=dev)
    if dev.type == "cpu":
        return stem_conv_raw_ref(x, kernel, scale, shift, relu)
    if dev.type != "cuda":
        raise ValueError(f"stem_conv_raw: unsupported device {dev}")

    out = torch.empty((b, d, h, w, COUT), device=dev, dtype=torch.float32)
    _build.launch(
        "hp_stem_conv_fwd", x.data_ptr(), kernel.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b, d, h, w,
        int(bool(relu)))
    stem_conv_raw.launches += 1
    return out


stem_conv_raw.launches = 0
