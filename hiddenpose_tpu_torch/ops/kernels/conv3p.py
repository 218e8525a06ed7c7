"""K1: SAME 3x3x3 stride-1 stencil convolution on channels-planes volumes.

Replaces ``hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes`` (the Pallas
bodies ``_conv3p_kernel`` / ``_conv3p_kernel_db``), with the same argument
order, the same (B, C, D, H, W) planes layout (which is PyTorch's NCDHW)
and a DHWIO kernel.  The CUDA source is ``csrc/conv3p.cu``; its header says
what bounds it on the card (memory traffic, at these 1-64 channels) and how
the shared-memory halo tile answers that.

The TPU kernel's eligibility limits (``cin * cout <= 64``, ``W <= 128``,
``H % 8 == 0``) were limits of its compiler, not of the contract: this
kernel takes any shape, so every FeatureExtraction and UNet 3^3 conv uses
it.

On a CPU tensor the wrapper runs :func:`conv3_planes_ref`, the plain
PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build

_ACTS = {"none": 0, "relu": 1, "leaky": 2}
_PADS = {"zero": 0, "edge": 1}


def _activation(out, act):
    if act == "relu":
        return torch.clamp_min(out, 0.0)
    if act == "leaky":
        return torch.where(out >= 0.0, out, 0.2 * out)
    return out


def conv3_planes_ref(x, kernel, bias=None, residual=None, pre_scale=None,
                     pre_shift=None, *, act="none", pad_mode="zero",
                     pre_relu=None):
    """Plain version: pre-affine, pad, ``F.conv3d``, bias, residual, act."""
    x = x.float()
    if pre_relu is not None:
        x = x * pre_scale[None, :, None, None, None] \
            + pre_shift[None, :, None, None, None]
        if pre_relu:
            x = torch.clamp_min(x, 0.0)
    mode = "replicate" if pad_mode == "edge" else "constant"
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode=mode)
    w = kernel.float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    out = F.conv3d(xp, w, bias)
    if residual is not None:
        out = out + residual
    return _activation(out, act)


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
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(kernel, "kernel", device=dev)
    if bias is not None:
        _build.check(bias, "bias", shape=(cout,), device=dev)
    if residual is not None:
        _build.check(residual, "residual", shape=(b, cout, d, h, w),
                     device=dev)
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
        raise ValueError(f"conv3_planes: unsupported device {dev}")

    out = torch.empty((b, cout, d, h, w), device=dev, dtype=torch.float32)
    pre_mode = 0 if pre_relu is None else (2 if pre_relu else 1)
    use_pre = pre_relu is not None
    _build.launch(
        "hp_conv3p_fwd", x.data_ptr(), kernel.data_ptr(), _build.ptr(bias),
        _build.ptr(residual), _build.ptr(pre_scale if use_pre else None),
        _build.ptr(pre_shift if use_pre else None), out.data_ptr(),
        b, cin, cout, d, h, w, _PADS[pad_mode], _ACTS[act], pre_mode)
    conv3_planes.launches += 1
    return out


conv3_planes.launches = 0
