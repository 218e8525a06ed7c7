"""K4: 3x3x3 stride-1 pad-1 conv, channels-last, fused BN affine + ReLU.

Replaces ``hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu`` (body
``_conv3mxu_kernel``): the Bottleneck conv2 of the stride-1 c64 @64^3,
c128 @32^3 and c256 @16^3 blocks, with the eval BatchNorm affine and the
ReLU as an epilogue.  Same argument order and NDHWC / DHWIO layouts as the
JAX function; the arithmetic is full f32 (the JAX path's
``compute_dtype='f32'``): fp32 FMA, no TF32.  The CUDA source is
``csrc/conv3mxu.cu``; its header says what bounds it (fp32 FMA issue and
operand reuse) and how the SIMT implicit-GEMM tiling answers that.

On a CPU tensor the wrapper runs :func:`conv3_mxu_ref`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build


def conv3mxu_supported(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes (its 16-deep k-slices lie inside one
    tap; its 64-wide output tiles never straddle C_out)."""
    return cin % 16 == 0 and cout % 64 == 0 and cin > 0 and cout > 0


def conv3_mxu_ref(x, k, scale=None, shift=None, relu=False):
    """Plain version: ``F.conv3d(pad=1)`` + affine + ReLU, NDHWC in/out."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 k.float().permute(4, 3, 0, 1, 2), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if scale is not None:
        y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()


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

    out = torch.empty((b, d, h, w, cout), device=dev, dtype=torch.float32)
    _build.launch(
        "hp_conv3_mxu_fwd", x.data_ptr(), k.data_ptr(), _build.ptr(scale),
        _build.ptr(shift), out.data_ptr(), b, d, h, w, cin, cout,
        int(bool(relu)))
    conv3_mxu.launches += 1
    return out


conv3_mxu.launches = 0
