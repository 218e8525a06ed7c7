"""3^3 stencil convolutions and the FeatureExtraction front end.

Port of ``hiddenpose_tpu/models/blocks.py`` (``StencilConv3``,
``ResConv3D``, ``FeatureExtraction``; the stride-1 path).  Volumes are
NCDHW, which is the JAX package's channels-planes layout, so every 3^3
conv goes straight to the K1 kernel (``ops/kernels/conv3p.py``) with no
transposes; with grad mode on, through its ``autograd.Function``
(backward K5 and K6).  The bfloat16 model (``dtype=torch.bfloat16``)
rounds where the JAX package's ``StencilConv3`` rounds, which depends on
its Pallas gate (:func:`k1_admits`).  Where the gate admits a conv, the
Pallas kernel takes the input in its own type, keeps weights, bias and
sums in float32 and rounds the result once to bf16 (K1's contract,
``conv3_planes_bf16`` for a bf16 volume).  Where it refuses, the JAX
package runs the library conv: input and weights rounded to bf16, the
conv's f32 sums rounded to bf16, then bias, residual and activation in
f32 and a second rounding; the port runs K1-bf16 on the rounded weights
there and the rest as plain ops.  In training the backward runs in f32
and rounds the cotangents of the bf16 values (input, residual, rounded
weights) to bf16, as the JAX one does.
Module and parameter names follow the reference PyTorch model, so
``hiddenpose_tpu.utils.torch_import.convert_state_dict`` reads this
model's ``state_dict`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.ops.kernels import (
    conv3_planes,
    conv3_planes_bf16,
    conv3_planes_diff,
    conv3_planes_ref,
)


def dhwio(weight: torch.Tensor) -> torch.Tensor:
    """A torch OIDHW conv weight as the contiguous DHWIO the kernels take."""
    return weight.permute(2, 3, 4, 1, 0).contiguous()


def conv3p_route(use_kernels: bool, dtype=torch.float32):
    """K1 for the serving forward (K1-bf16 for a bfloat16 model), its
    ``autograd.Function`` when grad mode is on (K1 or K1-bf16 forward, the
    f32 K5 and K6 backward), the plain version when kernels are off."""
    if not use_kernels:
        return conv3_planes_ref
    if torch.is_grad_enabled():
        return conv3_planes_diff
    return conv3_planes_bf16 if dtype == torch.bfloat16 else conv3_planes


def k1_admits(shape, cin: int, cout: int) -> bool:
    """The JAX ``StencilConv3``'s Pallas gate (``hiddenpose_tpu/models/
    blocks.py:196-209``, on its own hardware) for a (B, C_in, D, H, W)
    input: 32 <= W <= 128, H % 8 == 0 and C_in * C_out <= 64."""
    h, w = shape[-2], shape[-1]
    return 32 <= w <= 128 and h % 8 == 0 and cin * cout <= 64


class StencilConv3(nn.Conv3d):
    """A 3^3 stride-1 SAME conv with fused residual and activation, run by
    the K1 kernel (or its plain version when ``use_kernels`` is False).

    Holds an ordinary ``nn.Conv3d`` weight (OIDHW) and bias, so its
    ``state_dict`` is that of the reference's ``Conv3d``; the padding
    (``pad_mode`` 'zero' or 'edge') is applied inside the kernel.  With
    ``dtype=torch.bfloat16`` the result is bf16, rounded as the module's
    docstring says."""

    def __init__(self, in_channels: int, out_channels: int,
                 pad_mode: str = "zero", bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, 3, bias=bias)
        self.pad_mode = pad_mode
        self.compute_dtype = dtype
        self.use_kernels = True

    def forward(self, x, residual=None, act: str = "none"):
        dt = self.compute_dtype
        w = dhwio(self.weight)
        if dt == torch.float32 or k1_admits(x.shape, self.in_channels,
                                            self.out_channels):
            return conv3p_route(self.use_kernels, x.dtype)(
                x, w, self.bias, residual, act=act,
                pad_mode=self.pad_mode).to(dt)
        y = conv3p_route(self.use_kernels, dt)(
            x.to(dt), w.to(dt).float(), pad_mode=self.pad_mode).float()
        if self.bias is not None:
            y = y + self.bias[:, None, None, None]
        if residual is not None:
            y = y + residual.float()
        if act == "relu":
            y = F.relu(y)
        elif act == "leaky":
            y = F.leaky_relu(y, 0.2)
        return y.to(dt)


class ResConv3D(nn.Module):
    """leaky(x + conv(leaky(conv(x)))) with edge padding; reference tree
    ``tmp = [pad, conv, leaky, pad, conv]`` (convs at ``tmp.1``/``tmp.4``)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.tmp = nn.ModuleList([
            nn.ReplicationPad3d(1),
            StencilConv3(channels, channels, pad_mode="edge", dtype=dtype),
            nn.LeakyReLU(0.2),
            nn.ReplicationPad3d(1),
            StencilConv3(channels, channels, pad_mode="edge", dtype=dtype),
        ])

    def forward(self, x):
        h = self.tmp[1](x, act="leaky")
        return self.tmp[4](h, residual=x, act="leaky")


def corner_mask(in_channels: int = 1) -> torch.Tensor:
    """The fixed-branch kernel, OIDHW (1, C_in, 3, 3, 3): ones in the far
    corner octant normalised to unit sum (the init that matters for parity
    with the reference)."""
    w = torch.zeros((1, in_channels, 3, 3, 3))
    w[:, :, 1:, 1:, 1:] = 1.0
    return w / w.sum()


class FeatureExtraction(nn.Module):
    """Dual-branch front end (stride 1): a learned branch
    (edge-pad conv + 2 x ResConv3D) plus the corner-mask conv with zero
    padding.  With ``basedim == 1`` the learned branch rides the corner
    conv's fused residual input.  x (B, C_in, D, H, W) -> (B, basedim, ...).
    """

    def __init__(self, basedim: int = 1, in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.basedim = basedim
        self.conv1 = nn.ModuleList([
            nn.ReplicationPad3d(1),
            StencilConv3(in_channels, basedim, pad_mode="edge", dtype=dtype),
            ResConv3D(basedim, dtype),
            ResConv3D(basedim, dtype),
        ])
        self.weights = nn.Parameter(corner_mask(in_channels))
        self.compute_dtype = dtype
        self.use_kernels = True

    def forward(self, x):
        # as the JAX module: the learned branch's first conv on x in its
        # own type, the corner conv on x and its kernel rounded to the
        # model's type (bf16 values in f32, for K1)
        dt = self.compute_dtype
        h = self.conv1[1](x)
        h = self.conv1[3](self.conv1[2](h))
        fn = conv3p_route(self.use_kernels, dt)
        x, corner = x.to(dt), dhwio(self.weights).to(dt).float()
        if self.basedim == 1:
            return fn(x, corner, None, h, pad_mode="zero")
        return h + fn(x, corner, pad_mode="zero")
