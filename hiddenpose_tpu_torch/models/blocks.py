"""3^3 stencil convolutions and the FeatureExtraction front end.

Port of ``hiddenpose_tpu/models/blocks.py`` (``StencilConv3``,
``ResConv3D``, ``FeatureExtraction``; the stride-1 path).  Volumes are
NCDHW, which is the JAX package's channels-planes layout, so every 3^3
conv goes straight to the K1 kernel (``ops/kernels/conv3p.py``) with no
transposes; with grad mode on, through its ``autograd.Function``
(backward K5 and K6).  Module and parameter names follow the reference PyTorch
model, so ``hiddenpose_tpu.utils.torch_import.convert_state_dict`` reads
this model's ``state_dict`` directly.
"""

from __future__ import annotations

import torch
from torch import nn

from hiddenpose_tpu_torch.ops.kernels import (
    conv3_planes,
    conv3_planes_diff,
    conv3_planes_ref,
)


def dhwio(weight: torch.Tensor) -> torch.Tensor:
    """A torch OIDHW conv weight as the contiguous DHWIO the kernels take."""
    return weight.permute(2, 3, 4, 1, 0).contiguous()


def conv3p_route(use_kernels: bool):
    """K1 for the serving forward, its ``autograd.Function`` when grad mode
    is on, the plain version when kernels are off."""
    if not use_kernels:
        return conv3_planes_ref
    return conv3_planes_diff if torch.is_grad_enabled() else conv3_planes


class StencilConv3(nn.Conv3d):
    """A 3^3 stride-1 SAME conv with fused residual and activation, run by
    the K1 kernel (or its plain version when ``use_kernels`` is False).

    Holds an ordinary ``nn.Conv3d`` weight (OIDHW) and bias, so its
    ``state_dict`` is that of the reference's ``Conv3d``; the padding
    (``pad_mode`` 'zero' or 'edge') is applied inside the kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 pad_mode: str = "zero", bias: bool = True):
        super().__init__(in_channels, out_channels, 3, bias=bias)
        self.pad_mode = pad_mode
        self.use_kernels = True

    def forward(self, x, residual=None, act: str = "none"):
        return conv3p_route(self.use_kernels)(
            x, dhwio(self.weight), self.bias, residual, act=act,
            pad_mode=self.pad_mode)


class ResConv3D(nn.Module):
    """leaky(x + conv(leaky(conv(x)))) with edge padding; reference tree
    ``tmp = [pad, conv, leaky, pad, conv]`` (convs at ``tmp.1``/``tmp.4``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.tmp = nn.ModuleList([
            nn.ReplicationPad3d(1),
            StencilConv3(channels, channels, pad_mode="edge"),
            nn.LeakyReLU(0.2),
            nn.ReplicationPad3d(1),
            StencilConv3(channels, channels, pad_mode="edge"),
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

    def __init__(self, basedim: int = 1, in_channels: int = 1):
        super().__init__()
        self.basedim = basedim
        self.conv1 = nn.ModuleList([
            nn.ReplicationPad3d(1),
            StencilConv3(in_channels, basedim, pad_mode="edge"),
            ResConv3D(basedim),
            ResConv3D(basedim),
        ])
        self.weights = nn.Parameter(corner_mask(in_channels))
        self.use_kernels = True

    def forward(self, x):
        h = self.conv1[1](x)
        h = self.conv1[3](self.conv1[2](h))
        fn = conv3p_route(self.use_kernels)
        if self.basedim == 1:
            return fn(x, dhwio(self.weights), None, h, pad_mode="zero")
        return h + fn(x, dhwio(self.weights), pad_mode="zero")
