"""3D U-Net denoising autoencoder.

Port of ``hiddenpose_tpu/models/unet3d.py``: four levels,
DoubleConv = (3^3 conv -> GroupNorm(4, eps 1e-5) -> ReLU) x 2, MaxPool3d(2)
down, trilinear x2 (align_corners=True) up with centre padding to the skip,
concatenation, and a 1x1x1 output conv.  Every 3^3 conv is the K1 kernel
(``StencilConv3``); the norms, resizes and the pools' forward are plain
torch ops, and with grad mode on the pools' backward is K8
(``ops/kernels/pool2p.py``).
Module names follow the reference (``conv``, ``enc{1-4}.encoder.1``,
``dec{1-4}.conv``, ``out.conv``; ``double_conv.{0,1,3,4}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.models.blocks import StencilConv3
from hiddenpose_tpu_torch.ops.kernels import max_pool2_diff


class MaxPool2(nn.Module):
    """MaxPool3d(2); with kernels on and grad mode on, its backward is K8
    (the cotangent to the first maximum of each window in (d, h, w)
    order, as ``F.max_pool3d``'s own backward and the JAX package's)."""

    def __init__(self):
        super().__init__()
        self.use_kernels = True

    def forward(self, x):
        if self.use_kernels and torch.is_grad_enabled():
            return max_pool2_diff(x)
        return F.max_pool3d(x, 2)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 4):
        super().__init__()
        g = min(num_groups, out_channels)
        self.double_conv = nn.Sequential(
            StencilConv3(in_channels, out_channels),
            nn.GroupNorm(g, out_channels, eps=1e-5),
            nn.ReLU(),
            StencilConv3(out_channels, out_channels),
            nn.GroupNorm(g, out_channels, eps=1e-5),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.double_conv(x)


class Encoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.encoder = nn.Sequential(
            MaxPool2(), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.encoder(x)


class Decoder(nn.Module):
    """Trilinear x2 of ``lo``, centre-pad to ``skip``, concat, DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, lo, skip):
        lo = F.interpolate(lo, size=tuple(2 * s for s in lo.shape[2:]),
                           mode="trilinear", align_corners=True)
        pads = []
        for ax in (4, 3, 2):  # F.pad lists the last axis first
            diff = skip.shape[ax] - lo.shape[ax]
            pads += [diff // 2, diff - diff // 2]
        lo = F.pad(lo, pads)
        return self.conv(torch.cat([skip, lo], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.conv(x)


class UNet3d(nn.Module):
    """(B, in_channels, D, H, W) -> same shape; width ``n_channels``."""

    def __init__(self, in_channels: int = 1, n_channels: int = 4):
        super().__init__()
        n = n_channels
        self.conv = DoubleConv(in_channels, n)
        self.enc1 = Encoder(n, 2 * n)
        self.enc2 = Encoder(2 * n, 4 * n)
        self.enc3 = Encoder(4 * n, 8 * n)
        self.enc4 = Encoder(8 * n, 8 * n)
        self.dec1 = Decoder(16 * n, 4 * n)
        self.dec2 = Decoder(8 * n, 2 * n)
        self.dec3 = Decoder(4 * n, n)
        self.dec4 = Decoder(2 * n, n)
        self.out = OutConv(n, in_channels)

    def forward(self, x):
        x1 = self.conv(x)
        x2 = self.enc1(x1)
        x3 = self.enc2(x2)
        x4 = self.enc3(x3)
        x5 = self.enc4(x4)
        out = self.dec1(x5, x4)
        out = self.dec2(out, x3)
        out = self.dec3(out, x2)
        out = self.dec4(out, x1)
        return self.out(out)
