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

In the bfloat16 model (serving and training) the volumes are bf16
throughout, as in the JAX package: the convs rounded as
``models/blocks.py`` says, GroupNorm with statistics and affine in f32
returning bf16, pools and the three per-axis resize passes in bf16 (each
with the weights rounded to bf16, computed in f32 and rounded, as the JAX
einsums with ``preferred_element_type=x.dtype``), and the output conv in
bf16.
"""

from __future__ import annotations

import functools

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


class GroupNormP(nn.GroupNorm):
    """``nn.GroupNorm`` (same parameters and state_dict keys) as the JAX
    package's ``GroupNormP``: statistics and affine in float32, the result
    in the input's type (a bf16 volume comes back bf16)."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 4, dtype=torch.float32):
        super().__init__()
        g = min(num_groups, out_channels)
        self.double_conv = nn.Sequential(
            StencilConv3(in_channels, out_channels, dtype=dtype),
            GroupNormP(g, out_channels, eps=1e-5),
            nn.ReLU(),
            StencilConv3(out_channels, out_channels, dtype=dtype),
            GroupNormP(g, out_channels, eps=1e-5),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.double_conv(x)


class Encoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = nn.Sequential(
            MaxPool2(), DoubleConv(in_channels, out_channels, dtype=dtype))

    def forward(self, x):
        return self.encoder(x)


def interp_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) linear interpolation weights, align_corners=True (the
    JAX package's ``_interp_matrix_align_corners``), float32."""
    if n_in == 1:
        return torch.ones((n_out, 1))
    pos = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) \
        / max(n_out - 1, 1)
    lo = pos.floor().long().clamp(0, n_in - 1)
    hi = (lo + 1).clamp(0, n_in - 1)
    mat = torch.zeros((n_out, n_in), dtype=torch.float64)
    rows = torch.arange(n_out)
    mat.index_put_((rows, lo), 1.0 - (pos - lo), accumulate=True)
    mat.index_put_((rows, hi), pos - lo, accumulate=True)
    return mat.float()


def upsample2(x):
    """Trilinear x2 (align_corners=True) of (B, C, D, H, W).  A float32
    volume in one pass; a bf16 one as the JAX package's three per-axis
    contractions (D, then H, then W) of bf16 operands: each takes the
    interpolation weights rounded to bf16 (its dot of a bf16 volume and an
    f32 matrix with a bf16 result), sums in f32 and rounds to bf16."""
    if x.dtype == torch.float32:
        return F.interpolate(x, size=tuple(2 * s for s in x.shape[2:]),
                             mode="trilinear", align_corners=True)
    dt = x.dtype
    for ax in (2, 3, 4):
        m = _rounded_weights(x.shape[ax], dt, x.device)
        x = torch.movedim(torch.movedim(x.float(), ax, -1) @ m, -1, ax)
        x = x.to(dt)
    return x


@functools.lru_cache(maxsize=None)
def _rounded_weights(n: int, dtype: torch.dtype, device: torch.device):
    """The (n, 2n) transposed ``interp_matrix`` of a x2 rounded to
    ``dtype``, in f32 on ``device``: made once a shape, so that a forward
    copies nothing from the host; an ordinary tensor even when first asked
    for under ``torch.inference_mode`` (a server's), since training uses it
    too."""
    with torch.inference_mode(False):
        m = interp_matrix(n, 2 * n).to(dtype).float().T.contiguous()
        return m.to(device)


class Decoder(nn.Module):
    """Trilinear x2 of ``lo``, centre-pad to ``skip``, concat, DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, dtype=dtype)

    def forward(self, lo, skip):
        lo = upsample2(lo)
        pads = []
        for ax in (4, 3, 2):  # F.pad lists the last axis first
            diff = skip.shape[ax] - lo.shape[ax]
            pads += [diff // 2, diff - diff // 2]
        lo = F.pad(lo, pads)
        return self.conv(torch.cat([skip, lo], dim=1))


class OutConv(nn.Module):
    """The 1x1x1 output conv as the reference's ``OutConv1x1`` computes it:
    a contraction over the channel axis (``einsum("bcdhw,co->bodhw")``) plus
    the bias, in plain tensor ops.  ``conv`` only holds the parameters
    (``conv.weight`` (C_out, C_in, 1, 1, 1), ``conv.bias``), so state dicts
    keep their names; its own forward is not called, so the backward never
    enters the library's conv backward, which for so few channels runs a
    slow grouped-direct kernel.  A multiply by the broadcast weight and a
    sum over the channel axis: its autograd is element-wise passes and one
    reduction per parameter."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x):
        w = self.conv.weight[:, :, 0, 0, 0]  # (C_out, C_in)
        bias = self.conv.bias[None, :, None, None, None]
        if x.dtype != torch.float32:
            # bf16 operands, the contraction in f32 rounded to bf16, then a
            # bf16 bias add: the JAX einsum of bf16 operands, + bias
            w = w.to(x.dtype).float()
            y = (x.float().unsqueeze(1)
                 * w[None, :, :, None, None, None]).sum(dim=2)
            return y.to(x.dtype) + bias.to(x.dtype)
        y = (x.unsqueeze(1) * w[None, :, :, None, None, None]).sum(dim=2)
        return y + bias


class UNet3d(nn.Module):
    """(B, in_channels, D, H, W) -> same shape; width ``n_channels``."""

    def __init__(self, in_channels: int = 1, n_channels: int = 4,
                 dtype=torch.float32):
        super().__init__()
        n = n_channels
        self.conv = DoubleConv(in_channels, n, dtype=dtype)
        self.enc1 = Encoder(n, 2 * n, dtype)
        self.enc2 = Encoder(2 * n, 4 * n, dtype)
        self.enc3 = Encoder(4 * n, 8 * n, dtype)
        self.enc4 = Encoder(8 * n, 8 * n, dtype)
        self.dec1 = Decoder(16 * n, 4 * n, dtype)
        self.dec2 = Decoder(8 * n, 2 * n, dtype)
        self.dec3 = Decoder(4 * n, n, dtype)
        self.dec4 = Decoder(2 * n, n, dtype)
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
