"""The 2D pose backbone of NlosPose's ``posenet2d`` mode, and VisibleNet.

Port of ``hiddenpose_tpu/models/posenet2d.py``: a 2D ResNet trunk
(``BasicBlock2D`` / ``Bottleneck2D``, layers (3, 4, 6, 3) by default) and
a head of three k4 s2 transposed convs with BatchNorm and ReLU, then a 1x1
conv to ``num_joints * depth_dim`` depth-sliced heatmap channels
(:class:`ResPoseNet2D`); :func:`visible_net` flattens a 3D feature volume
to 2D channels for it.

NCHW throughout.  ``dtype=torch.bfloat16`` is the JAX module's
``dtype=bf16``: every conv and deconv rounds its input and weight to
bf16 and returns bf16, every BatchNorm returns float32 (flax's BatchNorm
has no dtype), so the ReLUs, the max-pool and the residual adds run in
f32 and the heatmaps come out bf16.  Where flax and torch differ, the
JAX package is followed:

* flax's ``padding="SAME"`` pads a stride-2 conv asymmetrically on an even
  extent (the 7x7 stem (2, 3), a 3x3 (0, 1)): :class:`SameConv2d` pads
  explicitly as ``lax`` does, where ``nn.Conv2d(padding=k // 2)`` would
  shift every output by one pixel;
* flax's ``ConvTranspose(k4, s2, "SAME")`` is torch's ``ConvTranspose2d(4,
  2, padding=1)`` on the spatially flipped kernel (``utils/jax_bridge.py``
  flips it);
* every BatchNorm is :class:`FlaxBatchNorm2d`: flax's running statistics
  (momentum 0.9, the biased batch variance);
* ``lax.top_k`` puts the lower index first among equal values, which the
  depth channel of :func:`visible_net` reads: the port takes each rank as
  the first maximum of what the ranks before it left
  (:func:`top_k_first`), which does the same on every device.

Module names are the flax tree's (``backbone.layer1_0.conv1``,
``head.deconv1``, ``head.final``), so the bridge is a walk of the tree.
No kernel runs here: the convs, the norms and the pool are library calls.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.models.posenet3d import flax_batch_norm
from hiddenpose_tpu_torch.ops.normalize import normalize


def same_pads(n: int, k: int, s: int):
    """(low, high) padding of flax's ``"SAME"`` for an extent ``n``,
    kernel ``k``, stride ``s``: the output has ceil(n / s) positions and
    the odd pixel of padding goes after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``"SAME"`` padding (no bias); with a bf16
    ``dtype`` the input and weight are rounded to it and the result is
    bf16 (flax's ``nn.Conv(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_pads(x.shape[2], k, s)
        pw = same_pads(x.shape[3], k, s)
        if any(ph + pw):
            x = F.pad(x, (*pw, *ph))
        w, dt = self.weight, self.compute_dtype
        if dt != torch.float32:
            x, w = x.to(dt), w.to(dt)
        return F.conv2d(x, w, None, s)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward is flax's
    ``nn.BatchNorm(momentum=0.9)`` (``posenet3d.py::flax_batch_norm``:
    the running statistics ``0.9 * old + 0.1 * batch``, the variance
    biased; torch's own update uses the unbiased one).  A bf16 input is
    normalised in f32 and the result is float32, as flax's BatchNorm
    without a dtype returns for a bf16 input and float32 parameters.  Eval
    mode is torch's."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        if not self.training:
            return super().forward(x)
        return flax_batch_norm(self, x)


class BasicBlock2D(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_projection: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = SameConv2d(in_planes, planes, 3, stride, dtype)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = SameConv2d(planes, planes, 3, dtype=dtype)
        self.bn2 = FlaxBatchNorm2d(planes)
        if use_projection:
            self.conv_proj = SameConv2d(in_planes, planes, 1, stride, dtype)
            self.bn_proj = FlaxBatchNorm2d(planes)
        self.use_projection = use_projection

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = (self.bn_proj(self.conv_proj(x)) if self.use_projection
                    else x)
        return F.relu(out + residual)


class Bottleneck2D(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_projection: bool = False, dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SameConv2d(in_planes, planes, 1, dtype=dtype)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = SameConv2d(planes, planes, 3, stride, dtype)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3 = SameConv2d(planes, out, 1, dtype=dtype)
        self.bn3 = FlaxBatchNorm2d(out)
        if use_projection:
            self.conv_proj = SameConv2d(in_planes, out, 1, stride, dtype)
            self.bn_proj = FlaxBatchNorm2d(out)
        self.use_projection = use_projection

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.bn_proj(self.conv_proj(x)) if self.use_projection
                    else x)
        return F.relu(out + residual)


class ResNetBackbone2D(nn.Module):
    """7x7 s2 stem, BN, ReLU, 3x3 s2 max-pool, four stages of blocks."""

    def __init__(self, in_channels: int, layers: Sequence[int] = (3, 4, 6, 3),
                 block: str = "bottleneck", dtype=torch.float32):
        super().__init__()
        block_cls = Bottleneck2D if block == "bottleneck" else BasicBlock2D
        self.conv1 = SameConv2d(in_channels, 64, 7, 2, dtype)
        self.bn1 = FlaxBatchNorm2d(64)
        in_planes = 64
        self.block_names = []
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            for b in range(blocks):
                s = stride if b == 0 else 1
                out = planes * block_cls.expansion
                proj = b == 0 and (s != 1 or in_planes != out)
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, block_cls(in_planes, planes, s, proj,
                                              dtype))
                self.block_names.append(name)
                in_planes = out
        self.out_channels = in_planes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        # flax's max_pool with ((1, 1), (1, 1)) pads with -inf, as torch's
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class DeconvHead2D(nn.Module):
    """3 x (ConvTranspose k4 s2 + BN + ReLU), then a 1x1 conv (with bias)
    to ``num_joints * depth_dim`` channels.  In bf16 each conv rounds its
    input and weight and returns bf16, the final conv's bias added in
    bf16, as flax's ``dtype`` does."""

    def __init__(self, in_channels: int, num_layers: int = 3,
                 num_filters: int = 256, num_joints: int = 24,
                 depth_dim: int = 64, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.compute_dtype = dtype
        for i in range(num_layers):
            setattr(self, f"deconv{i + 1}", nn.ConvTranspose2d(
                in_channels if i == 0 else num_filters, num_filters, 4,
                stride=2, padding=1, bias=False))
            setattr(self, f"bn{i + 1}", FlaxBatchNorm2d(num_filters))
        self.final = nn.Conv2d(num_filters, num_joints * depth_dim, 1)

    def forward(self, x):
        dt = self.compute_dtype
        for i in range(1, self.num_layers + 1):
            m = getattr(self, f"deconv{i}")
            y = (m(x) if dt == torch.float32 else F.conv_transpose2d(
                x.to(dt), m.weight.to(dt), None, m.stride, m.padding))
            x = F.relu(getattr(self, f"bn{i}")(y))
        if dt == torch.float32:
            return self.final(x)
        y = F.conv2d(x.to(dt), self.final.weight.to(dt))
        return y + self.final.bias.to(dt)[:, None, None]


class ResPoseNet2D(nn.Module):
    """(B, C, H, W) -> (B, num_joints * depth_dim, H / 4, W / 4) for the
    default trunk (the stem and the pool halve twice, layers 2-4 three
    times, the head doubles three times)."""

    def __init__(self, in_channels: int, num_joints: int = 24,
                 depth_dim: int = 64, layers: Sequence[int] = (3, 4, 6, 3),
                 block: str = "bottleneck", dtype=torch.float32):
        super().__init__()
        self.backbone = ResNetBackbone2D(in_channels, layers, block, dtype)
        self.head = DeconvHead2D(self.backbone.out_channels,
                                 num_joints=num_joints, depth_dim=depth_dim,
                                 dtype=dtype)

    def forward(self, x):
        return self.head(self.backbone(x))


def top_k_first(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values, and their
    indices.  Each rank is the first maximum (``argmax`` returns the first
    index of the maximum on every device) of what the ranks before it left,
    their positions set to -inf: ``torch.topk`` leaves the order of ties
    unspecified, and the CUDA sort does not keep ties in order when it
    sorts descending."""
    vals, idxs = [], []
    for _ in range(k):
        i = x.argmax(dim=-1, keepdim=True)
        vals.append(x.gather(-1, i))
        idxs.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


@functools.lru_cache(maxsize=None)
def _depth_table(depth: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    """(D - 1 - i) / (D - 1) for i < D, divided on the CPU (a CUDA division
    by a Python number multiplies by its reciprocal, an ulp off) and kept
    on ``device``.  Made outside inference mode: a serving forward may build
    it first, and a recorded forward then gathers from it."""
    with torch.inference_mode(False):
        table = (depth - 1 - torch.arange(depth, dtype=dtype)) / (depth - 1)
        return table.to(device)


def visible_net(x: torch.Tensor, k: int = 4) -> torch.Tensor:
    """Flatten a 3D feature volume to 2D channels: ReLU, per-channel
    min/max normalisation, x1e5, the top ``k`` along depth, then
    concat(values, flipped depth index / (D - 1)).

    x (B, C, D, H, W) -> (B, 2*C*k, H, W), channels ordered (c, rank).
    Among equal values the lower depth index ranks first, as with
    ``lax.top_k``."""
    x = normalize(F.relu(x)) * 1.0e5
    b, c, depth, h, w = x.shape
    vals, idx = top_k_first(x.movedim(2, -1), k)  # (B, C, H, W, k)
    dep = _depth_table(depth, str(x.device), x.dtype)[idx]
    vals = vals.movedim(-1, 2).reshape(b, c * k, h, w)
    dep = dep.movedim(-1, 2).reshape(b, c * k, h, w)
    return torch.cat([vals, dep], dim=1)
