"""3D ResNet-50 pose backbone + 3D deconvolution head.

Port of ``hiddenpose_tpu/models/posenet3d.py`` (``PoseNet3D``,
``Bottleneck``, ``DeconvHead``).  The serving forward (eval mode, grad
mode off) fuses what it can:

* the stem is the 7^3 conv over the raw volume with eval BN and ReLU fused
  (K2, ``ops/kernels/stem_conv.py``), then MaxPool3d(3, 2, 1) (K3,
  ``ops/kernels/phase_pool.py``), both NDHWC; no space-to-depth;
* Bottlenecks [3, 4, 6, 3] use torch's k//2 padding; the conv2 of every
  stride-1 block of width 64, 128 or 256 runs the K4 kernel
  (``ops/kernels/conv3mxu.py``) with bn2 and the ReLU fused; the other
  convs, the deconvs and the norms are ``torch.nn.functional`` calls;
* the network runs in ``torch.channels_last_3d``, so K2's output, K3, K4
  and the library convs all see NDHWC memory with no transposes between.

In training (or whenever grad mode is on) nothing is folded: the stem is
the library 7^3 conv, bn1 and ReLU, then the differentiable pool (K3
forward, K7 backward); each K4 conv2 runs without epilogue through its
``autograd.Function`` (K4 forward and dx), then bn2 and ReLU, as the JAX
package's train path does.  Every BatchNorm is a
:class:`FlaxBatchNorm3d`: batch statistics in training, and running
statistics updated with the biased batch variance, as flax does.

Module names follow the reference PyTorch model (``conv1``/``bn1``,
``layer{s}.{b}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``,
``head.features.{0..9}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.models.blocks import dhwio
from hiddenpose_tpu_torch.ops.kernels import (
    conv3_mxu,
    conv3_mxu_diff,
    conv3_mxu_ref,
    maxpool3d_k3s2p1,
    maxpool3d_k3s2p1_diff,
    maxpool3d_k3s2p1_ref,
    stem_conv_raw,
    stem_conv_raw_ref,
)

# Bottleneck widths whose stride-1 conv2 runs the K4 kernel (the shapes the
# JAX package routes to conv3mxu; c512 stays a library conv there too).
K4_PLANES = (64, 128, 256)


def bn_affine(bn: nn.BatchNorm3d):
    """Eval BatchNorm as a per-channel (scale, shift) pair."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


def fused(module: nn.Module) -> bool:
    """The serving forward: eval mode and grad mode off, where BN folds
    into the kernels' epilogues."""
    return not (module.training or torch.is_grad_enabled())


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (same parameters, buffers and state_dict keys)
    whose training forward follows flax's ``nn.BatchNorm(momentum=0.9)``:
    it normalises with the batch mean and biased variance, as torch does,
    but updates ``running_var`` with the BIASED variance too (torch's own
    update uses the unbiased one): ``0.9 * old + 0.1 * batch`` for both
    running statistics.  Eval mode is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        return y


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv3d(in_planes, planes, 1, bias=False)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FlaxBatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm3d(out)
        self.downsample = (
            nn.Sequential(nn.Conv3d(in_planes, out, 1, stride=stride,
                                    bias=False), FlaxBatchNorm3d(out))
            if downsample else None)
        self.k4 = stride == 1 and planes in K4_PLANES
        self.use_kernels = True

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.k4 and fused(self):
            scale, shift = bn_affine(self.bn2)
            fn = conv3_mxu if self.use_kernels else conv3_mxu_ref
            out = fn(out.permute(0, 2, 3, 4, 1).contiguous(),
                     dhwio(self.conv2.weight), scale, shift, relu=True)
            out = out.permute(0, 4, 1, 2, 3)
        elif self.k4:
            fn = conv3_mxu_diff if self.use_kernels else conv3_mxu_ref
            out = fn(out.permute(0, 2, 3, 4, 1).contiguous(),
                     dhwio(self.conv2.weight))
            out = F.relu(self.bn2(out.permute(0, 4, 1, 2, 3)))
        else:
            out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class DeconvHead(nn.Module):
    """3 x (ConvTranspose3d(k4, s2, p1) + BN + ReLU), then a 1x1x1 conv."""

    def __init__(self, in_channels: int = 2048, num_layers: int = 3,
                 num_filters: int = 256, num_joints: int = 24):
        super().__init__()
        layers = []
        for i in range(num_layers):
            layers += [
                nn.ConvTranspose3d(in_channels if i == 0 else num_filters,
                                   num_filters, 4, stride=2, padding=1,
                                   bias=False),
                FlaxBatchNorm3d(num_filters),
                nn.ReLU(),
            ]
        layers.append(nn.Conv3d(num_filters, num_joints, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


class PoseNet3D(nn.Module):
    """(B, 1, D, H, W) -> heatmaps (B, num_joints, D/2, H/2, W/2)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 num_joints: int = 24):
        super().__init__()
        self.conv1 = nn.Conv3d(1, widths[0], 7, padding=3, bias=False)
        self.bn1 = FlaxBatchNorm3d(widths[0])
        in_planes = widths[0]
        for stage, (planes, blocks) in enumerate(zip(widths, layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                proj = b == 0 and (s != 1 or
                                   in_planes != planes * Bottleneck.expansion)
                seq.append(Bottleneck(in_planes, planes, s, proj))
                in_planes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.head = DeconvHead(in_planes, num_joints=num_joints)
        self.use_kernels = True

    def stem(self, x):
        """conv7^3 + BN + ReLU then MaxPool3d(3, 2, 1): K2 and K3 in the
        serving forward; else the library conv, bn1, ReLU and the
        differentiable pool (K3, K7)."""
        b, c, d, h, w = x.shape
        if c != 1:
            raise ValueError(f"the stem takes 1 input channel, got {c}")
        if fused(self):
            scale, shift = bn_affine(self.bn1)
            stem = stem_conv_raw if self.use_kernels else stem_conv_raw_ref
            pool = (maxpool3d_k3s2p1 if self.use_kernels
                    else maxpool3d_k3s2p1_ref)
            y = stem(x.reshape(b, d, h, w, 1).contiguous(),
                     dhwio(self.conv1.weight), scale, shift, relu=True)
        else:
            y = F.relu(self.bn1(F.conv3d(x, self.conv1.weight, padding=3)))
            y = y.permute(0, 2, 3, 4, 1).contiguous()
            pool = (maxpool3d_k3s2p1_diff if self.use_kernels
                    else maxpool3d_k3s2p1_ref)
        return pool(y).permute(0, 4, 1, 2, 3)  # channels_last NCDHW view

    def forward(self, x):
        x = self.stem(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.head(x)
