"""3D ResNet-50 pose backbone + 3D deconvolution head.

Port of ``hiddenpose_tpu/models/posenet3d.py`` (``PoseNet3D``,
``Bottleneck``, ``DeconvHead``).  The serving forward (eval mode, grad
mode off) fuses what it can:

* the stem is the 7^3 conv over the raw volume with eval BN and ReLU fused
  (K2, ``ops/kernels/stem_conv.py``), then MaxPool3d(3, 2, 1) (K3,
  ``ops/kernels/phase_pool.py``), both NDHWC; no space-to-depth;
* Bottlenecks [3, 4, 6, 3] use torch's k//2 padding; the conv2 of every
  stride-1 block of width 64, 128 or 256 runs the K4 kernel
  (``ops/kernels/conv3mxu.py``: f32 in and out, the products in three TF32
  passes on the tensor cores, never one) with bn2 and the ReLU fused; the
  other convs, the deconvs and the norms are ``torch.nn.functional`` calls;
* the network runs in ``torch.channels_last_3d``, so K2's output, K3, K4
  and the library convs all see NDHWC memory with no transposes between.

In training (or whenever grad mode is on) nothing is folded: the stem is
the library 7^3 conv with the matrix-product backward of
``ops/stem_vjp.py`` (the reference's ``conv_s2d_stem_diff``; plain
autograd of the library conv with the kernels off), bn1 and ReLU, then the
differentiable pool (K3 forward, K7 backward); each conv2 that the JAX
router admits (:func:`router_admits`: at t128 every stride-1 block of
width 64-256) runs without epilogue through the route the JAX package
takes at the ambient matmul precision (``conv3mxu.matmul_precision``,
set by the train step): 'full' under 'high' and 'highest' (K4 forward
and K4-dx, :class:`Conv3Mxu`), 'bwd' under 'default' (the library's
forward and K4-dx-bf16, :class:`Conv3MxuBwd`); then bn2 and ReLU.
Every BatchNorm is a :class:`FlaxBatchNorm3d`: batch statistics in
training, and running statistics updated with the biased batch variance,
as flax does.

The bfloat16 model (``dtype=torch.bfloat16``) follows the JAX package's
casts: the stem runs K2-bf16 and K3-bf16 on the input rounded to bf16 (in
training the library conv on bf16 operands, bn1 in f32, the ReLU's output
rounded to bf16, the pool on bf16); every conv and deconv takes its input
and weight rounded to bf16 and returns bf16 (the serving K4 conv2 with its
bn2 affine and ReLU in f32 before the one rounding; its f32 input is
rounded in a separate pass, since the kernel's copies cannot convert);
every other BatchNorm is flax's ``nn.BatchNorm`` without a dtype, which
returns float32 for a bf16 input and float32 parameters (the cotangent of
its input rounds back to bf16), so the residual adds and ReLUs run in f32
and the next conv rounds again; the head's final conv adds its bias in
bf16.

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
    conv3_mxu_bf16,
    conv3_mxu_bwd_diff,
    conv3_mxu_diff,
    conv3_mxu_ref,
    maxpool3d_k3s2p1,
    maxpool3d_k3s2p1_bf16,
    maxpool3d_k3s2p1_diff,
    maxpool3d_k3s2p1_ref,
    stem_conv_raw,
    stem_conv_raw_bf16,
    stem_conv_raw_ref,
)
from hiddenpose_tpu_torch.ops.kernels.conv3mxu import route, router_admits
from hiddenpose_tpu_torch.ops.stem_vjp import stem_conv_diff

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


def conv(m: nn.Module, x, dtype):
    """``m`` (a ``Conv3d`` or ``ConvTranspose3d``) on ``x``; for a bf16
    ``dtype`` with input and weight rounded to bf16 and a bf16 result (a
    bias is added after, in bf16, as the JAX package's FinalConv does)."""
    if dtype == torch.float32:
        return m(x)
    x, w = x.to(dtype), m.weight.to(dtype)
    if isinstance(m, nn.ConvTranspose3d):
        y = F.conv_transpose3d(x, w, None, m.stride, m.padding)
    else:
        y = F.conv3d(x, w, None, m.stride, m.padding)
    if m.bias is None:
        return y
    return y + m.bias.to(dtype)[:, None, None, None]


def bn(m: nn.BatchNorm3d, x):
    """``m`` on ``x``; a bf16 ``x`` is normalised in f32 and the result is
    float32, as flax's ``nn.BatchNorm`` without a dtype returns for a bf16
    input and float32 parameters."""
    return m(x.float())


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
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
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
        dt = self.compute_dtype
        out = F.relu(bn(self.bn1, conv(self.conv1, x, dt)))
        if self.k4 and fused(self):
            scale, shift = bn_affine(self.bn2)
            fn = conv3_mxu if self.use_kernels else conv3_mxu_ref
            if dt == torch.bfloat16 and self.use_kernels:
                fn = conv3_mxu_bf16
            out = fn(out.to(dt).permute(0, 2, 3, 4, 1).contiguous(),
                     dhwio(self.conv2.weight).to(dt), scale, shift,
                     relu=True)
            out = out.permute(0, 4, 1, 2, 3)
        elif self.k4 and router_admits(
                (out.shape[0], *out.shape[2:], out.shape[1]),
                out.shape[1], out.shape[1]):
            xin = out.to(dt).permute(0, 2, 3, 4, 1).contiguous()
            k = dhwio(self.conv2.weight).to(dt)
            if route() == "bwd":
                y = conv3_mxu_bwd_diff(xin, k, plain=not self.use_kernels)
            else:
                fn = conv3_mxu_diff if self.use_kernels else conv3_mxu_ref
                y = fn(xin, k)
            out = F.relu(bn(self.bn2, y.permute(0, 4, 1, 2, 3)))
        else:
            out = F.relu(bn(self.bn2, conv(self.conv2, out, dt)))
        out = bn(self.bn3, conv(self.conv3, out, dt))
        residual = x
        if self.downsample is not None:
            residual = bn(self.downsample[1], conv(self.downsample[0], x, dt))
        return F.relu(out + residual)


class DeconvHead(nn.Module):
    """3 x (ConvTranspose3d(k4, s2, p1) + BN + ReLU), then a 1x1x1 conv."""

    def __init__(self, in_channels: int = 2048, num_layers: int = 3,
                 num_filters: int = 256, num_joints: int = 24,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
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
        f = self.features
        for i in range(0, len(f) - 1, 3):  # deconv, BN (f32 out), ReLU
            x = F.relu(bn(f[i + 1], conv(f[i], x, self.compute_dtype)))
        return conv(f[-1], x, self.compute_dtype)


class PoseNet3D(nn.Module):
    """(B, 1, D, H, W) -> heatmaps (B, num_joints, D/2, H/2, W/2)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 num_joints: int = 24, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
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
                seq.append(Bottleneck(in_planes, planes, s, proj, dtype))
                in_planes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.head = DeconvHead(in_planes, num_joints=num_joints, dtype=dtype)
        self.use_kernels = True

    def stem(self, x):
        """conv7^3 + BN + ReLU then MaxPool3d(3, 2, 1): K2 and K3 in the
        serving forward; else the library conv (its backward rewritten as
        matrix products, ``stem_conv_diff``), bn1, ReLU and the
        differentiable pool (K3, K7)."""
        b, c, d, h, w = x.shape
        if c != 1:
            raise ValueError(f"the stem takes 1 input channel, got {c}")
        if fused(self):
            scale, shift = bn_affine(self.bn1)
            stem = stem_conv_raw if self.use_kernels else stem_conv_raw_ref
            pool = (maxpool3d_k3s2p1 if self.use_kernels
                    else maxpool3d_k3s2p1_ref)
            dt = self.compute_dtype
            if dt == torch.bfloat16 and self.use_kernels:
                stem, pool = stem_conv_raw_bf16, maxpool3d_k3s2p1_bf16
            y = stem(x.to(dt).reshape(b, d, h, w, 1).contiguous(),
                     dhwio(self.conv1.weight).to(dt), scale, shift,
                     relu=True)
        else:
            dt = self.compute_dtype
            xs, w = x.to(dt), self.conv1.weight.to(dt)
            conv = (stem_conv_diff(xs, w) if self.use_kernels
                    else F.conv3d(xs, w, padding=3))
            # bn1 on the f32 widening, the ReLU's output in the model's type
            # (the reference's StemS2D: statistics of an f32 conv output)
            y = F.relu(self.bn1(conv.float())).to(dt)
            y = y.permute(0, 2, 3, 4, 1).contiguous()
            pool = (maxpool3d_k3s2p1_diff if self.use_kernels
                    else maxpool3d_k3s2p1_ref)
        return pool(y).permute(0, 4, 1, 2, 3)  # channels_last NCDHW view

    def forward(self, x):
        x = self.stem(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.head(x)
