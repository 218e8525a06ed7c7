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

In training, ``remat`` recomputes each residual block in the backward
and ``remat_stem`` the stem above (``utils/remat.py``; the JAX
``PoseNet3D``'s knobs of those names, which NlosPose sets from
``cfg.posenet_remat`` and ``cfg.posenet_remat_stem``).  The JAX class
defaults ``remat`` to True, but the JAX NlosPose always passes the
config's False; here both default to False.  The results are the same
either way.

The other configurations of the JAX ``PoseNet3D``: ``block="basic"``
(:class:`BasicBlock`, the ResNet-18/34 block: two 3^3 convs, bn2 without
a ReLU, the ReLU after the residual add), ``widen_factor`` (each width
``int(w * widen_factor)``), and the stem knobs ``conv1_t_size``,
``conv1_t_stride`` and ``no_max_pool``.  The stem follows the JAX
package's gate: with ``conv1_t_size == 7``, ``conv1_t_stride == 1``, the
max-pool on, at most 2 input channels and even extents it is the stem
above (K2 needs one input channel and 64 features; a 2-channel input, or
another width, takes the library conv with bn1 and ReLU in serving, and
the library conv's plain autograd in training, then the pool by K3 and
K7 as above); otherwise the library stem: a (t, 7, 7) conv at stride
(t_stride, 1, 1) with flax's SAME padding (for a stride the low side
pads the smaller half: (2, 3) for k7 s2 on an even extent), bn1, ReLU and
``F.max_pool3d(3, 2, 1)`` unless ``no_max_pool``.  Every 3^3 stride-1
conv that the JAX router admits (:func:`router_admits`), in a BasicBlock
conv1 as well as conv2, runs K4 as the Bottleneck's conv2 does: in
serving with its BN affine fused into the epilogue where that rounds as
the JAX package does (f32: bn1 with its ReLU, bn2 without; bf16: bn2
only, conv1's output is rounded to bf16 before bn1 as JAX rounds it).

Module names follow the reference PyTorch model (``conv1``/``bn1``,
``layer{s}.{b}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``,
``head.features.{0..9}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch import resolve_device
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
from hiddenpose_tpu_torch.parallel.mesh import active_mesh, sync_batch_norm
from hiddenpose_tpu_torch.utils import tracing
from hiddenpose_tpu_torch.utils.remat import recomputing, remat


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


def flax_batch_norm(m: nn.modules.batchnorm._BatchNorm, x):
    """The training forward of flax's ``nn.BatchNorm(momentum=0.9)`` with
    ``m``'s parameters and buffers: ``x`` normalised with its batch mean
    and biased variance, and both running statistics updated as ``0.9 *
    old + 0.1 * batch`` (torch's own update takes the unbiased variance).

    Inside a data-parallel step (``parallel/mesh.py::data_parallel``) the
    moments are the whole batch's, over every rank's share
    (``sync_batch_norm``), as the JAX step takes them.  In a recompute
    (``utils/remat.py``) the buffers are left alone: they are updated once
    a step, as flax's functional remat updates them.

    On the CPU ``x`` is normalised contiguous: torch's CPU batch norm on
    a channels-last input (K4's output, permuted) sums in another order,
    and at one thread a BasicBlock's input VJP lay 2.1e-3 (relative L2)
    from JAX's, 2.8e-6 on the contiguous copy.  A CUDA tensor goes to
    cuDNN as it is."""
    mesh = active_mesh()
    if x.device.type == "cpu":
        x = x.contiguous()
    if mesh is None:
        y = F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0, m.eps)
    else:
        y, mean, var = sync_batch_norm(x, m.weight, m.bias, m.eps, mesh)
    if not recomputing():
        with torch.no_grad():
            if mesh is None:
                var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())),
                                           unbiased=False)
            mom = m.momentum
            m.running_mean.mul_(1.0 - mom).add_(mean, alpha=mom)
            m.running_var.mul_(1.0 - mom).add_(var, alpha=mom)
            m.num_batches_tracked += 1
    return y


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (same parameters, buffers and state_dict keys)
    whose training forward is flax's (:func:`flax_batch_norm`).  Eval
    mode is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return flax_batch_norm(self, x)


def _ndhwc(x):
    """(B, C, D, H, W) -> the (B, D, H, W, C) the kernels take."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def conv3_bn(block: nn.Module, m: nn.Conv3d, bnm: nn.BatchNorm3d, x,
             relu: bool, fold_bf16: bool = True):
    """``bnm(m(x))`` of a block's 3^3 conv ``m``, then a ReLU where
    ``relu``.  A stride-1 conv that the JAX router admits runs K4: in
    serving with the BN affine and the ReLU in its epilogue (for a bf16
    block only where ``fold_bf16``; else K4-bf16's bf16 result, then the
    BN in f32, as the JAX package rounds a conv it does not fuse); in
    training by the route of the ambient precision.  Anything else is the
    library conv."""
    dt = block.compute_dtype
    cin, cout = m.in_channels, m.out_channels
    act = F.relu if relu else (lambda t: t)
    if m.stride != (1, 1, 1) or not router_admits(
            (x.shape[0], *x.shape[2:], cin), cin, cout):
        return act(bn(bnm, conv(m, x, dt)))
    k = dhwio(m.weight).to(dt)
    xin = _ndhwc(x.to(dt))
    if fused(block):
        fn = conv3_mxu if block.use_kernels else conv3_mxu_ref
        if dt == torch.bfloat16 and block.use_kernels:
            fn = conv3_mxu_bf16
        if dt == torch.float32 or fold_bf16:
            scale, shift = bn_affine(bnm)
            return fn(xin, k, scale, shift, relu=relu).permute(0, 4, 1, 2, 3)
        return act(bn(bnm, fn(xin, k).permute(0, 4, 1, 2, 3)))
    if route() == "bwd":
        y = conv3_mxu_bwd_diff(xin, k, plain=not block.use_kernels)
    else:
        fn = conv3_mxu_diff if block.use_kernels else conv3_mxu_ref
        y = fn(xin, k)
    return act(bn(bnm, y.permute(0, 4, 1, 2, 3)))


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
        self.use_kernels = True

    def forward(self, x):
        dt = self.compute_dtype
        out = F.relu(bn(self.bn1, conv(self.conv1, x, dt)))
        out = conv3_bn(self, self.conv2, self.bn2, out, relu=True)
        out = bn(self.bn3, conv(self.conv3, out, dt))
        residual = x
        if self.downsample is not None:
            residual = bn(self.downsample[1], conv(self.downsample[0], x, dt))
        return F.relu(out + residual)


class BasicBlock(nn.Module):
    """The ResNet-18/34 block: relu(bn2(conv2(relu(bn1(conv1(x))))) +
    residual), both convs 3^3 (conv1 at the block's stride)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = nn.Conv3d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = FlaxBatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm3d(planes)
        self.downsample = (
            nn.Sequential(nn.Conv3d(in_planes, planes, 1, stride=stride,
                                    bias=False), FlaxBatchNorm3d(planes))
            if downsample else None)
        self.use_kernels = True

    def forward(self, x):
        dt = self.compute_dtype
        out = conv3_bn(self, self.conv1, self.bn1, x, relu=True,
                       fold_bf16=False)
        # bn2 has no ReLU: the ReLU follows the residual add
        out = conv3_bn(self, self.conv2, self.bn2, out, relu=False)
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


def same_pads(n: int, k: int, s: int):
    """flax's SAME padding of one axis: (low, high) for extent ``n``,
    kernel ``k``, stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class PoseNet3D(nn.Module):
    """(B, C, D, H, W) -> heatmaps (B, num_joints, D', H', W'): D/2 x H/2 x
    W/2 with the default stem."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 num_joints: int = 24, dtype=torch.float32,
                 block: str = "bottleneck", widen_factor: float = 1.0,
                 conv1_t_size: int = 7, conv1_t_stride: int = 1,
                 no_max_pool: bool = False, in_channels: int = 1,
                 remat: bool = False, remat_stem: bool = False):
        super().__init__()
        self.remat, self.remat_stem = remat, remat_stem
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', "
                             f"got {block!r}")
        self.compute_dtype = dtype
        self.conv1_t_size, self.conv1_t_stride = conv1_t_size, conv1_t_stride
        self.no_max_pool = no_max_pool
        widths = [int(w * widen_factor) for w in widths]
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv3d(in_channels, widths[0], (conv1_t_size, 7, 7),
                               stride=(conv1_t_stride, 1, 1), bias=False)
        self.bn1 = FlaxBatchNorm3d(widths[0])
        in_planes = widths[0]
        for stage, (planes, blocks) in enumerate(zip(widths, layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                proj = b == 0 and (s != 1 or
                                   in_planes != planes * block_cls.expansion)
                seq.append(block_cls(in_planes, planes, s, proj, dtype))
                in_planes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.head = DeconvHead(in_planes, num_joints=num_joints, dtype=dtype)
        self.use_kernels = True

    def s2d_stem(self, x) -> bool:
        """The JAX package's gate of its fused (space-to-depth) stem."""
        return (self.conv1_t_size == 7 and self.conv1_t_stride == 1
                and not self.no_max_pool and x.shape[1] <= 2
                and all(n % 2 == 0 for n in x.shape[2:]))

    def stem(self, x):
        """conv7^3 + BN + ReLU then MaxPool3d(3, 2, 1) where the JAX gate
        takes its fused stem (:meth:`s2d_stem`): K2 and K3 in the serving
        forward; else the library conv (its backward rewritten as matrix
        products, ``stem_conv_diff``), bn1, ReLU and the differentiable
        pool (K3, K7): :meth:`train_stem`, recomputed in the backward with
        ``remat_stem``.  Otherwise :meth:`library_stem`."""
        if not self.s2d_stem(x):
            return self.library_stem(x)
        if not fused(self):
            return (remat(self.train_stem, x) if self.remat_stem
                    else self.train_stem(x))
        b, c, d, h, w = x.shape
        dt = self.compute_dtype
        pool = maxpool3d_k3s2p1 if self.use_kernels else maxpool3d_k3s2p1_ref
        if dt == torch.bfloat16 and self.use_kernels:
            pool = maxpool3d_k3s2p1_bf16
        if c == 1 and self.conv1.out_channels == 64:  # K2
            scale, shift = bn_affine(self.bn1)
            stem = stem_conv_raw if self.use_kernels else stem_conv_raw_ref
            if dt == torch.bfloat16 and self.use_kernels:
                stem = stem_conv_raw_bf16
            y = stem(x.to(dt).reshape(b, d, h, w, 1).contiguous(),
                     dhwio(self.conv1.weight).to(dt), scale, shift,
                     relu=True)
        else:
            y = F.conv3d(x.to(dt), self.conv1.weight.to(dt), padding=3)
            y = _ndhwc(F.relu(self.bn1(y.float())).to(dt))
        return pool(y).permute(0, 4, 1, 2, 3)  # channels_last NCDHW view

    def train_stem(self, x):
        """The stem where a gradient is wanted: the library conv (its
        backward the matrix products of ``stem_conv_diff``), bn1, ReLU and
        the differentiable pool (K3, K7)."""
        dt = self.compute_dtype
        xs, w = x.to(dt), self.conv1.weight.to(dt)
        conv = (stem_conv_diff(xs, w) if self.use_kernels and x.shape[1] == 1
                else F.conv3d(xs, w, padding=3))
        # bn1 on the f32 widening, the ReLU's output in the model's type
        # (the reference's StemS2D: statistics of an f32 conv output)
        y = _ndhwc(F.relu(self.bn1(conv.float())).to(dt))
        pool = (maxpool3d_k3s2p1_diff if self.use_kernels
                else maxpool3d_k3s2p1_ref)
        return pool(y).permute(0, 4, 1, 2, 3)

    def library_stem(self, x):
        """The JAX package's other stem: a (t, 7, 7) conv at stride
        (t_stride, 1, 1), SAME padding, in the model's type; bn1 (f32 out,
        as flax's), ReLU; ``F.max_pool3d(3, 2, 1)`` unless
        ``no_max_pool``."""
        dt = self.compute_dtype
        pads = [same_pads(n, k, s) for n, k, s in zip(
            x.shape[2:], self.conv1.kernel_size, self.conv1.stride)]
        xp = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        y = F.conv3d(xp.to(dt), self.conv1.weight.to(dt), None,
                     self.conv1.stride)
        y = F.relu(bn(self.bn1, y))
        return y if self.no_max_pool else F.max_pool3d(y, 3, 2, 1)

    def forward(self, x):
        tracing.stage("stage.trunk")
        x = self.stem(x)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            if self.remat:
                for block in layer:
                    x = remat(block, x)
            else:
                x = layer(x)
        tracing.stage("stage.head")
        return self.head(x)


def build_posenet3d(device="cuda", seed: int = 0, **kwargs) -> PoseNet3D:
    """The eval-mode ``PoseNet3D(**kwargs)`` in ``torch.channels_last_3d``
    on ``device`` (the GPU by default; raises without one unless
    ``device="cpu"``), with the JAX package's initialisers from ``seed``;
    TF32 off for a GPU, as ``build_nlospose`` sets it."""
    from hiddenpose_tpu_torch.models.nlospose import init_weights

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = PoseNet3D(**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(memory_format=torch.channels_last_3d)
    return model.to(device).eval()
