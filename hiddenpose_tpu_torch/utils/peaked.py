"""Seeded random weights that make peaked heatmaps and peaked SimDR logits.

The reference initialisation (``models/nlospose.py::init_weights``) gives
near-uniform heatmaps: every joint sits at the volume centre whatever the
backbone computed, so a comparison of joints would pass a wrong model.
These weights keep activations at unit scale through the network (fan-in
scaled convs, random norm affines and BatchNorm statistics) so the
heatmaps are peaked and the joints spread over the volume.  Tests and the
GPU smoke run use them to hold the port against its references.
:func:`peaked_transformer_state_dict` is the recipe for the transformer
family (peaked attention rows and SimDR logits).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

# Gains of the transformer recipe.  Constants, not options: every
# kernels-vs-plain and port-vs-JAX comparison is read at these values.
QK_GAIN = 2.0
HEAD_GAIN = 8.0
# The posenet2d head's final conv: its inputs are BatchNorm + ReLU outputs
# of unit scale, so fan-in scaled weights give logits of unit spread over
# the J x depth x h x w map, whose soft-argmax sits near the centre; this
# gain peaks them.
HEAD2D_GAIN = 8.0


@torch.no_grad()
def peaked_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A CPU state_dict for ``model`` (names and shapes only are read, so
    a model on the meta device will do), from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    # a k4 s2 transposed conv sums 2^3 (3D) or 2^2 (2D) taps of each
    # input channel
    taps = {f"{name}.weight": 8 if isinstance(m, nn.ConvTranspose3d) else 4
            for name, m in model.named_modules()
            if isinstance(m, (nn.ConvTranspose3d, nn.ConvTranspose2d))}
    sd = {}
    for name, t in model.state_dict().items():
        shape = t.shape
        if not t.is_floating_point():  # BN num_batches_tracked
            v = torch.zeros(shape, dtype=t.dtype)
        elif name.endswith("running_var"):
            v = 0.5 + 0.5 * torch.rand(shape, generator=g)
        elif name.endswith("running_mean") or name.endswith("bias"):
            v = 0.1 * torch.randn(shape, generator=g)
        elif t.dim() == 1:  # norm weights
            v = 1.0 + 0.1 * torch.randn(shape, generator=g)
        else:  # conv weights, fan-in scaled
            fan_in = shape[0] * taps[name] if name in taps else t[0].numel()
            v = torch.randn(shape, generator=g) * fan_in ** -0.5
            if name == "pose_net.head.final.weight" and t.dim() == 4:
                v *= HEAD2D_GAIN
        sd[name] = v
    return sd


@torch.no_grad()
def peaked_transformer_state_dict(model: nn.Module,
                                  seed: int) -> Dict[str, torch.Tensor]:
    """A CPU state_dict for an ``NlosPoseSformer``, ``TimeSformer`` or
    ``TokenPose`` (names and shapes only are read), from ``seed``.

    With flax's initialisers the attention rows are near-uniform and the
    SimDR logits near-flat: every joint decodes to the middle bin whatever
    q, k or the rotary tables are.  Here the q and k rows of every
    ``to_qkv`` are fan-in scaled times ``QK_GAIN`` (scores of spread
    ``QK_GAIN ** 2``: peaked softmax rows), ``out_proj`` times
    ``HEAD_GAIN`` (peaked logits; TokenPose's ``head_out``, whose flax
    initialiser puts every heatmap near flat, likewise), the summary
    tokens and the position embedding have unit and half-unit scale, and
    biases and LayerNorm affines are random."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = t.shape
        if name in ("joints_token", "cls_token", "keypoint_token"):
            v = torch.randn(shape, generator=g)
        elif name in ("pos_emb", "pos_embedding"):
            v = 0.5 * torch.randn(shape, generator=g)
        elif name.endswith("bias"):
            v = 0.1 * torch.randn(shape, generator=g)
        elif t.dim() == 1:  # LayerNorm weights
            v = 1.0 + 0.1 * torch.randn(shape, generator=g)
        else:  # Linear weights (out, in), fan-in scaled
            v = torch.randn(shape, generator=g) * shape[1] ** -0.5
            if name.endswith("to_qkv.weight"):
                v[: 2 * shape[0] // 3] *= QK_GAIN
            elif name in ("out_proj.weight", "head_out.weight"):
                v *= HEAD_GAIN
        sd[name] = v
    return sd
