"""TokenPose: the 2D keypoint transformer that the 2D-heatmap objective
trains.

Port of ``hiddenpose_tpu/models/tokenpose.py`` (TokenPose_L): a feature
map (B, C, H, W) is cut into patches and embedded, ``num_keypoints``
learnable keypoint tokens go in front, THREE stacked transformers of
``depth`` layers each run (in the 'sine-full' mode the sine table is added
again to the patch tokens before every layer after a stage's first), and
the keypoint tokens of the three stages, concatenated, go through a
LayerNorm + Linear head to one heatmap each (``heatmap_size``).

Numerics follow flax where it differs from PyTorch's defaults: LayerNorm
eps 1e-6, the tanh form of GELU, scores scaled by ``dh ** -0.5`` after the
product, the sine table built in float64 and cast to float32.  The head's
hidden layer is taken only when ``dim * 3 <= hidden_heatmap_dim * 0.5``
(not at the published dim 192, hidden 384).

Module names are the flax tree's joined by dots (``transformer1.attn_0.
to_qkv.weight``, ``head_out.weight``), so ``utils/jax_bridge.py``'s walk
of the tree carries weights both ways.  No kernel runs here: every op is a
library call.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.models.sformer import LN_EPS, finish_build

POS_EMBEDDING_TYPES = ("sine-full", "sine", "learnable", "none")


def sine_position_embedding(h: int, w: int, d_model: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """DETR-style 2D sine table, (1, h*w, d_model) float32 (built in
    float64)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float64)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale

    half = d_model // 2
    dim_t = np.arange(half, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])],
                        axis=-1).reshape(h, w, -1)

    pos = np.concatenate([interleave(pos_y), interleave(pos_x)], axis=-1)
    return pos.reshape(1, h * w, d_model).astype(np.float32)


class TokenAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8,
                 scale_with_head: bool = True):
        super().__init__()
        self.heads = heads
        dh = dim // heads
        self.scale = dh ** -0.5 if scale_with_head else dim ** -0.5
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, dim = x.shape
        h = self.heads
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, dim // h).transpose(1, 2)
                   for t in (q, k, v))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, dim)
        return self.to_out(out)


class TokenTransformer(nn.Module):
    """``depth`` x (pre-LayerNorm attention + pre-LayerNorm GELU MLP),
    each with a residual; with ``all_attn`` the position table is added
    to the patch tokens again before every layer but the first."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 num_keypoints: int, all_attn: bool = True):
        super().__init__()
        self.depth, self.num_keypoints = depth, num_keypoints
        self.all_attn = all_attn
        for i in range(depth):
            setattr(self, f"attn_{i}", TokenAttention(dim, heads))
            setattr(self, f"ln_a_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"ln_f_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            setattr(self, f"mlp_in_{i}", nn.Linear(dim, mlp_dim))
            setattr(self, f"mlp_out_{i}", nn.Linear(mlp_dim, dim))

    def forward(self, x, pos):
        k = self.num_keypoints
        for i in range(self.depth):
            if i > 0 and self.all_attn and pos is not None:
                x = torch.cat([x[:, :k], x[:, k:] + pos], dim=1)
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln_a_{i}")(x))
            y = getattr(self, f"mlp_in_{i}")(getattr(self, f"ln_f_{i}")(x))
            y = getattr(self, f"mlp_out_{i}")(F.gelu(y, approximate="tanh"))
            x = x + y
        return x


class TokenPose(nn.Module):
    """feature (B, C, H, W) -> heatmaps (B, num_keypoints, *heatmap_size)."""

    def __init__(self, feature_size: Tuple[int, int] = (64, 64),
                 patch_size: Tuple[int, int] = (4, 4),
                 num_keypoints: int = 24, dim: int = 192,
                 channels: int = 128, depth: int = 2, heads: int = 8,
                 mlp_ratio: int = 3, hidden_heatmap_dim: int = 384,
                 heatmap_size: Tuple[int, int] = (64, 64),
                 pos_embedding_type: str = "sine-full"):
        super().__init__()
        if pos_embedding_type not in POS_EMBEDDING_TYPES:
            raise ValueError(f"pos_embedding_type must be one of "
                             f"{POS_EMBEDDING_TYPES}, got "
                             f"{pos_embedding_type!r}")
        self.patch_size = tuple(patch_size)
        self.num_keypoints = num_keypoints
        self.heatmap_size = tuple(heatmap_size)
        self.pos_embedding_type = pos_embedding_type
        ph, pw = patch_size
        hp, wp = feature_size[0] // ph, feature_size[1] // pw
        n = hp * wp
        self.patch_embed = nn.Linear(ph * pw * channels, dim)
        self.keypoint_token = nn.Parameter(torch.zeros(1, num_keypoints, dim))
        if pos_embedding_type in ("sine", "sine-full"):
            self.register_buffer("pos", torch.from_numpy(
                sine_position_embedding(hp, wp, dim)), persistent=False)
        elif pos_embedding_type == "learnable":
            self.pos_embedding = nn.Parameter(
                torch.zeros(1, n + num_keypoints, dim))
        all_attn = pos_embedding_type == "sine-full"
        for s in range(3):
            setattr(self, f"transformer{s + 1}", TokenTransformer(
                dim, depth, heads, dim * mlp_ratio, num_keypoints,
                all_attn=all_attn))
        self.head_ln = nn.LayerNorm(dim * 3, eps=LN_EPS)
        self.hidden = dim * 3 <= hidden_heatmap_dim * 0.5
        head_in = dim * 3
        if self.hidden:
            self.head_hidden = nn.Linear(dim * 3, hidden_heatmap_dim)
            self.head_ln2 = nn.LayerNorm(hidden_heatmap_dim, eps=LN_EPS)
            head_in = hidden_heatmap_dim
        self.head_out = nn.Linear(head_in,
                                  heatmap_size[0] * heatmap_size[1])

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, c, fh, fw = feature.shape
        ph, pw = self.patch_size
        hp, wp = fh // ph, fw // pw
        n = hp * wp
        x = feature.reshape(b, c, hp, ph, wp, pw)
        x = x.permute(0, 2, 4, 3, 5, 1).reshape(b, n, ph * pw * c)
        x = self.patch_embed(x)
        kp = self.keypoint_token.expand(b, -1, -1)

        pos = None
        if self.pos_embedding_type in ("sine", "sine-full"):
            pos = self.pos[:, :n]
            x = torch.cat([kp, x + pos], dim=1)
        elif self.pos_embedding_type == "learnable":
            x = torch.cat([kp, x], dim=1) + self.pos_embedding
        else:
            x = torch.cat([kp, x], dim=1)

        all_attn = self.pos_embedding_type == "sine-full"
        outs = []
        for s in range(3):
            x = getattr(self, f"transformer{s + 1}")(
                x, pos if all_attn else None)
            outs.append(x[:, :self.num_keypoints])

        y = self.head_ln(torch.cat(outs, dim=2))  # (B, K, 3 * dim)
        if self.hidden:
            y = self.head_ln2(self.head_hidden(y))
        y = self.head_out(y)
        return y.reshape(b, self.num_keypoints, *self.heatmap_size)


def build_tokenpose(device=None, seed: int = 0, **kwargs) -> TokenPose:
    """A TokenPose (``kwargs`` as :class:`TokenPose`'s, the JAX package's
    defaults otherwise) on ``device`` (the GPU when None; raises without
    one unless ``device="cpu"``) with random weights from ``seed`` (flax's
    initialisers, ``models/sformer.py::init_transformer_weights``), in
    eval mode, TF32 off on a GPU (a train step's ``matmul_precision`` sets
    it for the step)."""
    return finish_build(TokenPose(**kwargs), device, seed)
