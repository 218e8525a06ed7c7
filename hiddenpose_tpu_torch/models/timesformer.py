"""Generic TimeSformer (divided space-time attention video transformer).

Port of ``hiddenpose_tpu/models/timesformer.py``: patch embed + one cls
token, per layer (time attention -> spatial attention -> GEGLU FF, all
pre-normed residual), optional token shift before each sub-layer, head
LayerNorm + Linear on the cls token -> ``num_classes`` outputs (24*3 joints
by default).

Shares :class:`hiddenpose_tpu_torch.models.sformer.JointTokenAttention`
(``num_summary=1``: the cls token) and the rotary tables.  It is the caller
that always runs the ``over='time'`` grouping (groups b*h*n, Lq = f,
Lk = f + 1) through the attention kernel K9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hiddenpose_tpu_torch.models.sformer import (
    LN_EPS,
    Dense,
    _cat,
    _Transformer,
    as_dtype,
    finish_build,
    patchify,
)


def token_shift(x: torch.Tensor, f: int, n: int,
                num_summary: int = 1) -> torch.Tensor:
    """Temporal token shift: split channels in thirds, one third from the
    previous frame, one from the next, one unshifted.  Summary tokens pass
    through."""
    summary, patches = x[:, :num_summary], x[:, num_summary:]
    b, _, d = x.shape
    p = patches.reshape(b, f, n, d)
    c = d // 3
    # F.pad pads from the last dim backwards: (d, d, n, n, f_front, f_back)
    back = F.pad(p[:, :-1, :, :c], (0, 0, 0, 0, 1, 0))
    fwd = F.pad(p[:, 1:, :, c:2 * c], (0, 0, 0, 0, 0, 1))
    shifted = torch.cat([back, fwd, p[..., 2 * c:]], dim=-1)
    return torch.cat([summary, shifted.reshape(b, f * n, d)], dim=1)


class TimeSformer(_Transformer):
    def __init__(self, dim: int = 256, num_frames: int = 16,
                 num_classes: int = 24 * 3, image_size: int = 224,
                 patch_size: int = 16, channels: int = 3, depth: int = 12,
                 heads: int = 8, dim_head: int = 64, rotary_emb: bool = True,
                 shift_tokens: bool = False, dtype=torch.float32):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dim, self.depth, self.dim_head = dim, depth, dim_head
        self.patch_size, self.rotary_emb = patch_size, rotary_emb
        self.shift_tokens = shift_tokens
        self.compute_dtype = dtype

        self.patch_embed = Dense(patch_size * patch_size * channels, dim,
                                 dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        if not rotary_emb:
            n = (image_size // patch_size) ** 2
            self.pos_emb = nn.Parameter(
                torch.zeros(1, 1 + num_frames * n, dim))
        self._build_layers(dim, depth, heads, dim_head, 1, True, dtype)
        self.out_ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.out_proj = Dense(dim, num_classes, dtype=dtype)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video: (b, f, c, h, w) -> (b, num_classes)."""
        b, f, c, h, w = video.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        n = hp * wp

        tokens = self.patch_embed(patchify(video, p))
        x = _cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)

        frame_rot, image_rot = self._tables(f, hp, wp, video.device)
        if not self.rotary_emb:
            x = x + self.pos_emb

        def shift(t):
            return token_shift(t, f, n) if self.shift_tokens else t

        for i in range(self.depth):
            x = x + getattr(self, f"time_attn_{i}")(
                shift(getattr(self, f"time_ln_{i}")(x)),
                f=f, n=n, over="time", rot=frame_rot)
            x = x + getattr(self, f"spatial_attn_{i}")(
                shift(getattr(self, f"spatial_ln_{i}")(x)),
                f=f, n=n, over="space", rot=image_rot)
            x = x + getattr(self, f"ff_{i}")(
                shift(getattr(self, f"ff_ln_{i}")(x)))

        return self.out_proj(self.out_ln(x[:, 0]))


def build_timesformer(device="cuda", seed: int = 0, **kwargs) -> TimeSformer:
    """The eval-mode ``TimeSformer(**kwargs)`` on ``device`` (the GPU by
    default; raises without one unless ``device="cpu"``) with random
    weights from ``seed``."""
    return finish_build(TimeSformer(**kwargs), device, seed)
