"""Per-sample, per-channel min/max normalisation.

Port of ``hiddenpose_tpu/ops/normalize.py``.  eps is 1e-15, and the
reference's no-op ReLU quirk is kept: its ``nn.ReLU()(data)`` discards the
result, so ``normalize_feature`` applies no ReLU.
"""

from __future__ import annotations

import torch


def _minmax_scale(flat: torch.Tensor, dim: int) -> torch.Tensor:
    lo = flat.amin(dim=dim, keepdim=True)
    hi = flat.amax(dim=dim, keepdim=True)
    return (flat - lo) / (hi - lo + 1e-15)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Min/max-normalise to [0, 1] per (batch, channel); x (B, C, ...)."""
    b, c = x.shape[:2]
    return _minmax_scale(x.reshape(b, c, -1), 2).reshape(x.shape)


def normalize_feature(x: torch.Tensor) -> torch.Tensor:
    """``normalize`` then x10 (no ReLU: the reference's is a no-op)."""
    return normalize(x) * 10.0


def normalize_last(x: torch.Tensor) -> torch.Tensor:
    """Channels-last variant: x (B, ..., C), normalised per (batch, C)."""
    b, c = x.shape[0], x.shape[-1]
    return _minmax_scale(x.reshape(b, -1, c), 1).reshape(x.shape)


def normalize_feature_last(x: torch.Tensor) -> torch.Tensor:
    return normalize_last(x) * 10.0
