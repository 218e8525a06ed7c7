"""Per-sample, per-channel min/max normalisation.

Port of ``hiddenpose_tpu/ops/normalize.py``.  eps is 1e-15, and the
reference's no-op ReLU quirk is kept: its ``nn.ReLU()(data)`` discards the
result, so ``normalize_feature`` applies no ReLU.
"""

from __future__ import annotations

import torch


def _tie_shares(hit: torch.Tensor) -> torch.Tensor:
    """The share of a min's or max's gradient that each element receives;
    ``hit`` (n, ...) marks the elements equal to the result along axis 0.
    The JAX package's variadic min/max reduce is differentiated through a
    tree (``lax._reduce_jvp``): the axis halved, the second half padded to
    the first's length and combined with it element-wise, until one is
    left; two equal values that meet split their share 0.5 / 0.5.
    (``amin`` / ``amax`` split it evenly over all the equal values.)"""
    halves = []
    while hit.shape[0] > 1:
        n1 = (hit.shape[0] + 1) // 2
        first, second = hit[:n1], hit[n1:]
        if second.shape[0] != n1:
            second = torch.cat([second, torch.zeros_like(second[:1])])
        halves.append((first, second, hit.shape[0]))
        hit = first | second
    share = torch.ones(hit.shape, device=hit.device)
    for first, second, m in reversed(halves):
        share = share * torch.where(first & second, 0.5, 1.0)
        share = torch.cat([share * first, (share * second)[:m - len(first)]])
    return share


class _MinMax(torch.autograd.Function):
    """(min, max) over ``dim``, kept, with the JAX package's gradient where
    the result is tied (``_tie_shares``); an untied one takes it all."""

    @staticmethod
    def forward(ctx, flat, dim):
        lo = flat.amin(dim=dim, keepdim=True)
        hi = flat.amax(dim=dim, keepdim=True)
        ctx.save_for_backward(flat, lo, hi)
        ctx.dim = dim
        return lo, hi

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        flat, lo, hi = ctx.saved_tensors
        dim = ctx.dim

        def routed(res, g):
            hit = flat == res
            if bool((hit.sum(dim, keepdim=True) > 1).any()):
                hit = _tie_shares(hit.movedim(dim, 0)).movedim(0, dim)
            return hit.to(g.dtype) * g

        return routed(lo, g_lo) + routed(hi, g_hi), None


def _minmax_scale(flat: torch.Tensor, dim: int) -> torch.Tensor:
    lo, hi = _MinMax.apply(flat, dim)
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
