"""Rotary position embeddings (1D temporal + 2D axial).

Port of ``hiddenpose_tpu/models/rotary.py``: the sin/cos tables are pure
functions of static shapes, computed on the host in float64 and kept as
float32 constants.  Each table is built once per (shape, head dim, device)
and cached, not once per forward.

* 1D: inv_freq_i = 10000^(-2i/d); table = outer(positions, inv_freqs) with
  each frequency duplicated pairwise along the feature axis -> (1, n, d).
  (The JAX package's layout, a true rotation under
  :func:`rotate_every_two`; it deliberately differs from the reference
  PyTorch model's cat(f, f), see the JAX module's note.)
* Axial: per-axis logspace scales (dim // 4 of them, base 2, up to
  max_freq / 2), positions linspace(-1, 1) scaled by pi; the two axes
  concatenated, then each element duplicated -> (1, h*w, d).
* :func:`apply_rotary` rotates the leading ``rot_dim`` features of q and k
  and passes the rest through.  The tables are float32, so bfloat16 q and k
  come out float32, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k) -> pairs (x1, x2) -> (-x2, x1) interleaved back."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _duplicate_pairs(t: np.ndarray) -> np.ndarray:
    """(..., d) -> (..., 2d) with each feature repeated twice."""
    return np.repeat(t, 2, axis=-1)


def _tables(sin: np.ndarray, cos: np.ndarray, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    # made outside inference mode: a table first built by a serving forward
    # (``serve_video`` runs under ``torch.inference_mode``) is cached and
    # then also read by forwards that autograd records, which refuse
    # inference tensors
    with torch.inference_mode(False):
        return (torch.from_numpy(sin.astype(np.float32)).to(device),
                torch.from_numpy(cos.astype(np.float32)).to(device))


@functools.lru_cache(maxsize=None)
def _rotary_1d(n: int, dim: int, device: str):
    inv_freqs = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(n, dtype=np.float64), inv_freqs)
    freqs = _duplicate_pairs(freqs)[None]
    return _tables(np.sin(freqs), np.cos(freqs), device)


@functools.lru_cache(maxsize=None)
def _rotary_axial(h: int, w: int, dim: int, max_freq: float, device: str):
    n_scales = dim // 4
    scales = np.logspace(
        0.0, math.log(max_freq / 2) / math.log(2), n_scales, base=2,
        dtype=np.float64)
    h_seq = np.linspace(-1.0, 1.0, h)[:, None] * scales[None] * math.pi
    w_seq = np.linspace(-1.0, 1.0, w)[:, None] * scales[None] * math.pi
    x_sinu = np.broadcast_to(h_seq[:, None, :], (h, w, n_scales))
    y_sinu = np.broadcast_to(w_seq[None, :, :], (h, w, n_scales))
    sin = np.concatenate([np.sin(x_sinu), np.sin(y_sinu)], axis=-1)
    cos = np.concatenate([np.cos(x_sinu), np.cos(y_sinu)], axis=-1)
    sin = _duplicate_pairs(sin.reshape(h * w, -1))[None]
    cos = _duplicate_pairs(cos.reshape(h * w, -1))[None]
    return _tables(sin, cos, device)


def rotary_1d(n: int, dim: int, device="cpu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal rotary table: (sin, cos), each (1, n, dim) float32."""
    return _rotary_1d(int(n), int(dim), str(torch.device(device)))


def rotary_axial(h: int, w: int, dim: int, max_freq: float = 10.0,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """2D axial rotary table over an h x w patch grid: (sin, cos), each
    (1, h*w, dim) float32."""
    return _rotary_axial(int(h), int(w), int(dim), float(max_freq),
                         str(torch.device(device)))


def apply_rotary(q: torch.Tensor, k: torch.Tensor,
                 rot: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate the leading rot_dim features of q/k; pass the tail through."""
    sin, cos = rot
    rot_dim = sin.shape[-1]

    def rot_fn(t):
        t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
        t_rot = t_rot * cos + rotate_every_two(t_rot) * sin
        if t_pass.shape[-1] == 0:
            return t_rot
        # jnp.concatenate promotes: a float32 rotated head and a bfloat16
        # tail give float32
        dtype = torch.promote_types(t_rot.dtype, t_pass.dtype)
        return torch.cat([t_rot.to(dtype), t_pass.to(dtype)], dim=-1)

    return rot_fn(q), rot_fn(k)
