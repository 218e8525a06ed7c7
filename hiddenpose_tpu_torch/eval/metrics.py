"""Evaluation metrics (port of ``hiddenpose_tpu/eval/metrics.py``).

The reference computes no numeric accuracy metric; these are the standard
3D pose metrics over heatmap-voxel coordinates, in float64 numpy.
"""

from __future__ import annotations

import numpy as np


def _to_bj3(x) -> np.ndarray:
    """Coerce (J*3,), (B, J*3), (J, 3) or (B, J, 3) -> (B, J, 3)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    if x.shape[-1] != 3:
        x = x.reshape(x.shape[0], -1, 3)
    if x.ndim == 2:
        x = x[None]
    return x


def mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean per-joint position error.  pred/gt: (..., J, 3) or (..., J*3)."""
    pred, gt = _to_bj3(pred), _to_bj3(gt)
    return float(np.linalg.norm(pred - gt, axis=-1).mean())


def pa_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Procrustes-aligned MPJPE (per-sample similarity alignment)."""
    pred, gt = _to_bj3(pred), _to_bj3(gt)
    errs = []
    for p, g in zip(pred, gt):
        p0 = p - p.mean(0)
        g0 = g - g.mean(0)
        u, s, vt = np.linalg.svd(p0.T @ g0)
        r = (u @ vt).T
        if np.linalg.det(r) < 0:
            vt[-1] *= -1
            r = (u @ vt).T
        scale = s.sum() / (p0 ** 2).sum()
        aligned = scale * p0 @ r.T + g.mean(0)
        errs.append(np.linalg.norm(aligned - g, axis=-1).mean())
    return float(np.mean(errs))


def pck(pred: np.ndarray, gt: np.ndarray, threshold: float) -> float:
    """Share of joints within ``threshold`` voxels."""
    pred, gt = _to_bj3(pred), _to_bj3(gt)
    d = np.linalg.norm(pred - gt, axis=-1)
    return float((d < threshold).mean())
