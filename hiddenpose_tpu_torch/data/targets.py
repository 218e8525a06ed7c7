"""Supervision targets of the other objectives ('sa-simdr', '2DHeatmap',
'3DHeatmap-gaussian').

The port's own copy of ``hiddenpose_tpu/data/targets.py`` (numpy only),
so that the port runs where the JAX package is not installed; the same
arithmetic in the same order, so the outputs are bit for bit the JAX
package's:

* :func:`generate_sa_simdr`: per-axis 1D Gaussian classification targets,
  normalised by 1/(sigma sqrt(2 pi)), with a joint's weight zeroed when no
  part of its Gaussian lies in bounds;
* :func:`generate_gaussian_heatmap_2d`: per-joint 2D Gaussian maps;
* :func:`generate_gaussian_heatmap_3d`: the 3D analogue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _oob_weight(mu: np.ndarray, dims: np.ndarray, tmp: float) -> np.ndarray:
    """Zero the weight when no part of the Gaussian is in bounds."""
    ul = np.floor(mu - tmp)
    br = np.floor(mu + tmp + 1)
    oob = (ul >= dims[None, :]).any(axis=1) | (br < 0).any(axis=1)
    return (~oob).astype(np.float32)


def generate_sa_simdr(
    joints: np.ndarray,
    joints_vis: Optional[np.ndarray] = None,
    image_size: Tuple[int, int, int] = (64, 64, 128),
    split_ratio: float = 2.0,
    sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(J, 3) joints -> the three axes' targets (J, dim * split_ratio) and
    the weights (J, 1)."""
    j = np.asarray(joints, np.float64)
    n = j.shape[0]
    vis = np.ones((n, 3)) if joints_vis is None else np.asarray(joints_vis)
    dims = np.asarray([int(d * split_ratio) for d in image_size])

    w = vis[:, 0].astype(np.float32)
    w = w * _oob_weight(j, dims, sigma * 3)

    norm = 1.0 / (sigma * np.sqrt(2 * np.pi))
    outs = []
    for ax in range(3):
        grid = np.arange(dims[ax], dtype=np.float64)
        mu = j[:, ax:ax + 1] * split_ratio
        t = norm * np.exp(-((grid[None, :] - mu) ** 2) / (2 * sigma ** 2))
        t = t * (w[:, None] > 0.5)
        outs.append(t.astype(np.float32))
    return outs[0], outs[1], outs[2], w.reshape(n, 1)


def generate_gaussian_heatmap_2d(
    joints: np.ndarray,
    joints_vis: Optional[np.ndarray] = None,
    heatmap_size: Tuple[int, int] = (64, 64),
    sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(J, >=2) joints (x, y) -> (J, H, W) Gaussian maps and (J, 1)
    weights."""
    j = np.asarray(joints, np.float64)
    n = j.shape[0]
    vis = np.ones((n, 3)) if joints_vis is None else np.asarray(joints_vis)
    dims = np.asarray(heatmap_size[::-1])  # (w, h): bounds in x, y order

    w = vis[:, 0].astype(np.float32)
    w = w * _oob_weight(j[:, :2], dims, sigma * 3)

    xs = np.arange(heatmap_size[1], dtype=np.float64)
    ys = np.arange(heatmap_size[0], dtype=np.float64)
    gx = np.exp(-((xs[None, :] - j[:, 0:1]) ** 2) / (2 * sigma ** 2))
    gy = np.exp(-((ys[None, :] - j[:, 1:2]) ** 2) / (2 * sigma ** 2))
    target = gy[:, :, None] * gx[:, None, :]
    target = target * (w[:, None, None] > 0.5)
    return target.astype(np.float32), w.reshape(n, 1)


def generate_gaussian_heatmap_3d(
    joints: np.ndarray,
    joints_vis: Optional[np.ndarray] = None,
    heatmap_size: Tuple[int, int, int] = (64, 64, 64),
    sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(J, 3) joints in (d, h, w) voxel coordinates -> (J, D, H, W)
    Gaussians and (J, 1) weights."""
    j = np.asarray(joints, np.float64)
    n = j.shape[0]
    vis = np.ones((n, 3)) if joints_vis is None else np.asarray(joints_vis)
    dims = np.asarray(heatmap_size)

    w = vis[:, 0].astype(np.float32)
    w = w * _oob_weight(j, dims, sigma * 3)

    grids = [np.arange(d, dtype=np.float64) for d in heatmap_size]
    g = [np.exp(-((grids[ax][None, :] - j[:, ax:ax + 1]) ** 2)
                / (2 * sigma ** 2)) for ax in range(3)]
    target = (g[0][:, :, None, None] * g[1][:, None, :, None]
              * g[2][:, None, None, :])
    target = target * (w[:, None, None, None] > 0.5)
    return target.astype(np.float32), w.reshape(n, 1)
