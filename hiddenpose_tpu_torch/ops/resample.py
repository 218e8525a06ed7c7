"""Multi-view volume re-rendering (grid rotation and trilinear sampling).

Port of ``hiddenpose_tpu/ops/resample.py``: the 26 view rotations
(identity and 25 Fibonacci-sphere directions), trilinear sampling of a
volume at normalised (x, y, z) coordinates with zero padding, and the
reference's optional multi-view resampler (a z-crop grid, then one
rotated grid per batch element).  :func:`grid_sample_3d` is
``F.grid_sample(mode="bilinear", padding_mode="zeros")``, which samples
as the JAX package's ``map_coordinates(order=1, mode="constant")`` does:
a corner outside the volume weighs 0, inside or on the border and
outside [-1, 1] alike.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch import resolve_device


def _rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    a = axis / np.linalg.norm(axis)
    K = np.array([
        [0, -a[2], a[1]],
        [a[2], 0, -a[0]],
        [-a[1], a[0], 0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def view_rotations(trans: bool = False) -> np.ndarray:
    """(26, 3, 3) float32: the identity and 25 Fibonacci-sphere view
    rotations (each transposed with ``trans``)."""
    mats = [np.eye(3)]
    samplenum = 25
    ratio = 0.5
    sam2 = int(samplenum / ratio / ratio)
    sambe = sam2 - samplenum
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    for i in range(samplenum):
        n = sambe + i + 1.0
        N = sam2 + 1.0
        zn = n / N
        r = np.sqrt(1 - zn * zn)
        angle = 2.0 * np.pi * n * phi
        new_axis = np.array([r * np.cos(angle), r * np.sin(angle), zn])
        rot_axis = np.cross([0.0, 0.0, 1.0], new_axis)
        theta = np.arccos(zn)
        m = _rodrigues(rot_axis, theta)
        mats.append(m.T if trans else m)
    return np.asarray(mats, dtype=np.float32)


def normalized_grid(d: int, h: int, w: int, align_corners: bool
                    ) -> np.ndarray:
    """(D, H, W, 3) float32 grid of (x, y, z) in [-1, 1]: ``affine_grid``
    of the identity."""
    def axis(n):
        if align_corners:
            return np.linspace(-1.0, 1.0, n, dtype=np.float64)
        return (2 * np.arange(n, dtype=np.float64) + 1) / n - 1

    z, y, x = np.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """vol (B, C, D, H, W), grid (B, D', H', W', 3) of (x, y, z) in [-1, 1]
    -> (B, C, D', H', W'), trilinear, zero padding."""
    return F.grid_sample(vol, grid.to(vol.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=align_corners)


class MultiViewResampler:
    """Re-render an LCT volume from other viewpoints.  The grids are
    device constants, made on the host and moved to ``device`` (the GPU by
    default; raises without one unless ``device="cpu"``)."""

    def __init__(self, spatial: int, tdim: int, trange: float,
                 wall_size: float = 2.0, align_corners: bool = False,
                 device="cuda"):
        device = resolve_device(device)
        self.align_corners = align_corners
        self.rotations = view_rotations(False)
        base = normalized_grid(tdim, spatial, spatial, align_corners)

        # each rotation conjugated by diag(1, -1, -1): the reference's
        # sign flips before and after the rotation
        s = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        view_grids = np.stack([base @ (s @ m @ s) for m in self.rotations])

        # the z-crop grid: z compressed by (trange / 2) / wall_size
        zc = base.copy()
        z01 = (zc[..., 2] + 1) / 2
        zc[..., 2] = z01 / ((trange / 2) / wall_size) * 2 - 1
        self.view_grids = torch.from_numpy(view_grids).to(device)
        self.zcrop_grid = torch.from_numpy(zc).to(device)

    def __call__(self, vol: torch.Tensor, views: Sequence[int]
                 ) -> torch.Tensor:
        """vol (B, C, T, H, W); one view index per batch element."""
        b = vol.shape[0]
        zg = self.zcrop_grid[None].expand(b, *self.zcrop_grid.shape)
        volz = grid_sample_3d(vol, zg, self.align_corners)
        vg = self.view_grids[torch.as_tensor(list(views), dtype=torch.long)]
        return grid_sample_3d(volz, vg, self.align_corners)
