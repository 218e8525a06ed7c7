"""Deterministic synthetic NLOS captures, for smoke runs and tests.

A copy of ``hiddenpose_tpu/data/synthetic.py::make_sample`` and
``make_batch`` (numpy only),
so the port needs no dataset and no JAX package: a stick-figure "person"
of SMPL-like joints rendered into a confocal transient, each scatterer on
a bone an ellipsoid shell at t = 2*dist/bin_len.  The two copies give
identical arrays (``tests/test_torch_config_data.py``).

meas (1, T, H, W), vol (1, D, H, W), joints (J, 3) in heatmap-voxel units;
a batch stacks them and adds ``joints_vis``, all ones.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# SMPL 24-joint skeleton (parent index per joint)
SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21]
)

SMPL_REST_POSE = np.asarray([
    [0.0, -0.2, 0.0], [0.07, -0.30, 0.0], [-0.07, -0.30, 0.0],
    [0.0, -0.08, 0.0], [0.10, -0.55, 0.0], [-0.10, -0.55, 0.0],
    [0.0, 0.04, 0.0], [0.09, -0.80, 0.02], [-0.09, -0.80, 0.02],
    [0.0, 0.10, 0.0], [0.11, -0.86, 0.12], [-0.11, -0.86, 0.12],
    [0.0, 0.25, -0.02], [0.08, 0.18, 0.0], [-0.08, 0.18, 0.0],
    [0.0, 0.33, 0.02], [0.18, 0.22, 0.0], [-0.18, 0.22, 0.0],
    [0.40, 0.20, 0.0], [-0.40, 0.20, 0.0], [0.60, 0.18, 0.0],
    [-0.60, 0.18, 0.0], [0.68, 0.16, 0.0], [-0.68, 0.16, 0.0],
], dtype=np.float64)


def sample_pose(rng: np.random.RandomState, jitter: float = 0.05) -> np.ndarray:
    """Jittered rest pose in the normalised scene frame ([-1, 1]-ish)."""
    pose = SMPL_REST_POSE + rng.randn(24, 3) * jitter
    # random depth placement in front of the wall
    pose = pose * 0.6
    pose[:, 2] += rng.uniform(-0.3, 0.1)
    return pose


def _bone_points(joints: np.ndarray, per_bone: int = 6) -> np.ndarray:
    """Sample scatterer points along the skeleton's bones."""
    pts = [joints]
    for j, p in enumerate(SMPL_PARENTS):
        if p < 0:
            continue
        t = np.linspace(0.0, 1.0, per_bone + 2)[1:-1, None]
        pts.append(joints[p] * (1 - t) + joints[j] * t)
    return np.concatenate(pts, axis=0)


def render_transient(
    scatterers: np.ndarray,
    time_size: int,
    image_size: int,
    bin_len: float,
    wall_size: float = 2.0,
) -> np.ndarray:
    """Confocal transient (T, H, W): shell at t = 2*dist/bin_len per point,
    with 1/r^4 falloff (the diffuse model the LCT's z^4 grid undoes)."""
    n = image_size
    wall = np.stack(
        np.meshgrid(
            np.linspace(-wall_size / 2, wall_size / 2, n),
            np.linspace(-wall_size / 2, wall_size / 2, n),
            indexing="ij",
        ),
        axis=-1,
    )  # (H, W, 2): (y, x)
    meas = np.zeros((time_size, n, n), dtype=np.float32)
    # scene frame: (x, y) in wall plane, z depth in front of the wall (>0)
    sx, sy, sz = scatterers[:, 0], scatterers[:, 1], scatterers[:, 2]
    depth = np.clip(sz + 0.8, 0.05, None)  # shift scene in front of wall
    for k in range(scatterers.shape[0]):
        d2 = (wall[..., 1] - sx[k]) ** 2 + (wall[..., 0] - sy[k]) ** 2
        dist = np.sqrt(d2 + depth[k] ** 2)
        tof = 2.0 * dist / bin_len
        t0 = np.floor(tof).astype(np.int64)
        frac = (tof - t0).astype(np.float32)
        amp = (1.0 / (dist ** 4 + 1e-3)).astype(np.float32)
        for dt, w in ((0, 1.0 - frac), (1, frac)):
            tt = t0 + dt
            valid = tt < time_size
            np.add.at(
                meas,
                (tt[valid], *np.nonzero(valid)),
                (amp * w)[valid],
            )
    if meas.max() > 0:
        meas /= meas.max()
    return meas


def voxelize(
    scatterers: np.ndarray, grid: int, wall_size: float = 2.0
) -> np.ndarray:
    """Binary occupancy volume (D, H, W) of the scatterers."""
    vol = np.zeros((grid, grid, grid), dtype=np.float32)
    half = wall_size / 2
    d = np.clip(((scatterers[:, 2] + 0.8) / wall_size * grid).astype(int), 0, grid - 1)
    h = np.clip(((half - scatterers[:, 1]) / wall_size * grid).astype(int), 0, grid - 1)
    w = np.clip(((scatterers[:, 0] + half) / wall_size * grid).astype(int), 0, grid - 1)
    vol[d, h, w] = 1.0
    return vol


def map_joints_to_heatmap(
    joints: np.ndarray,
    vol_size: int = 256,
    heatmap_size: int = 64,
) -> np.ndarray:
    """SMPL joints in normalised scene coords -> heatmap-voxel (d, h, w):
    affine map to the 256-voxel grid (x*128+128, 256-(y*128+128),
    225-(z*128+128)), permute (x, y, z) -> (d, h, w), divide by the
    vol/heatmap ratio."""
    j = np.asarray(joints, dtype=np.float64).copy()
    x = j[:, 0] * 128 + 128
    y = 256 - (j[:, 1] * 128 + 128)
    z = 225 - (j[:, 2] * 128 + 128)
    out = np.stack([z, y, x], axis=1)  # (d, h, w)
    return (out / (vol_size / heatmap_size)).astype(np.float32)


def make_sample(
    seed: int,
    time_size: int = 128,
    image_size: int = 128,
    grid: int = 128,
    heatmap_size: int = 64,
    bin_len: float = 0.04,
) -> Dict[str, np.ndarray]:
    """One deterministic (meas, vol, joints) sample."""
    rng = np.random.RandomState(seed)
    pose = sample_pose(rng)
    scatterers = _bone_points(pose)
    meas = render_transient(scatterers, time_size, image_size, bin_len)
    vol = voxelize(scatterers, grid)
    # Reference scaling (vol 256 / heatmap 64) rescaled linearly for
    # non-reference grids.
    joints_hm = map_joints_to_heatmap(pose) * (heatmap_size / 64.0)
    return {
        "meas": meas[None].astype(np.float32),
        "vol": vol[None].astype(np.float32),
        "joints": joints_hm.astype(np.float32),
        "person_id": f"synthetic-{seed}",
    }


def make_batch(
    seeds, time_size=128, image_size=128, grid=128, heatmap_size=64,
    bin_len=0.04,
) -> Dict[str, np.ndarray]:
    """The samples of ``seeds`` stacked into one training batch: meas
    (B, 1, T, H, W), vol (B, 1, D, H, W), joints and joints_vis (B, J*3)."""
    samples = [
        make_sample(s, time_size, image_size, grid, heatmap_size, bin_len)
        for s in seeds
    ]
    return {
        "meas": np.stack([s["meas"] for s in samples]),
        "vol": np.stack([s["vol"] for s in samples]),
        "joints": np.stack([s["joints"] for s in samples]).reshape(
            len(samples), -1
        ),
        "joints_vis": np.ones((len(samples), 72), np.float32),
    }
