"""The reference's qualitative figures.

Port of ``hiddenpose_tpu/viz/visualizer.py`` (``volume_log``,
``joints_log``, ``threeviews_log``, ``vis_3view``, ``plot_volume_html``):
host-side files only, with the JAX package's file names and the same
arrays drawn.  Volumes are (B, C, D, H, W) or (D, H, W), joints (J, 3)
in (d, h, w) order, as numpy arrays or tensors (moved to the host and
widened to float32).  matplotlib (and plotly for the HTML figure) is
imported where a figure is drawn: the GPU host has neither, and the
callers in ``train/loop.py`` and ``cli/test.py`` treat a figure as
best-effort, as the JAX loop does.  ``joints_log`` writes the joints'
``.txt`` before it draws, so the text survives a host without
matplotlib.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# SMPL skeleton bone links (parent -> child), as the reference draws them
SMPL_BONES = [
    (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8),
    (6, 9), (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15),
    (13, 16), (14, 17), (16, 18), (17, 19), (18, 20), (19, 21),
    (20, 22), (21, 23),
]

SMPL_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hand", "right_hand",
]


def host_array(x) -> np.ndarray:
    """A numpy array of ``x`` (a tensor is detached, moved to the host and
    widened to float32; numpy has no bfloat16)."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def _vol3d(x) -> np.ndarray:
    x = host_array(x)
    while x.ndim > 3:
        x = x[0]
    return x


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    _pyplot().close(fig)
    return path


def volume_projections(volume):
    """The three axis sums that :func:`volume_log` draws: front (over d),
    left (over h), top (over w)."""
    v = _vol3d(volume)
    return [v.sum(axis=axis) for axis in (0, 1, 2)]


def volume_log(volume, out_dir: str, name: str, step: int = 0,
               joints: Optional[np.ndarray] = None) -> str:
    """Axis-sum projections of a volume, the joints over them."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    titles = ["front (sum z)", "left (sum y)", "top (sum x)"]
    for ax, proj, title in zip(axes, volume_projections(volume), titles):
        ax.imshow(proj, cmap="hot")
        ax.set_title(title)
        ax.axis("off")
    if joints is not None:
        # front (h, w), left (d, w), top (d, h), as the reference
        j = host_array(joints).reshape(-1, 3)  # (d, h, w)
        axes[0].scatter(j[:, 2], j[:, 1], s=6, c="cyan")
        axes[1].scatter(j[:, 2], j[:, 0], s=6, c="cyan")
        axes[2].scatter(j[:, 1], j[:, 0], s=6, c="cyan")
    fig.suptitle(f"{name} @ {step}")
    return _save(fig, out_dir, name)


def threeview_projections(volume):
    """The three max-projections that :func:`threeviews_log` draws, of the
    volume clipped at 0, each divided by its peak where that is > 0."""
    v = np.clip(_vol3d(volume), 0, None)
    out = []
    for axis in (0, 1, 2):
        proj = v.max(axis=axis)
        peak = proj.max()
        out.append(proj / peak if peak > 0 else proj)
    return out


def threeviews_log(volume, out_dir: str, name: str, step: int = 0) -> str:
    """Max-projections along the three axes."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, proj, title in zip(axes, threeview_projections(volume),
                               ["front", "left", "top"]):
        ax.imshow(proj, cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.suptitle(f"{name} @ {step}")
    return _save(fig, out_dir, name)


def write_joints(joints, out_dir: str, name: str) -> str:
    """``<out_dir>/<name>.txt``: the (J, 3) joints."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.txt")
    np.savetxt(path, host_array(joints).reshape(-1, 3))
    return path


def joints_log(joints, out_dir: str, name: str, step: int = 0) -> str:
    """The joints' ``.txt``, then a 3D skeleton (scatter and bone links,
    plotted as (w, d, h) so that the figure stands upright)."""
    j = host_array(joints).reshape(-1, 3)
    write_joints(j, out_dir, name)
    plt = _pyplot()
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(j[:, 2], j[:, 0], j[:, 1], c="r", s=12)
    for a, b in SMPL_BONES:
        if a < len(j) and b < len(j):
            ax.plot([j[a, 2], j[b, 2]], [j[a, 0], j[b, 0]],
                    [j[a, 1], j[b, 1]], c="b", linewidth=1)
    ax.invert_zaxis()
    ax.set_xlabel("w")
    ax.set_ylabel("d")
    ax.set_zlabel("h")
    ax.set_title(f"{name} @ {step}")
    return _save(fig, out_dir, name)


def vis_3view(volume, out_dir: str = ".", name: str = "views") -> str:
    """A stand-alone three-view max-projection image."""
    return threeviews_log(volume, out_dir, name)


def plot_volume_html(volume, out_path: str,
                     threshold: float = 0.5) -> Optional[str]:
    """An interactive isosurface through plotly where it is installed;
    None where it is not."""
    try:
        import plotly.graph_objects as go
    except Exception:
        return None
    v = _vol3d(volume)
    d, h, w = v.shape
    z, y, x = np.mgrid[0:d, 0:h, 0:w]
    fig = go.Figure(data=go.Volume(
        x=x.ravel(), y=y.ravel(), z=z.ravel(), value=v.ravel(),
        isomin=threshold * float(v.max()), opacity=0.1, surface_count=8))
    fig.write_html(out_path)
    return out_path
