"""3D heatmap scatter plot.

Port of ``hiddenpose_tpu/viz/heatmap3d.py``: the voxels above
``threshold`` x the peak, coloured by intensity, at most ``max_points``
of the largest.  Takes a numpy array or a tensor (moved to the host).
"""

from __future__ import annotations

import os

import numpy as np

from hiddenpose_tpu_torch.viz.visualizer import host_array


def heatmap3d_points(volume, threshold: float = 0.5,
                     max_points: int = 20000):
    """(xs, ys, zs, values) of the voxels the figure draws."""
    v = host_array(volume)
    while v.ndim > 3:
        v = v[0]
    peak = v.max()
    zs, ys, xs = np.nonzero(v > threshold * peak)
    vals = v[zs, ys, xs]
    if len(vals) > max_points:
        sel = np.argsort(vals)[-max_points:]
        zs, ys, xs, vals = zs[sel], ys[sel], xs[sel], vals[sel]
    return xs, ys, zs, vals


def plot_heatmap3d(volume, out_dir: str, name: str,
                   threshold: float = 0.5, max_points: int = 20000) -> str:
    """``<out_dir>/<name>.png``: the scatter of :func:`heatmap3d_points`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, ys, zs, vals = heatmap3d_points(volume, threshold, max_points)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    sc = ax.scatter(xs, ys, zs, c=vals, cmap="hot", s=4, alpha=0.5)
    fig.colorbar(sc, shrink=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title(name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path
