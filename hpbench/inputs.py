"""Inputs made from a run's seed: synthetic captures, training batches and
peaked random weights, all on the device.

Frozen copies, so that a change to the program cannot change what the
benchmark feeds it:

* the captures are HiddenPose-shaped synthetic transients: a jittered
  24-joint stick figure, each scatterer on a bone an ellipsoid shell at
  t = 2 dist / bin_len with 1 / r^4 falloff (the recipe of the program's
  ``data/synthetic.py::make_sample``), rendered here for many scatterers
  and pixels at once on the device, each bin a sum over the scatterers
  in one fixed order, so the same seed gives the same bits;
* a training batch stacks captures with their occupancy volumes and joints
  (``make_batch``'s layout);
* the weights follow the program's ``utils/peaked.py::peaked_state_dict``
  recipe (fan-in scaled convs, random norm affines and BatchNorm
  statistics, so that heatmaps are peaked and joints spread over the
  volume), drawn in two calls from one generator on the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21])
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
# gain of the posenet2d head's final conv (peaked 2D logits)
HEAD2D_GAIN = 8.0
# pixels rendered at a time: bounds the (scatterers, T, pixels) one-hot
PIXEL_CHUNK = 2048


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from a run's seed (any size)."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint32)]


def pose(seed: int) -> np.ndarray:
    """A jittered rest pose (24, 3) in the normalised scene frame."""
    rng = np.random.RandomState(seed)
    p = (SMPL_REST_POSE + rng.randn(24, 3) * 0.05) * 0.6
    p[:, 2] += rng.uniform(-0.3, 0.1)
    return p


def scatterers(joints: np.ndarray, per_bone: int = 6) -> np.ndarray:
    pts = [joints]
    t = np.linspace(0.0, 1.0, per_bone + 2)[1:-1, None]
    for j, p in enumerate(SMPL_PARENTS):
        if p >= 0:
            pts.append(joints[p] * (1 - t) + joints[j] * t)
    return np.concatenate(pts, 0)


@torch.no_grad()
def render(points: np.ndarray, time_size: int, image_size: int,
           bin_len: float, device, wall_size: float = 2.0) -> torch.Tensor:
    """Confocal transient (T, H, W) float32 of ``points`` (K, 3), scaled
    to a maximum of 1."""
    n = image_size
    axis = torch.linspace(-wall_size / 2, wall_size / 2, n,
                          dtype=torch.float64, device=device)
    wy, wx = torch.meshgrid(axis, axis, indexing="ij")
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    sx, sy = pts[:, 0, None, None], pts[:, 1, None, None]
    depth = (pts[:, 2] + 0.8).clamp_min(0.05)[:, None, None]
    dist = ((wx - sx) ** 2 + (wy - sy) ** 2 + depth ** 2).sqrt()
    tof = 2.0 * dist / bin_len
    t0 = tof.floor()
    frac = (tof - t0).float()
    amp = (1.0 / (dist ** 4 + 1e-3)).float()
    t0 = t0.long().reshape(len(pts), -1)
    w0 = (amp * (1.0 - frac)).reshape(len(pts), -1)
    w1 = (amp * frac).reshape(len(pts), -1)
    bins = torch.arange(time_size, device=device)[None, :, None]
    out = []
    for c in range(0, n * n, PIXEL_CHUNK):
        tc = t0[:, None, c:c + PIXEL_CHUNK]
        acc = ((tc == bins) * w0[:, None, c:c + PIXEL_CHUNK]
               + (tc + 1 == bins) * w1[:, None, c:c + PIXEL_CHUNK])
        out.append(acc.sum(0))
    meas = torch.cat(out, 1).reshape(time_size, n, n)
    top = meas.max()
    return meas / top if top > 0 else meas


def voxelize(points: np.ndarray, grid: int, wall_size: float = 2.0):
    vol = np.zeros((grid, grid, grid), np.float32)
    half = wall_size / 2
    d = np.clip(((points[:, 2] + 0.8) / wall_size * grid).astype(int), 0,
                grid - 1)
    h = np.clip(((half - points[:, 1]) / wall_size * grid).astype(int), 0,
                grid - 1)
    w = np.clip(((points[:, 0] + half) / wall_size * grid).astype(int), 0,
                grid - 1)
    vol[d, h, w] = 1.0
    return vol


def heatmap_joints(joints: np.ndarray, heatmap_size: int) -> np.ndarray:
    """Scene joints -> heatmap voxels (d, h, w) of the 256-voxel grid over
    its ratio to a 64 heatmap, rescaled to ``heatmap_size``."""
    j = np.asarray(joints, np.float64)
    x = j[:, 0] * 128 + 128
    y = 256 - (j[:, 1] * 128 + 128)
    z = 225 - (j[:, 2] * 128 + 128)
    out = np.stack([z, y, x], 1) / 4.0 * (heatmap_size / 64.0)
    return out.astype(np.float32)


def captures(seeds, model: dict, device) -> torch.Tensor:
    """(n, 1, T, H, W) float32 captures on ``device``, one a seed."""
    return torch.stack([
        render(scatterers(pose(s)), model["time_size"],
               model["image_size"][0], model["bin_len"], device,
               model["wall_size"])[None] for s in seeds])


def batch(seeds, model: dict, device) -> Dict[str, torch.Tensor]:
    """A training batch of the samples of ``seeds``: meas (B, 1, T, H, W),
    vol (B, 1, D, H, W), joints and joints_vis (B, J*3)."""
    poses = [pose(s) for s in seeds]
    grid, hm = model["grid_dim"], model["heatmap_size"][0]
    vol = np.stack([voxelize(scatterers(p), grid, model["wall_size"])
                    for p in poses])[:, None]
    joints = np.stack([heatmap_joints(p, hm) for p in poses]).reshape(
        len(seeds), -1)
    return {
        "meas": captures(seeds, model, device),
        "vol": torch.from_numpy(vol).to(device),
        "joints": torch.from_numpy(joints).to(device),
        "joints_vis": torch.ones(joints.shape, device=device),
    }


@torch.no_grad()
def peaked_weights(template: nn.Module, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """A state_dict for ``template``'s names and shapes (a model on the
    meta device will do), float32 on ``device``, from ``seed``."""
    taps = {f"{name}.weight": 8 if isinstance(m, nn.ConvTranspose3d) else 4
            for name, m in template.named_modules()
            if isinstance(m, (nn.ConvTranspose3d, nn.ConvTranspose2d))}
    plan, n_normal, n_uniform = [], 0, 0
    for name, t in template.state_dict().items():
        if not t.is_floating_point():
            plan.append((name, t, "zero", 0))
        elif name.endswith("running_var"):
            plan.append((name, t, "uniform", n_uniform))
            n_uniform += t.numel()
        else:
            plan.append((name, t, "normal", n_normal))
            n_normal += t.numel()
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    sd = {}
    for name, t, kind, at in plan:
        shape, n = t.shape, t.numel()
        if kind == "zero":
            sd[name] = torch.zeros(shape, dtype=t.dtype, device=device)
        elif kind == "uniform":
            sd[name] = 0.5 + 0.5 * uniform[at:at + n].reshape(shape)
        elif name.endswith("running_mean") or name.endswith("bias"):
            sd[name] = 0.1 * normal[at:at + n].reshape(shape)
        elif t.dim() == 1:
            sd[name] = 1.0 + 0.1 * normal[at:at + n].reshape(shape)
        else:
            fan_in = shape[0] * taps[name] if name in taps else n // shape[0]
            w = normal[at:at + n].reshape(shape) * fan_in ** -0.5
            if name == "pose_net.head.final.weight" and t.dim() == 4:
                w = w * HEAD2D_GAIN
            sd[name] = w.contiguous()
    return sd
