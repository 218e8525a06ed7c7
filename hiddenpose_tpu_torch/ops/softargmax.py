"""Soft-argmax joint decoding: from 3D heatmaps and from SimDR logits.

Port of ``hiddenpose_tpu/ops/softargmax.py``.  ``softmax_integral``: a
global softmax over each joint's flattened heatmap, then the expected
coordinate along each axis from the marginals.  Like the reference, it
does not re-centre: coordinates are in heatmap-voxel units 0..dim
(``softmax_integral_normalized`` is the re-centred variant).
``simdr_decode``: the expected bin of each axis's classification logits,
the decoding of the Sformer's head.
"""

from __future__ import annotations

import torch


def softmax_integral(heatmaps: torch.Tensor, num_joints: int) -> torch.Tensor:
    """(B, J, Z, Y, X) logits -> (B, J*3) expected (x, y, z) coordinates."""
    b = heatmaps.shape[0]
    z_dim, y_dim, x_dim = heatmaps.shape[-3:]
    flat = heatmaps.reshape(b, num_joints, -1).float()
    probs = torch.softmax(flat, dim=2).reshape(
        b, num_joints, z_dim, y_dim, x_dim)

    marg_x = probs.sum(dim=(2, 3))  # (B, J, X)
    marg_y = probs.sum(dim=(2, 4))  # (B, J, Y)
    marg_z = probs.sum(dim=(3, 4))  # (B, J, Z)

    def expect(marg, n):
        return (marg * torch.arange(n, dtype=marg.dtype,
                                    device=marg.device)).sum(dim=2)

    coords = torch.stack(
        [expect(marg_x, x_dim), expect(marg_y, y_dim), expect(marg_z, z_dim)],
        dim=2)
    return coords.reshape(b, num_joints * 3)


def simdr_decode(logits_xyz: torch.Tensor,
                 split_ratio: float = 2.0) -> torch.Tensor:
    """Decode per-axis SimDR classification logits to coordinates.

    Port of ``hiddenpose_tpu/ops/softargmax.py::simdr_decode``.
    logits_xyz: (B, J, 3, K), the per-axis bin logits (the first three of
    the four slots of ``NlosPoseSformer``'s output).  Returns (B, J, 3)
    float32 expected coordinates in image units (bin / split_ratio)."""
    probs = torch.softmax(logits_xyz.float(), dim=-1)
    bins = torch.arange(logits_xyz.shape[-1], dtype=torch.float32,
                        device=logits_xyz.device)
    return (probs * bins).sum(dim=-1) / split_ratio


def softmax_integral_normalized(heatmaps: torch.Tensor,
                                num_joints: int) -> torch.Tensor:
    """``softmax_integral`` re-centred to [-0.5, 0.5]: each coordinate
    over its axis's extent, minus 0.5 (the reference's older loss copy;
    do not mix with the live joint scaling).  (B, J, Z, Y, X) -> (B, J*3)."""
    z_dim, y_dim, x_dim = heatmaps.shape[-3:]
    coords = softmax_integral(heatmaps, num_joints)
    coords = coords.reshape(coords.shape[0], num_joints, 3)
    dims = torch.tensor([x_dim, y_dim, z_dim], dtype=coords.dtype,
                        device=coords.device)
    coords = coords / dims - 0.5
    return coords.reshape(coords.shape[0], num_joints * 3)
