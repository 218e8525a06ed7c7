"""Soft-argmax joint decoding from 3D heatmaps.

Port of ``hiddenpose_tpu/ops/softargmax.py::softmax_integral``: a global
softmax over each joint's flattened heatmap, then the expected coordinate
along each axis from the marginals.  Like the reference, it does not
re-centre: coordinates are in heatmap-voxel units 0..dim.
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
