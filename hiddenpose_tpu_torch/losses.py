"""Training losses of the t128 train step.

Port of ``hiddenpose_tpu/losses.py`` (``weighted_mse_loss``,
``l2_joint_location_loss``, ``dice_loss``, ``bce_with_logits``,
``bce_dice_loss``), with the same formulas and the same quirks: the Dice
score is one global score over the whole batch, and the BCE is the stable
``max(x, 0) - x*t + log1p(exp(-|x|))``.  At a logit of exactly 0 the
gradient follows JAX's conventions too: ``torch.maximum`` splits the tie
0.5/0.5 as ``jnp.maximum`` does, and ``|x|`` is written so that its
gradient at 0 is 1, as ``jnp.abs``'s is (``torch.abs``'s is 0).
"""

from __future__ import annotations

import torch

from hiddenpose_tpu_torch.ops.softargmax import softmax_integral


def weighted_mse_loss(pred, target, weights, size_average: bool = True):
    """((pred - target)^2 * weights).sum(), divided by the batch if
    ``size_average``."""
    total = (((pred - target) ** 2) * weights).sum()
    return total / pred.shape[0] if size_average else total


def l2_joint_location_loss(heatmaps, gt_joints, gt_joints_vis,
                           size_average: bool = True):
    """Soft-argmax joints of (B, J, Z, Y, X) heatmaps against gt_joints
    (B, J*3) in heatmap-voxel units, weighted by gt_joints_vis."""
    num_joints = gt_joints_vis.shape[1] // 3
    pred = softmax_integral(heatmaps, num_joints)
    return weighted_mse_loss(pred, gt_joints.detach(), gt_joints_vis.detach(),
                             size_average)


def dice_loss(logits, targets, eps: float = 1e-9):
    """1 - one Dice score over the whole batch (sums before the ratio)."""
    probs = torch.sigmoid(logits)
    intersection = 2.0 * (probs * targets).sum()
    union = probs.sum() + targets.sum()
    return 1.0 - (intersection + eps) / union


def bce_with_logits(logits, targets):
    """Mean binary cross-entropy from logits."""
    abs_ = torch.where(logits >= 0, logits, -logits)
    loss = (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-abs_)))
    return loss.mean()


def bce_dice_loss(logits, targets):
    return bce_with_logits(logits, targets) + dice_loss(logits, targets)
