"""Training losses: the t128 train step's and the other objectives'.

Port of ``hiddenpose_tpu/losses.py`` (``weighted_mse_loss``,
``l2_joint_location_loss``, ``dice_loss``, ``bce_with_logits``,
``bce_dice_loss``; ``joints_mse_loss`` and ``nmt_norm_criterion`` for the
steps of ``train/alt_steps.py``), with the same formulas and the same
quirks: the Dice score is one global score over the whole batch, and the
BCE is the stable ``max(x, 0) - x*t + log1p(exp(-|x|))``.  At a logit of
exactly 0 the gradient follows JAX's conventions too: ``torch.maximum``
splits the tie 0.5/0.5 as ``jnp.maximum`` does, and ``|x|`` is written so
that its gradient at 0 is 1, as ``jnp.abs``'s is (``torch.abs``'s is 0).
"""

from __future__ import annotations

import torch

from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
from hiddenpose_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum


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
    """1 - one Dice score over the whole batch (sums before the ratio).
    Inside a data-parallel step (``parallel/mesh.py::data_parallel``) the
    sums are taken over every rank's share of the batch, as the JAX step
    takes them over its sharded global batch."""
    probs = torch.sigmoid(logits)
    sums = torch.stack([(probs * targets).sum(), probs.sum(), targets.sum()])
    mesh = active_mesh()
    if mesh is not None:
        sums = all_reduce_sum(sums, mesh.group("data"))
    intersection = 2.0 * sums[0]
    union = sums[1] + sums[2]
    return 1.0 - (intersection + eps) / union


def bce_with_logits(logits, targets):
    """Mean binary cross-entropy from logits."""
    abs_ = torch.where(logits >= 0, logits, -logits)
    loss = (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-abs_)))
    return loss.mean()


def bce_dice_loss(logits, targets):
    return bce_with_logits(logits, targets) + dice_loss(logits, targets)


def joints_mse_loss(pred_heatmaps, gt_heatmaps, target_weight=None):
    """2D-heatmap MSE: 0.5 x the mean squared error of each joint (over
    the batch and the flattened map), averaged over joints.  pred/gt
    (B, J, ...); target_weight (B, J) or None multiplies both sides."""
    b, j = pred_heatmaps.shape[:2]
    pred = pred_heatmaps.reshape(b, j, -1)
    gt = gt_heatmaps.reshape(b, j, -1)
    if target_weight is not None:
        w = target_weight.reshape(b, j, 1)
        pred, gt = pred * w, gt * w
    per_joint = 0.5 * ((pred - gt) ** 2).mean(dim=(0, 2))
    return per_joint.sum() / j


def _jax_index(labels, k):
    """Labels as JAX indexing reads them: a negative label counts from the
    end (``-1`` is ``k - 1``).  Returns (index, in range)."""
    idx = torch.where(labels < 0, labels + k, labels).long()
    return idx, (idx >= 0) & (idx < k)


def nmt_norm_criterion(logits, labels, label_smoothing: float = 0.2):
    """SimDR classification loss over one coordinate axis, per row.

    logits (N, K), labels (N,) integer bins.  With smoothing > 0: KL of a
    smoothed one-hot (``1 - smoothing`` at the label, ``smoothing / (K-1)``
    elsewhere) against ``log_softmax(logits)``, the mean over classes of
    each row; at smoothing 0 the NLL of the label.

    A label outside [-K, K) follows the JAX package's indexing: the
    one-hot's ``.at[].set`` drops it (the row stays all ``smoothing /
    (K-1)``); the NLL's gather clamps it to the nearest bin, and the
    gather's gradient, a scatter, drops it (the row gets no gradient)."""
    n, k = logits.shape
    log_probs = torch.log_softmax(logits, dim=1)
    idx, valid = _jax_index(labels, k)
    if label_smoothing > 0:
        confidence = 1.0 - label_smoothing
        p = torch.full((n, k), label_smoothing / (k - 1), dtype=logits.dtype,
                       device=logits.device)
        rows = torch.arange(n, device=logits.device)[valid]
        p[rows, idx[valid]] = confidence
        kl = torch.where(p > 0,
                         p * (torch.log(p.clamp(min=1e-12)) - log_probs),
                         torch.zeros_like(log_probs))
        return kl.mean(dim=1)
    nll = -log_probs.gather(1, idx.clamp(0, k - 1)[:, None])[:, 0]
    return torch.where(valid, nll, nll.detach())
