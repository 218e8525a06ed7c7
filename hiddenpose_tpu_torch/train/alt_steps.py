"""The train steps of the other coordinate representations.

Port of ``hiddenpose_tpu/train/alt_steps.py``:

* :func:`make_heatmap3d_step`: NlosPose's 3D heatmaps, the joint loss
  only (no voxel loss), on a :class:`TrainState`, with the BatchNorm
  statistics updated as in ``make_train_step``;
* :func:`make_heatmap2d_step`: 2D heatmaps (TokenPose) against Gaussian
  targets (``data/targets.py``) by ``joints_mse_loss``;
* :func:`make_simdr_step`: per-axis SimDR classification
  (:func:`simdr_loss`) of an ``NlosPoseSformer`` or ``TimeSformer``'s
  first three output slots.

The JAX steps take ``(params, opt_state, tx, batch)`` with an optax Adam
and return new ones; here a step takes the module (or a forward) and a
``torch.optim.Adam`` built as ``train/optim.py`` builds it (optax's
update), and updates both in place.  Each step runs at
``matmul_precision`` ('highest' by default, as ``make_train_step``), set
and restored by ``train/step.py::precision_scope``.  The Sformer's
grouped attention and joint-token read run K9 (``AttendFused``: the
kernel forward, the plain attention's gradient), 16 launches a step at
depth 8.  On a Sformer in the bfloat16 mode (its Dense layers bf16, as
the JAX model's ``compute_dtype="bfloat16"``) the same step runs K9 on
f32 q and k (the rotary tables promote them) and a bf16 v, and returns
each gradient in its input's type, as ``jax.vjp`` of the JAX
``attend_ref`` does: f32 dq and dk, a bf16 dv.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hiddenpose_tpu_torch.losses import (
    joints_mse_loss,
    l2_joint_location_loss,
    nmt_norm_criterion,
)
from hiddenpose_tpu_torch.ops.kernels import conv3mxu
from hiddenpose_tpu_torch.ops.lct import LCTParams
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import Batch, precision_scope


def make_heatmap3d_step(model, matmul_precision: str = "highest"):
    """Returns step(state, batch, lct) -> {"loss"}: one Adam step of
    NlosPose (``state.model`` must be ``model``) on the joint loss of its
    heatmaps alone.  Batch: meas, joints, joints_vis."""
    conv3mxu.check_precision(matmul_precision)

    def step(state: TrainState, batch: Batch,
             lct: LCTParams) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        model.train()
        with precision_scope(model, matmul_precision):
            heatmaps, _ = model(batch["meas"], lct)
            loss = l2_joint_location_loss(heatmaps, batch["joints"],
                                          batch["joints_vis"])
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step


def make_heatmap2d_step(forward: Callable[[Batch], torch.Tensor],
                        optimizer: torch.optim.Optimizer,
                        matmul_precision: str = "highest"):
    """Returns step(batch) -> {"loss"}: one ``optimizer`` step on
    ``joints_mse_loss(forward(batch), target_heatmaps, target_weight)``.
    ``forward(batch)`` gives (B, J, H, W) heatmaps from the parameters
    that ``optimizer`` holds; ``target_weight`` (B, J) may be absent."""
    conv3mxu.check_precision(matmul_precision)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        with precision_scope(optimizer, matmul_precision):
            loss = joints_mse_loss(forward(batch), batch["target_heatmaps"],
                                   batch.get("target_weight"))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def simdr_loss(logits_xyz: torch.Tensor, target_bins: torch.Tensor,
               target_weight: torch.Tensor,
               label_smoothing: float = 0.2) -> torch.Tensor:
    """Per-axis SimDR classification loss.

    logits_xyz (B, J, 3, K) per-axis logits; target_bins (B, J, 3)
    integer bins; target_weight (B, J).  For each axis the mean of
    ``nmt_norm_criterion`` x weight over (B, J); the three axes' mean."""
    b, j, _, k = logits_xyz.shape
    total = 0.0
    for ax in range(3):
        lg = logits_xyz[:, :, ax].reshape(b * j, k)
        tb = target_bins[:, :, ax].reshape(b * j)
        per = nmt_norm_criterion(lg, tb, label_smoothing).reshape(b, j)
        total = total + (per * target_weight).mean()
    return total / 3.0


def make_simdr_step(model, label_smoothing: float = 0.2,
                    matmul_precision: str = "highest"):
    """Returns step(optimizer, batch) -> {"loss"}: one ``optimizer`` step
    of ``model`` (an ``NlosPoseSformer`` or ``TimeSformer`` whose output
    is (B, J, p, K), axes x / y / z in the first three of the p slots) on
    :func:`simdr_loss`.  Batch: video, target_bins, target_weight."""
    conv3mxu.check_precision(matmul_precision)

    def step(optimizer: torch.optim.Optimizer,
             batch: Batch) -> Dict[str, torch.Tensor]:
        model.train()
        with precision_scope(model, matmul_precision):
            out = model(batch["video"])
            loss = simdr_loss(out[:, :, :3], batch["target_bins"],
                              batch["target_weight"], label_smoothing)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step
