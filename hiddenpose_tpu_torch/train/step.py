"""The train, eval and inference steps.

Port of ``hiddenpose_tpu/train/step.py``: ``make_train_step`` (forward,
joint loss + voxel loss, backward, Adam update), ``make_eval_step`` and
``make_forward``.  The JAX package jits each step; PyTorch runs eagerly,
and the train step updates the :class:`TrainState` in place.

Precision: only float32 at 'highest' is ported.  The four kernels of the
forward and the four of the backward never use TF32, and for a model on a
GPU the step turns TF32 off for cuDNN and cuBLAS (as ``build_nlospose``
does), so the library convs and matmuls are full f32 as well.
"""

from __future__ import annotations

from typing import Dict

import torch

from hiddenpose_tpu_torch.losses import bce_dice_loss, l2_joint_location_loss
from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.ops.lct import LCTParams
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
from hiddenpose_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
# Batch fields: meas (B, 1, T, H, W), vol (B, 1, D, H, W),
#               joints (B, J*3), joints_vis (B, J*3)


def make_train_step(model: NlosPose, matmul_precision: str = "highest"):
    """Returns train_step(state, batch, lct) -> metrics, which puts the
    model in training mode, takes one Adam step on ``state`` (whose model
    must be ``model``) and returns the detached loss, joint_loss and
    voxel_loss of the forward before the update."""
    if matmul_precision != "highest":
        raise NotImplementedError(
            f"matmul_precision={matmul_precision!r}: only 'highest' (f32, "
            "TF32 off) is ported; the precision knob is ROADMAP Queue 1 "
            "item 7")
    if next(model.parameters()).is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def train_step(state: TrainState, batch: Batch,
                   lct: LCTParams) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        model.train()
        heatmaps, refine = model(batch["meas"], lct)
        joint_loss = l2_joint_location_loss(
            heatmaps, batch["joints"], batch["joints_vis"])
        b = refine.shape[0]
        voxel_loss = bce_dice_loss(refine.reshape(b, -1),
                                   batch["vol"].reshape(b, -1))
        loss = joint_loss + voxel_loss
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "joint_loss": joint_loss.detach(),
                "voxel_loss": voxel_loss.detach()}

    return train_step


def make_eval_step(model: NlosPose):
    """Returns eval_step(state, batch, lct) -> dict of pred_joints,
    heatmaps, refine and, when the batch has joints, joint_loss."""

    def eval_step(state: TrainState, batch: Batch, lct: LCTParams):
        model.eval()
        with torch.inference_mode():
            heatmaps, refine = model(batch["meas"], lct)
            out = {"pred_joints": softmax_integral(heatmaps,
                                                   heatmaps.shape[1]),
                   "heatmaps": heatmaps, "refine": refine}
            if "joints" in batch:
                out["joint_loss"] = l2_joint_location_loss(
                    heatmaps, batch["joints"], batch["joints_vis"])
        return out

    return eval_step


def make_forward(model: NlosPose):
    """Returns forward(meas, lct) -> (pred_joints (B, J*3), heatmaps)."""

    def forward(meas: torch.Tensor, lct: LCTParams):
        with torch.inference_mode():
            heatmaps, _ = model(meas, lct)
            return softmax_integral(heatmaps, heatmaps.shape[1]), heatmaps

    return forward
