"""The train, eval and inference steps.

Port of ``hiddenpose_tpu/train/step.py``: ``make_train_step`` (forward,
joint loss + voxel loss, backward, Adam update), ``make_eval_step`` and
``make_forward``.  The JAX package jits each step; PyTorch runs eagerly,
and the train step updates the :class:`TrainState` in place.

Precision: ``make_train_step(model, matmul_precision=p)`` runs the JAX
step traced under ``jax.default_matmul_precision(p)``, for a float32 or a
bfloat16 (``Config.with_bf16()``) model:

* 'highest' (this port's default, phase 6 of ``chip_smoke.py``): cuDNN and
  cuBLAS in full f32 (TF32 off); each K4-eligible Bottleneck conv2 on the
  'full' route, K4 and K4-dx in three TF32 passes with f32 sums, as
  accurate against float64 as an f32 conv; every other kernel fp32 FMA.
* 'high': the library's f32 convs and matmuls in TF32 (the JAX GPU
  backend's 'high'); the kernels as at 'highest' (the JAX kernels escalate
  'high' to HIGHEST).
* 'default' (the JAX ``TrainConfig``'s, ``cfg.train.matmul_precision``):
  the library in TF32; the conv2 on the 'bwd' route, the library's forward
  and K4-dx-bf16 for dx (dz and the taps rounded to bf16, one pass).

A bf16 model's convs are bf16 whatever the precision; its f32 ops (the
LCT, the norms) follow the flags.  The flags are process-wide: the step
sets them on entry and restores them on exit.  So a step at 'default' or
'high' must not run beside a live float32 server in the same process,
whose forwards would take TF32 meanwhile.  The JAX rounds found that one
bf16 pass makes the loss fall 2-3x slower (BENCH_NOTES "Precision IS the
learning-gap driver"), which is why this port's default stays 'highest':
pass ``cfg.train.matmul_precision`` for the JAX package's default.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from hiddenpose_tpu_torch.losses import bce_dice_loss, l2_joint_location_loss
from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.ops.kernels import conv3mxu
from hiddenpose_tpu_torch.ops.lct import LCTParams
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
from hiddenpose_tpu_torch.parallel.mesh import (
    Mesh,
    average_gradients,
    data_parallel,
    mean_over_data,
)
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.utils import tracing

Batch = Dict[str, torch.Tensor]
# Batch fields: meas (B, 1, T, H, W), vol (B, 1, D, H, W),
#               joints (B, J*3), joints_vis (B, J*3)


@contextlib.contextmanager
def precision_scope(model, precision: str):
    """For the duration of the block: ``precision`` ambient for the conv2
    routes (``conv3mxu.matmul_precision``) and, for a model on a GPU, TF32
    in cuDNN and cuBLAS on for 'default' and 'high', off for 'highest';
    both restored on exit.  ``model``: any module, or an optimizer (whose
    parameters say where the model is)."""
    params = (model.parameters() if isinstance(model, torch.nn.Module)
              else (p for g in model.param_groups for p in g["params"]))
    cuda = next(params).is_cuda
    # the per-backend flags only: the global float32 matmul precision
    # raises in some PyTorch versions once the two backends differ
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with conv3mxu.matmul_precision(precision):
        try:
            if cuda:
                tf32 = precision != "highest"
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
            yield
        finally:
            if cuda:
                torch.backends.cuda.matmul.allow_tf32 = saved[0]
                torch.backends.cudnn.allow_tf32 = saved[1]


def make_train_step(model: NlosPose, matmul_precision: str = "highest",
                    mesh: Optional[Mesh] = None):
    """Returns train_step(state, batch, lct) -> metrics, which puts the
    model in training mode, takes one Adam step on ``state`` (whose model
    must be ``model``) at ``matmul_precision`` ('default', 'high' or
    'highest'; see the module's docstring) and returns the detached loss,
    joint_loss and voxel_loss of the forward before the update.

    With ``mesh`` (``parallel/mesh.py``) the step is data parallel: each
    rank passes its share of the global batch (``shard_batch``), and the
    step is the single-process step on the global batch, as the JAX step
    ``jit`` over a batch sharded on 'data' is: the BatchNorm moments and
    the Dice sums are the global batch's (``data_parallel``), the
    gradients are averaged over 'data' before the Adam update, and the
    metrics are the global batch's.  The joint loss (a sum over the local
    batch over its size) and the BCE mean average correctly over equal
    shares.  The collectives run on a mesh of one rank too."""
    conv3mxu.check_precision(matmul_precision)

    def train_step(state: TrainState, batch: Batch,
                   lct: LCTParams) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        model.train()
        # with tracing on: the step's host and device spans
        sid = tracing.new_id()
        cuda = tracing.enabled() and batch["meas"].is_cuda
        with precision_scope(model, matmul_precision), data_parallel(mesh):
            with tracing.span("step.forward", sid, device=cuda):
                heatmaps, refine = model(batch["meas"], lct)
                joint_loss = l2_joint_location_loss(
                    heatmaps, batch["joints"], batch["joints_vis"])
                b = refine.shape[0]
                voxel_loss = bce_dice_loss(refine.reshape(b, -1),
                                           batch["vol"].reshape(b, -1))
                loss = joint_loss + voxel_loss
            state.optimizer.zero_grad(set_to_none=True)
            with tracing.span("step.backward", sid, device=cuda):
                loss.backward()
        metrics = torch.stack([loss, joint_loss, voxel_loss]).detach()
        if mesh is not None:
            average_gradients([p for g in state.optimizer.param_groups
                               for p in g["params"]], mesh)
            metrics = mean_over_data(metrics, mesh)
        with tracing.span("step.adam", sid, device=cuda):
            state.apply_gradients()
        return dict(zip(("loss", "joint_loss", "voxel_loss"), metrics))

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
            joints = softmax_integral(heatmaps, heatmaps.shape[1])
            tracing.stage(None)     # ends a traced forward's head stage
            return joints, heatmaps

    return forward
