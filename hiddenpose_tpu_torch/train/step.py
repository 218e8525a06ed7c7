"""Inference step: measurements -> (joints, heatmaps).

Port of ``hiddenpose_tpu/train/step.py::make_forward``.  The JAX package
runs float32 inference at 'highest' precision; the same holds here:
``build_nlospose`` turns TF32 off when it builds a model for a GPU, and
the four kernels never use TF32.
"""

from __future__ import annotations

import torch

from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.ops.lct import LCTParams
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral


def make_forward(model: NlosPose):
    """Returns forward(meas, lct) -> (pred_joints (B, J*3), heatmaps)."""

    def forward(meas: torch.Tensor, lct: LCTParams):
        with torch.inference_mode():
            heatmaps, _ = model(meas, lct)
            return softmax_integral(heatmaps, heatmaps.shape[1]), heatmaps

    return forward
