"""Dataset-level evaluation harness.

Port of ``hiddenpose_tpu/eval/harness.py``: MPJPE / PA-MPJPE / PCK over a
data source with the eval step, every sample (``drop_last=False``), in
heatmap voxels.  The predictions stay on the device until the last batch
and come back in one copy.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.data.dataset import DataPipeline
from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch
from hiddenpose_tpu_torch.eval.metrics import mpjpe, pa_mpjpe, pck
from hiddenpose_tpu_torch.train.step import make_eval_step


def evaluate(model, state, lct, source, batch_size: int = 2,
             max_batches: Optional[int] = None, pck_threshold: float = 4.0,
             num_workers: int = 4, device="cuda") -> Dict:
    """Returns {'mpjpe', 'pa_mpjpe', 'pck', 'n_samples', 'pred_joints'}
    ((N, J*3) float32 numpy).  ``model`` must live on ``device``: the GPU
    by default (raises without one), ``"cpu"`` only when asked for."""
    device = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != device.type or (device.index is not None
                                    and have.index != device.index):
        raise ValueError(f"the model is on {have}, not on {device}")
    eval_step = make_eval_step(model)
    preds, gts = [], []
    with DataPipeline(source, batch_size=batch_size, shuffle=False,
                      num_workers=num_workers, drop_last=False,
                      pin_memory=device.type == "cuda") as pipe:
        host = itertools.islice(iter(pipe), max_batches)
        for batch in device_prefetch(host, have):
            preds.append(eval_step(state, batch, lct)["pred_joints"])
            gts.append(batch["joints"])
    if not preds:
        raise ValueError("evaluate: the source gave no batch")
    pred = torch.cat(preds).float().cpu().numpy()
    gt = torch.cat(gts).cpu().numpy()
    return {
        "mpjpe": mpjpe(pred, gt),
        "pa_mpjpe": pa_mpjpe(pred, gt),
        "pck": pck(pred, gt, pck_threshold),
        "n_samples": int(pred.shape[0]),
        "pred_joints": pred,
    }
