"""Checkpoint save and restore.

Port of ``hiddenpose_tpu/train/checkpoint.py`` (Orbax there): one file per
checkpoint, named as the JAX package names its directories (``epoch_{e}``,
``iter_{n}``), written by ``torch.save`` to a temporary file and moved into
place with ``os.replace``, so a reader never sees a partial one.

The payload is plain tensors and numbers, which
``torch.load(weights_only=True)`` accepts: the model's ``state_dict``
(parameters and BatchNorm statistics), the optimizer's ``state_dict``
(Adam's moments and counts, the param groups), ``TrainState.step`` (the
count the learning-rate schedule reads, as optax's count in the JAX
package's opt_state), ``epoch`` and ``global_iter``.  Resume continues at
``epoch + 1``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from hiddenpose_tpu_torch.train.state import TrainState


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    global_iter: int = 0, name: Optional[str] = None) -> str:
    """Write ``<directory>/<name or epoch_{epoch}>`` atomically; returns
    its path."""
    name = name or f"epoch_{epoch}"
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, name))
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "global_iter": int(global_iter),
    }
    tmp = os.path.join(os.path.dirname(path), f".{name}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, int, int]:
    """Load a checkpoint into ``state`` (its model, optimizer and step, in
    place, on the model's device); returns (state, epoch, global_iter)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), int(payload["global_iter"])


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``epoch_*`` checkpoint of the highest epoch in a directory, or
    None."""
    if not os.path.isdir(directory):
        return None
    epochs = {}
    for d in os.listdir(directory):
        head, _, num = d.partition("_")
        if head == "epoch" and num.isdigit():
            epochs[int(num)] = d
    if not epochs:
        return None
    return os.path.join(directory, epochs[max(epochs)])
