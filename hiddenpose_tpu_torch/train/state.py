"""Training state: the model, its optimizer, the schedule and the step count.

Port of ``hiddenpose_tpu/train/state.py``.  The JAX package's state is an
immutable pytree that each step replaces; here it is PyTorch idiom: the
model's parameters and BatchNorm statistics and the optimizer's moments
are updated in place, and ``step`` counts the updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn

from hiddenpose_tpu_torch.config import TrainConfig
from hiddenpose_tpu_torch.train.optim import Schedule, make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, cfg: TrainConfig,
               steps_per_epoch: int = 1,
               params: Optional[Iterable[nn.Parameter]] = None
               ) -> "TrainState":
        """``params``: the parameters the optimizer updates (all of the
        model's by default; ``train/pretrain.py`` leaves the frozen
        autoencoder's out)."""
        optimizer, schedule = make_optimizer(
            cfg, model.parameters() if params is None else params,
            steps_per_epoch)
        return cls(model, optimizer, schedule)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, at the
        learning rate of the count before the update."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
