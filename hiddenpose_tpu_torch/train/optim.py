"""Adam (or SGD) with the reference's MultiStep learning-rate schedule.

Port of ``hiddenpose_tpu/train/optim.py``.  The JAX package builds an optax
transform whose schedule reads the optimizer's update count; here the
schedule is a plain function of the same count, and
:meth:`hiddenpose_tpu_torch.train.state.TrainState.apply_gradients` writes
its value into the param groups before each ``optimizer.step()``.  It is
evaluated on the count BEFORE the update, as optax does.
``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8 is optax's
``adam`` formula: ``lr * m_hat / (sqrt(v_hat) + eps)``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import torch

from hiddenpose_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def multistep_lr(
    base_lr: float,
    milestones: Sequence[int],
    factor: float,
    steps_per_epoch: int,
    step_before_epoch: bool = True,
) -> Schedule:
    """torch MultiStepLR as a per-step schedule.

    ``step_before_epoch=True`` keeps the reference quirk of calling
    ``lr_scheduler.step()`` before each epoch's training: epoch e trains at
    ``base_lr * factor ** |{m in milestones : m <= e + 1}|``."""
    offset = 1 if step_before_epoch else 0
    ms = sorted(milestones)

    def schedule(count: int) -> float:
        scheduler_count = count // steps_per_epoch + offset
        return base_lr * factor ** sum(m <= scheduler_count for m in ms)

    return schedule


def make_optimizer(
    cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
    steps_per_epoch: int = 1,
) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer, schedule) for ``cfg``: Adam (b1 0.9, b2 0.999, eps 1e-8)
    or plain SGD, with the MultiStep schedule."""
    schedule = multistep_lr(cfg.lr, cfg.lr_step, cfg.lr_factor,
                            steps_per_epoch, cfg.step_before_epoch)
    lr = schedule(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                eps=1e-8), schedule
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr), schedule
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
