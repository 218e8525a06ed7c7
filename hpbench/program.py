"""The program under test as the benchmark drives it: the configuration,
the server, the model and the train step of ``hiddenpose_tpu_torch``, and
its kernel launch counters.  With ``faults.py``, which breaks it for the
checks' tests, the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def port_config(cfg: Dict[str, Any]):
    """The program's ``Config`` with the fields the configuration file
    sets on its ``ModelConfig`` and ``TrainConfig`` (an unknown field
    raises)."""
    from hiddenpose_tpu_torch.config import Config, ModelConfig, TrainConfig

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    train = {k: v for k, v in cfg["train"].items() if k != "steps_per_epoch"}
    return dataclasses.replace(Config(), model=ModelConfig(
        **fields(cfg["model"])), train=TrainConfig(**fields(train)))


def server(cfg: Dict[str, Any], weights, device):
    from hiddenpose_tpu_torch.serve import InferenceServer

    s = cfg["serve"]
    return InferenceServer(port_config(cfg), state_dict=weights,
                           batch_size=int(s["batch_size"]), dtype=s["dtype"],
                           max_wait_ms=float(s["max_wait_ms"]),
                           device=device)


def train_step(cfg: Dict[str, Any], weights, device):
    """(model, LCT constants, train state, step function) of the train
    configuration, the model holding ``weights``."""
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step

    pc = port_config(cfg)
    model, lct = build_nlospose(pc.model, device=device)
    model.load_state_dict(weights)
    state = TrainState.create(model, pc.train, steps_per_epoch=int(
        cfg["train"]["steps_per_epoch"]))
    return model, lct, state, make_train_step(model, pc.train.matmul_precision)


def launch_counts() -> Dict[str, int]:
    from hiddenpose_tpu_torch.ops import kernels

    return kernels.launch_counts()


def build_seconds() -> float:
    from hiddenpose_tpu_torch.ops.kernels import _build

    return float(_build.build_seconds)


def optimizer_first_moments(state):
    """{parameter: Adam's first moment} of the program's train state."""
    opt = state.optimizer
    return {p: opt.state[p]["exp_avg"] for g in opt.param_groups
            for p in g["params"] if p in opt.state}

