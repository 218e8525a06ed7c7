"""Faults planted in the program under test, for the checks' tests and
for ``calibrate --fault``: the timed path broken underneath, the rest of
a run as it is.

* ``unchanged``: a train step that returns its state unchanged (the
  parameters, BatchNorm statistics and optimizer state put back);
* ``half_batch``: a train step given the first half of each batch, so
  the mean is taken over the rest;
* ``altered``: a serving answer altered where it is made (the first
  capture of every fifth forward moved by 8 heatmap voxels on each
  coordinate, 13.9 voxels in all).
"""

from __future__ import annotations

import contextlib

TRAIN = ("unchanged", "half_batch")
SERVE = ("altered",)


def _train_step(kind: str, made):
    def make(model, precision="highest", mesh=None):
        step = made(model, precision, mesh)

        def train_step(state, batch, lct):
            if kind == "half_batch":
                half = batch["meas"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()},
                            lct)
            before = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}
            out = step(state, batch, lct)
            state.model.load_state_dict(before)
            state.optimizer.state.clear()
            return out
        return train_step
    return make


def _forward(made):
    def make(model):
        fwd = made(model)
        calls = []

        def forward(meas, lct):
            joints, heat = fwd(meas, lct)
            calls.append(1)
            if len(calls) % 5 == 0:
                joints = joints.clone()
                joints[0] += 8.0
            return joints, heat
        return forward
    return make


@contextlib.contextmanager
def planted(kind: str):
    """The program with the fault ``kind`` for the duration of the
    block."""
    if kind in TRAIN:
        import hiddenpose_tpu_torch.train.step as mod
        name, broken = "make_train_step", _train_step(kind,
                                                      mod.make_train_step)
    elif kind in SERVE:
        import hiddenpose_tpu_torch.serve as mod
        name, broken = "make_forward", _forward(mod.make_forward)
    else:
        raise ValueError(f"no fault {kind!r}")
    made = getattr(mod, name)
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, made)
