"""The port's multi-process start-up and the ``--multihost`` command
(``hiddenpose_tpu_torch/parallel/distributed.py``, ``cli/train.py``,
``train/loop.py``), on gloo processes on the CPU, each job with its own
time limit (``tests/torch_gloo.py``).

* ``initialize()`` from ``HP_COORDINATOR`` / ``HP_NUM_PROCESSES`` /
  ``HP_PROCESS_ID`` and from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``
  / ``WORLD_SIZE`` / ``RANK``; nothing for one process; a second call
  does nothing.
* The JAX package's two-process check (``tests/test_multihost.py``:
  disjoint shards of a pipeline, the same all-reduced gradient on both
  processes within rtol 1e-6 / atol 1e-7, equal to one process's
  gradient over the union within rtol 1e-5 / atol 1e-6) on its linear
  model, through the port's pipeline sharding and gradient average.
* Two ``python -m hiddenpose_tpu_torch.cli.train --multihost --device cpu
  --synthetic --size 16`` ranks, one step each: disjoint batches, the
  same averaged gradient on both ranks bit for bit, and the step equal to
  one process's step on the union of the two batches.  That comparison
  runs the whole NlosPose, whose step at tiny(16) is ill-conditioned (a
  reduction in another order moves its gradients by a few percent:
  ``tests/test_torch_train_step.py``), so it is held at the JAX package's
  limits for a data-parallel step (the loss within 5e-4 relative, the
  voxel loss 1e-5) and the gradients at ``tests/test_torch_train_step.py``'s
  (0.15 relative L2 over all, 0.25 by module; readings about 0.04-0.08).
* Rank 0 alone writes the log, the metrics and the checkpoint, which
  holds the whole model and restores in one process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hiddenpose_tpu_torch.config import default_config
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.parallel import distributed
from hiddenpose_tpu_torch.train import checkpoint as ckpt
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from torch_gloo import (
    TESTS,
    free_port,
    load_and_delete,
    rank_env,
    run_ranks,
    wait_all,
)
from torch_parallel_workers import IdSource

SIZE = 16


def _launch(args, envs, timeout):
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_parallel_workers.py"), *args],
        env={**rank_env(), **env}, cwd=str(TESTS),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for env in envs]
    outs = wait_all(procs, timeout)
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)


def _clean_env():
    return {k: "" for k in ("HP_COORDINATOR", "HP_NUM_PROCESSES",
                            "HP_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                            "WORLD_SIZE", "RANK", "LOCAL_RANK")}


@pytest.mark.parametrize("source", ["hp", "torchrun"])
def test_initialize_from_the_environment(tmp_path, source):
    port = free_port()
    if source == "hp":
        envs = [dict(_clean_env(), HP_COORDINATOR=f"127.0.0.1:{port}",
                     HP_NUM_PROCESSES="2", HP_PROCESS_ID=str(r))
                for r in range(2)]
    else:
        envs = [dict(_clean_env(), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r)) for r in range(2)]
    _launch(["init", str(tmp_path)], envs, timeout=120)
    for r in range(2):
        out = load_and_delete(tmp_path / f"rank{r}.pt")
        assert out == {"rank": r, "world": 2, "backend": "gloo",
                       "info": (r, 2), "sum": 3.0, "device": "cpu"}


def test_initialize_leaves_one_process_alone(monkeypatch):
    for k in _clean_env():
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("HP_NUM_PROCESSES", "1")
    monkeypatch.setenv("HP_COORDINATOR", "127.0.0.1:1")
    distributed.initialize(device="cpu")
    assert not dist.is_initialized()
    assert distributed.process_info() == distributed.ShardInfo(0, 1)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("HP_NUM_PROCESSES", "2")
    monkeypatch.delenv("HP_COORDINATOR")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")


def test_two_process_linear_dp_matches_one_process(tmp_path):
    out = run_ranks("torch_parallel_workers:linear_dp", 2, tmp_path,
                    args=[2], timeout=120)
    ids0, ids1 = set(out[0]["ids"]), set(out[1]["ids"])
    assert len(ids0) == len(ids1) == 8 and not ids0 & ids1
    g0, g1 = out[0]["grad"].numpy(), out[1]["grad"].numpy()
    np.testing.assert_allclose(g0, g1, rtol=1e-6, atol=1e-7)
    src = IdSource(16)
    ids = out[0]["ids"] + out[1]["ids"]
    x, y = src.x[ids], src.y[ids]
    want = 2.0 * x.T @ (x @ np.zeros((4, 1), np.float32) - y) / len(ids)
    np.testing.assert_allclose(g0, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two ranks of the command, one step, and one process's step on the
    union of their batches from the same seeded weights.  The checkpoint
    (about 1 GB at full width) is deleted after the module's tests."""
    tmp = tmp_path_factory.mktemp("multihost")
    work = tmp / "work"
    port = free_port()
    envs = [dict(_clean_env(), HP_COORDINATOR=f"127.0.0.1:{port}",
                 HP_NUM_PROCESSES="2", HP_PROCESS_ID=str(r),
                 OMP_NUM_THREADS="1") for r in range(2)]
    try:
        _launch(["cli", str(tmp), str(work), str(SIZE)], envs, timeout=300)
        ranks = [load_and_delete(tmp / f"rank{r}.pt") for r in range(2)]
    except BaseException:
        _delete_files(work)
        raise

    cfg = default_config().tiny(SIZE)
    model, lct = build_nlospose(cfg.model, device="cpu", seed=cfg.train.seed)
    state = TrainState.create(model, cfg.train)
    batch = {k: torch.cat([r["batch"][k] for r in ranks])
             for k in ranks[0]["batch"]}
    metrics = make_train_step(model)(state, batch, lct)
    one = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad for n, p in model.named_parameters()}}
    yield {"ranks": ranks, "one": one, "work": work, "cfg": cfg}
    _delete_files(work)


def _delete_files(directory):
    for path in directory.rglob("*"):
        if path.is_file():
            path.unlink()


def test_cli_ranks_take_disjoint_batches(cli_run):
    b0, b1 = (r["batch"] for r in cli_run["ranks"])
    assert b0["meas"].shape[0] == b1["meas"].shape[0] == 2
    for i in range(2):
        for j in range(2):
            assert not torch.equal(b0["meas"][i], b1["meas"][j])


def test_cli_ranks_apply_one_gradient(cli_run):
    """Both ranks applied the same gradient and hold the same state, bit
    for bit (rank 1's tensors by their digests)."""
    r0, r1 = cli_run["ranks"]
    assert len(r0["grad_digest"]) == len(r0["grads"]) > 100
    assert r0["grad_digest"] == r1["grad_digest"]
    assert r0["state_digest"] == r1["state_digest"]


def _rel_l2(a, b, keys):
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in keys)
    den = sum(float(b[k].double().pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_cli_step_is_the_step_on_the_union(cli_run):
    got, want = cli_run["ranks"][0], cli_run["one"]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=5e-4)
    np.testing.assert_allclose(got["metrics"]["voxel_loss"],
                               want["metrics"]["voxel_loss"], rtol=1e-5)
    g, w = got["grads"], want["grads"]
    assert _rel_l2(g, w, list(w)) < 0.15
    for module in ("feature_extraction", "autoencoder", "pose_net"):
        keys = [k for k in w if k.startswith(module)]
        assert _rel_l2(g, w, keys) < 0.25, module


def test_rank0_alone_writes_and_the_checkpoint_restores(cli_run):
    work = cli_run["work"]
    assert sorted(p.name for p in work.iterdir()) == ["epoch_0", "log"]
    logs = sorted(p.name for p in (work / "log").iterdir())
    assert "metrics.jsonl" in logs
    assert sum(n.endswith(".log") for n in logs) == 1
    cfg = cli_run["cfg"]
    model, _ = build_nlospose(cfg.model, device="cpu", seed=1)
    state = TrainState.create(model, cfg.train)
    state, epoch, global_iter = ckpt.restore_checkpoint(
        str(work / "epoch_0"), state)
    assert (epoch, global_iter, state.step) == (0, 1, 1)
    for k, v in cli_run["ranks"][0]["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert len(state.optimizer.state) == len(list(model.parameters()))
