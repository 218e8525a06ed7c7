"""The port's train loop, checkpoints, frozen autoencoder and optimizer
carry, on the CPU at tiny sizes.

* a checkpoint round trip is bit for bit: parameters, BatchNorm
  statistics, Adam's moments and counts, ``step``, ``epoch`` and
  ``global_iter`` (of a small conv + BatchNorm model: a checkpoint of the
  full-width NlosPose is 1 GB, and the resume below restores three);
  ``latest_checkpoint`` picks the highest epoch;
* two epochs in one run against epoch 0 and a resume into epoch 1: the
  losses of epoch 1 and the final state are equal bit for bit (the CPU
  ops of the step are deterministic); phase ``continue_train`` resumes
  the latest epoch;
* a non-finite loss aborts the run at its window, before any checkpoint;
* the autoencoder save / load round trip, and the loop's pretrained
  autoencoder: loaded, frozen and outside the optimizer (the frozen step
  itself is held against the JAX package's in ``test_torch_pretrain.py``);
* Adam's state carried from optax (``jax_bridge.adam_state_from_jax``)
  gives optax's next update.

The loop against the JAX package's loop is ``test_torch_loop_parity.py``,
the frozen step against the JAX package's ``test_torch_pretrain.py``.
"""

import dataclasses
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.data.dataset import SyntheticSource
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.train import checkpoint as ckpt
from hiddenpose_tpu_torch.train.loop import train
from hiddenpose_tpu_torch.train.pretrain import (
    freeze_autoencoder,
    load_pretrained_autoencoder,
    save_autoencoder,
)
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.utils.jax_bridge import (
    adam_state_from_jax,
    from_jax,
    to_jax,
)
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 16


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    """The metric writer's TensorBoard events load TensorFlow where it is
    installed (seconds to import; the GPU host has none): hide it."""
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


@pytest.fixture
def tmp_path(tmp_path):
    """A checkpoint of the full-width model is about 1 GB (88M parameters
    and two Adam moments): delete them when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, **train_kw):
    cfg = Config().tiny(SIZE)
    return dataclasses.replace(
        cfg, num_workers=0, log_dir=str(tmp_path / "log"),
        train=dataclasses.replace(cfg.train, **train_kw))


def _small_state(seed, steps):
    """A conv + BatchNorm model from ``seed`` (channels-last, as the
    PoseNet's) and its Adam state after ``steps`` steps."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(
        torch.nn.Conv3d(1, 4, 3), torch.nn.BatchNorm3d(4),
        torch.nn.Conv3d(4, 2, 1)).to(memory_format=torch.channels_last_3d)
    state = TrainState.create(model, Config().train)
    for _ in range(steps):
        state.optimizer.zero_grad()
        model(torch.randn(2, 1, 6, 6, 6)).square().mean().backward()
        state.apply_gradients()
    return state


def _assert_states_equal(a: TrainState, b: TrainState):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    state = _small_state(seed=0, steps=2)
    path = ckpt.save_checkpoint(str(tmp_path), state, epoch=3,
                                global_iter=42)
    assert path == str(tmp_path / "epoch_3")
    assert os.listdir(tmp_path) == ["epoch_3"]  # no temporary file left
    fresh = _small_state(seed=1, steps=0)
    restored, epoch, giter = ckpt.restore_checkpoint(path, fresh)
    assert restored is fresh and (epoch, giter) == (3, 42)
    assert restored.step == 2
    _assert_states_equal(restored, state)

    for name in ("epoch_11", "iter_60", "epoch_x", ".epoch_12.tmp"):
        (tmp_path / name).write_text("")  # latest_checkpoint reads names
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_11")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def _records(log_dir, tag="Train Loss"):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in recs if r["tag"] == tag}


def test_resume_continues_bit_for_bit(tmp_path):
    """Epochs 0-1 in one run; then epoch 1 again, resumed from the first
    run's epoch_0: its losses and its final state equal the first run's
    (bit for bit: the CPU step is deterministic).  Last, phase
    ``continue_train`` without ``resume_from`` takes the latest
    ``epoch_*`` of the work directory: epoch_1, so with two epochs in all
    nothing is left to run."""
    cfg = _cfg(tmp_path / "a", end_epoch=2)
    whole = train(cfg, source=SyntheticSource(cfg, length=4),
                  workdir=str(tmp_path / "a"), log_every=1,
                  ckpt_every_iters=3, device="cpu")
    assert whole.epochs_run == 2 and whole.state.step == 4
    assert sorted(os.listdir(tmp_path / "a")) == ["epoch_0", "epoch_1",
                                                  "iter_3", "log"]
    losses = _records(cfg.log_dir)
    assert sorted(losses) == [1, 2, 3, 4]
    assert all(math.isfinite(v) for v in losses.values())
    assert sorted(_records(cfg.log_dir, "voxel_loss")) == [1, 2, 3, 4]
    assert len(whole.timings["step_s"]) == 4
    assert [os.path.basename(p) for p, _ in whole.timings["ckpt"]] == [
        "epoch_0", "iter_3", "epoch_1"]
    os.remove(tmp_path / "a" / "iter_3")

    cfg_b = dataclasses.replace(cfg, log_dir=str(tmp_path / "b" / "log"))
    resumed = train(cfg_b, source=SyntheticSource(cfg_b, length=4),
                    workdir=str(tmp_path / "b"),
                    resume_from=str(tmp_path / "a" / "epoch_0"),
                    log_every=1, device="cpu")
    assert resumed.epochs_run == 1 and resumed.state.step == 4
    assert _records(cfg_b.log_dir) == {3: losses[3], 4: losses[4]}
    assert resumed.last_metrics == whole.last_metrics
    _assert_states_equal(resumed.state, whole.state)
    del resumed
    shutil.rmtree(tmp_path / "b")

    cfg_c = dataclasses.replace(cfg, phase="continue_train",
                                log_dir=str(tmp_path / "c"))
    again = train(cfg_c, source=SyntheticSource(cfg_c, length=4),
                  workdir=str(tmp_path / "a"), device="cpu")
    assert again.epochs_run == 0 and again.last_metrics == {}
    assert again.state.step == 4
    _assert_states_equal(again.state, whole.state)


class PoisonedSource(SyntheticSource):
    def __getitem__(self, index):
        item = dict(super().__getitem__(index))
        item["meas"] = np.full_like(item["meas"], np.nan)
        return item


def test_train_loop_aborts_on_nonfinite_loss(tmp_path):
    """As ``tests/test_train.py``'s: a poisoned batch stops the loop at its
    window instead of saving a poisoned state."""
    cfg = _cfg(tmp_path, end_epoch=1)
    result = train(cfg, source=PoisonedSource(cfg, length=4),
                   workdir=str(tmp_path / "ckpt"), max_steps_per_epoch=3,
                   log_every=1, device="cpu")
    assert result.epochs_run == 0
    assert not math.isfinite(result.last_metrics["loss"])
    assert result.state.step == 1  # the first window aborted the run
    assert not os.path.exists(tmp_path / "ckpt")
    assert _records(cfg.log_dir) == {}


def test_viz_every_is_not_ported(tmp_path):
    """(The name predates the figures' port.)  ``viz_every`` draws the
    JAX loop's figures of the interval's batch under ``result_dir``
    (``tests/test_torch_viz.py`` holds them and ``viz_histograms``'
    histograms against the JAX loop's)."""
    cfg = dataclasses.replace(_cfg(tmp_path, end_epoch=1),
                              result_dir=str(tmp_path / "result"))
    result = train(cfg, source=SyntheticSource(cfg, length=2),
                   workdir=str(tmp_path / "ckpt"), max_steps_per_epoch=1,
                   viz_every=1, device="cpu")
    assert result.epochs_run == 1
    fig = tmp_path / "result" / "figure"
    assert sorted(os.listdir(fig / "volume")) == sorted(
        f"{t}_1.png" for t in ("volume", "output", "feature"))
    assert sorted(os.listdir(fig / "joints")) == sorted(
        f"{t}_joints_1.{e}" for t in ("pred", "gt") for e in ("png", "txt"))
    assert len(os.listdir(fig / "threeviews")) == 3


def test_autoencoder_save_load_round_trip(tmp_path):
    """Loaded weights replace the autoencoder's and nothing else."""
    cfg = Config().tiny(SIZE)
    src, _ = build_nlospose(cfg.model, device="cpu", seed=3)
    path = save_autoencoder(str(tmp_path / "unet.pth"), src)
    dst, _ = build_nlospose(cfg.model, device="cpu", seed=4)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    assert load_pretrained_autoencoder(path, dst) is dst
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        if k.startswith("autoencoder."):
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, before[k]), k
    # a state_dict of the whole model saves the same file contents
    again = save_autoencoder(str(tmp_path / "again.pth"), src.state_dict())
    a, b = torch.load(path), torch.load(again)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_train_with_a_pretrained_autoencoder(tmp_path):
    """The config knob loads and freezes (one loop step)."""
    cfg = Config().tiny(SIZE)
    donor, _ = build_nlospose(cfg.model, device="cpu", seed=9)
    path = save_autoencoder(str(tmp_path / "unet.pth"), donor)
    cfg = dataclasses.replace(
        _cfg(tmp_path, end_epoch=1),
        model=dataclasses.replace(cfg.model, pretrain_autoencoder=True,
                                  pretrain_autoencoder_path=path))
    result = train(cfg, source=SyntheticSource(cfg, length=2),
                   workdir=str(tmp_path / "ckpt"), device="cpu")
    assert result.state.step == 1
    want = donor.state_dict()
    for n, p in result.state.model.named_parameters():
        if n.startswith("autoencoder."):
            assert torch.equal(p, want[n]) and not p.requires_grad, n
            assert p not in result.state.optimizer.state


def test_adam_state_carried_from_optax_gives_optax_update():
    """The formula test of ``tests/test_torch_train_step.py`` on a carried
    state: optax's Adam at count 3 with random moments and gradients, and
    the port's Adam after ``adam_state_from_jax``, take the same step.
    Tolerance: 5e-5 of the update (optax forms 1 - 0.999^4 in float32,
    which alone is off by 1.5e-5 of itself; a count one off moves the
    update by 27%) plus 1e-7 (the new parameter's rounding)."""
    cfg = Config().tiny(SIZE)
    model, _ = build_nlospose(cfg.model, device="cpu", seed=2)
    named = dict(model.named_parameters())
    params = to_jax(named)
    # one draw, read at three offsets: mu, nu and the gradients differ
    # element by element (88M parameters: three draws cost seconds)
    leaves, treedef = jax.tree.flatten(params)
    total = sum(a.size for a in leaves)
    pool = np.random.default_rng(0).standard_normal(total + 2,
                                                    dtype=np.float32)

    def tree_at(offset, fn):
        out, at = [], offset
        for a in leaves:
            out.append(fn(pool[at:at + a.size]).reshape(a.shape))
            at += a.size
        return jax.tree.unflatten(treedef, out)

    mu = tree_at(0, lambda x: 1e-3 * x)
    nu = tree_at(1, lambda x: 1e-6 * x * x)
    grads = tree_at(2, lambda x: 1e-3 * x)
    lr, count = 1e-3, 3
    tx = optax.adam(lr)
    opt_state = (optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                                        mu=mu, nu=nu), optax.EmptyState())
    updates, new_opt = jax.jit(tx.update)(grads, opt_state, params)

    state = TrainState.create(model, cfg.train)
    adam_state_from_jax(state, mu, nu, count)
    assert state.step == count
    for n, g in from_jax(grads).items():
        named[n].grad = g
    state.schedule = lambda _: lr
    state.apply_gradients()
    assert int(new_opt[0].count) == state.step == count + 1

    def flat(tree):
        return {k: np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    p0, want_u, want_mu = flat(params), flat(updates), flat(new_opt[0].mu)
    got_p = flat(to_jax(named))
    got_mu = flat(to_jax({n: state.optimizer.state[p]["exp_avg"]
                          for n, p in named.items()}))
    for k, u in want_u.items():
        np.testing.assert_allclose(got_p[k] - p0[k], u, rtol=5e-5,
                                   atol=1e-7, err_msg=str(k))
        np.testing.assert_allclose(got_mu[k], want_mu[k], rtol=1e-6,
                                   atol=1e-9, err_msg=str(k))


def test_adam_state_carry_skips_frozen_parameters():
    cfg = Config().tiny(SIZE)
    model, _ = build_nlospose(cfg.model, device="cpu")
    state = TrainState.create(model, cfg.train,
                              params=freeze_autoencoder(model))
    zeros = jax.tree.map(np.zeros_like, to_jax(dict(
        model.named_parameters())))
    adam_state_from_jax(state, zeros, zeros, 5)
    for n, p in model.named_parameters():
        assert (p in state.optimizer.state) != n.startswith("autoencoder."), n
