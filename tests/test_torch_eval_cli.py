"""The port's evaluation and command line, on the CPU.

* ``mpjpe``, ``pa_mpjpe`` and ``pck`` against the JAX package's on random
  arrays (1e-12: the same float64 numpy);
* ``evaluate()`` at tiny(16) against the JAX package's ``evaluate`` on
  the same (converted) peaked weights and source, three samples in
  batches of two (a ragged tail): MPJPE and PA-MPJPE within 1e-4 voxel,
  PCK and the sample count equal (readings: 3e-10 and 8e-8 voxel of an
  MPJPE of 1.43);
* ``python -m hiddenpose_tpu_torch.cli.train`` then ``cli.test`` with
  ``--device cpu``: a checkpoint, the restore line, an MPJPE line and the
  joints files; ``cli.test --test test_realdata`` for both variants on a
  measured-capture-shaped fixture; and without ``--device cpu`` on a host
  with no GPU, a non-zero exit with ``resolve_device``'s message.

The commands run with TensorFlow hidden: ``torch.utils.tensorboard``
loads it where it is installed (seconds to import; the GPU host has
none).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import savemat

from hiddenpose_tpu.config import Config as JaxConfig
from hiddenpose_tpu.data.dataset import SyntheticSource as JaxSource
from hiddenpose_tpu.eval import harness as jax_harness
from hiddenpose_tpu.eval import metrics as jax_metrics
from hiddenpose_tpu.utils import logging as jax_logging
from hiddenpose_tpu.utils import meters as jax_meters
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.optim import make_optimizer as jax_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.cli import test as cli_test
from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.data.dataset import SyntheticSource
from hiddenpose_tpu_torch.eval import metrics
from hiddenpose_tpu_torch.eval.harness import evaluate
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.utils import logging as port_logging
from hiddenpose_tpu_torch.utils import meters
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 16
# runs a module as ``python -m`` would, with TensorFlow hidden
BOOT = ("import runpy, sys; sys.modules['tensorflow'] = None; "
        "runpy.run_module(sys.argv.pop(1), run_name='__main__', "
        "alter_sys=True)")


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


@pytest.mark.parametrize("name", ["mpjpe", "pa_mpjpe", "pck"])
@pytest.mark.parametrize("shape", [(4, 72), (3, 24, 3), (72,)])
def test_metrics_match_jax(name, shape):
    rng = np.random.RandomState(len(shape))
    pred = rng.randn(*shape) * 5
    gt = pred + rng.randn(*shape)
    args = (4.0,) if name == "pck" else ()
    got = getattr(metrics, name)(pred, gt, *args)
    want = getattr(jax_metrics, name)(pred, gt, *args)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_average_meter_matches_jax():
    got, want = meters.AverageMeter(), jax_meters.AverageMeter()
    for v, n in ((3.0, 2), (np.float32(1.5), 1), (-2, 4)):
        got.update(v, n)
        want.update(v, n)
        assert vars(got) == vars(want)
    got.reset()
    assert (got.avg, got.count) == (0.0, 0)


def test_metric_writer_records_match_jax(tmp_path):
    """The same ``metrics.jsonl`` records as the JAX writer's (``ts``
    aside), scalars and histograms; and the logger's file."""
    values = np.random.RandomState(0).randn(500).astype(np.float32)
    recs = []
    for name, mod in (("port", port_logging), ("jax", jax_logging)):
        w = mod.MetricWriter(str(tmp_path / name))
        w.scalar("Train Loss", np.float32(2.5), 7)
        w.histogram("params/w", values, 7, bins=16)
        w.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs.append([json.loads(line) for line in f])
    for r in recs[0] + recs[1]:
        assert isinstance(r.pop("ts"), float)
    assert recs[0] == recs[1]
    logger = port_logging.create_logger(str(tmp_path / "log"), phase="test")
    logger.info("iter 1 loss 2.50000")
    for h in logger.handlers:
        h.flush()
    (log_file,) = os.listdir(tmp_path / "log")
    assert log_file.startswith("hiddenpose_") and log_file.endswith(
        "_test.log")
    assert "iter 1 loss 2.50000" in (tmp_path / "log" / log_file).read_text()


def test_evaluate_matches_jax():
    cfg = Config().tiny(SIZE)
    with torch.device("meta"):
        template = NlosPose(cfg.model)
    weights = peaked_state_dict(template, seed=1)
    model, lct = build_nlospose(cfg.model, device="cpu")
    model.load_state_dict(weights)
    got = evaluate(model, TrainState.create(model, cfg.train), lct,
                   SyntheticSource(cfg, length=3), batch_size=2,
                   num_workers=0, device="cpu")

    jcfg = JaxConfig().tiny(SIZE)
    tree = convert_state_dict({k: v.numpy() for k, v in weights.items()},
                              strict=True)
    jmodel, jlct = jax_build(jcfg.model)
    jstate = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                  jax_optimizer(jcfg.train))
    want = jax_harness.evaluate(jmodel, jstate, jlct,
                                JaxSource(jcfg, length=3), batch_size=2,
                                num_workers=1)
    assert got["n_samples"] == want["n_samples"] == 3
    assert got["pred_joints"].shape == (3, 72)
    assert 0.5 < got["mpjpe"] < 20  # peaked weights: joints spread out
    for k in ("mpjpe", "pa_mpjpe"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert got["pck"] == want["pck"]


def test_evaluate_max_batches_and_device_check():
    cfg = Config().tiny(SIZE)
    model, lct = build_nlospose(cfg.model, device="cpu")
    state = TrainState.create(model, cfg.train)
    out = evaluate(model, state, lct, SyntheticSource(cfg, length=5),
                   batch_size=2, max_batches=1, num_workers=0, device="cpu")
    assert out["n_samples"] == 2 and np.isfinite(out["mpjpe"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            evaluate(model, state, lct, SyntheticSource(cfg, length=2))


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", BOOT, module, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_train_then_test_on_the_cpu(tmp_path):
    ck, log, out = (str(tmp_path / n) for n in ("ck", "log", "out"))
    try:
        r = _run("hiddenpose_tpu_torch.cli.train", "--synthetic", "--size",
                 str(SIZE), "--epochs", "1", "--steps-per-epoch", "2",
                 "--device", "cpu", "--model", ck, "--log", log)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "finished training: 1 epochs" in r.stdout
        assert os.listdir(ck) == ["epoch_0"]
        assert os.path.exists(os.path.join(log, "metrics.jsonl"))

        r = _run("hiddenpose_tpu_torch.cli.test", "--model", ck,
                 "--synthetic", "--size", str(SIZE), "--max-batches", "2",
                 "--device", "cpu", "--out", out)
        assert r.returncode == 0, r.stderr[-3000:]
        assert f"restored {ck}/epoch_0 (epoch 0)" in r.stdout
        assert "MPJPE (heatmap voxels):" in r.stdout
        # each skeleton's .txt and, as the JAX command draws it, its png
        files = sorted(os.listdir(os.path.join(out, "joints")))
        assert files == sorted(f"{p}_synthetic-{410 + i}.{e}"
                               for p in ("gt", "preds") for i in range(4)
                               for e in ("png", "txt"))
        joints = np.loadtxt(os.path.join(out, "joints", files[-1]))
        assert joints.shape == (24, 3) and np.isfinite(joints).all()
    finally:
        shutil.rmtree(ck, ignore_errors=True)  # a 1 GB checkpoint


def _write_realdata(path, h=32, w=32, t=64):
    """A measured-capture-shaped fixture (key ``data_new``, (h, w, t)), as
    tests/test_realdata_e2e.py's."""
    rng = np.random.RandomState(42)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    r2 = ((ys - h / 2.0) / h) ** 2 + ((xs - w / 2.0) / w) ** 2
    arrival = t * (0.3 + 0.8 * r2)
    ts = np.arange(t, dtype=np.float64)[None, None, :]
    shell = np.exp(-0.5 * ((ts - arrival[..., None]) / 2.0) ** 2)
    savemat(path, {"data_new": shell + 0.05 * rng.rand(h, w, t)})


@pytest.mark.parametrize("variant", ["nlospose", "sformer"])
def test_cli_test_realdata(tmp_path, variant):
    mat = str(tmp_path / "capture.mat")
    _write_realdata(mat)  # -> (16, 16, 16) after load_realdata
    out = str(tmp_path / "out")
    res = cli_test.main(["--test", "test_realdata", "--variant", variant,
                         "--data", mat, "--size", str(SIZE), "--device",
                         "cpu", "--model", str(tmp_path / "none"), "--out",
                         out])
    name = ("sformer_joints_capture" if variant == "sformer"
            else "pred_joints_capture")
    assert res["device"] == "cpu" and list(res["joints"]) == [name]
    joints = np.loadtxt(os.path.join(out, "joints", f"{name}.txt"))
    np.testing.assert_array_equal(joints, res["joints"][name])
    assert joints.shape == (24, 3) and np.isfinite(joints).all()
    assert joints.std(axis=0).max() > 0  # not one point


def test_cli_test_fk(tmp_path):
    """fk-dataset captures ((h, w, t) under 'meas'): two pair-averagings
    and a centred crop of T bins."""
    rng = np.random.RandomState(3)
    data = tmp_path / "fk"
    data.mkdir()
    savemat(str(data / "scene.mat"), {"meas": rng.rand(SIZE, SIZE, 128)})
    res = cli_test.main(["--test", "test_fk", "--data", str(data), "--size",
                         str(SIZE), "--device", "cpu", "--model",
                         str(tmp_path / "none"), "--out",
                         str(tmp_path / "out")])
    joints = res["joints"]["pred_joints_scene"]
    assert joints.shape == (24, 3) and np.isfinite(joints).all()
    assert os.path.exists(tmp_path / "out" / "joints" /
                          "pred_joints_scene.txt")


@pytest.mark.parametrize("module", ["hiddenpose_tpu_torch.cli.train",
                                    "hiddenpose_tpu_torch.cli.test"])
def test_cli_without_a_gpu_exits_non_zero(module):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the command would run for real")
    r = _run(module, "--synthetic", "--size", str(SIZE), timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert 'pass device="cpu"' in r.stderr
