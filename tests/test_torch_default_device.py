"""The port's entry points default to the GPU: without one and without an
explicit ``device="cpu"`` they raise a clear error and never carry on on
the CPU; with ``device="cpu"`` they work.  The two commands are called
through their ``main(argv)``, with ``--device cpu`` for ``device="cpu"``
(and TensorFlow hidden: ``torch.utils.tensorboard`` loads it where it is
installed, seconds to import; the GPU host has none).  The loop and
``cli.train`` run no epoch here (their steps are tested in
``test_torch_train_loop.py`` and ``test_torch_eval_cli.py``), and
``cli.test`` one measured capture."""

import dataclasses
import os
import sys
import tempfile

import numpy as np
import pytest
import torch
from scipy.io import savemat

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.cli import test as cli_test
from hiddenpose_tpu_torch.cli import train as cli_train
from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.data.dataset import SyntheticSource
from hiddenpose_tpu_torch.eval.harness import evaluate
from hiddenpose_tpu_torch.graft_entry import dryrun_multichip, entry
from hiddenpose_tpu_torch.models.deepvoxels import build_deepvoxels
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.models.posenet3d import build_posenet3d
from hiddenpose_tpu_torch.models.sformer import build_sformer
from hiddenpose_tpu_torch.models.timesformer import build_timesformer
from hiddenpose_tpu_torch.models.tokenpose import build_tokenpose
from hiddenpose_tpu_torch.ops.lct import make_lct_params
from hiddenpose_tpu_torch.ops.resample import MultiViewResampler
from hiddenpose_tpu_torch.parallel import distributed
from hiddenpose_tpu_torch.parallel.mesh import Mesh
from hiddenpose_tpu_torch.serve import InferenceServer
from hiddenpose_tpu_torch.train.loop import train
from hiddenpose_tpu_torch.train.state import TrainState
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

CFG = Config().tiny(16)
TS_KW = dict(dim=16, num_frames=2, image_size=8, patch_size=4, channels=1,
             depth=1, heads=2, dim_head=8)
TP_KW = dict(feature_size=(8, 8), patch_size=(4, 4), num_keypoints=2, dim=8,
             channels=2, depth=1, heads=2, heatmap_size=(4, 4))


def _server(**kw):
    srv = InferenceServer(CFG, batch_size=1, **kw)
    srv.close()
    return srv.device


def _train(**kw):
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(
            CFG, num_workers=0, log_dir=tmp,
            train=dataclasses.replace(CFG.train, end_epoch=0))
        result = train(cfg, source=SyntheticSource(cfg, length=2),
                       workdir=tmp, **kw)
        return next(result.state.model.parameters()).device


def _evaluate(**kw):
    model, lct = build_nlospose(CFG.model, device="cpu")
    out = evaluate(model, TrainState.create(model, CFG.train), lct,
                   SyntheticSource(CFG, length=2), num_workers=0, **kw)
    assert out["n_samples"] == 2
    return next(model.parameters()).device


def _argv(kw):
    return ["--device", "cpu"] if kw.get("device") == "cpu" else []


def _cli_train(**kw):
    with tempfile.TemporaryDirectory() as tmp:
        result = cli_train.main([
            "--synthetic", "--size", "16", "--epochs", "0", "--model", tmp,
            "--log", tmp, *_argv(kw)])
        return next(result.state.model.parameters()).device


def _cli_test(**kw):
    with tempfile.TemporaryDirectory() as tmp:
        mat = os.path.join(tmp, "capture.mat")
        savemat(mat, {"data_new": np.random.RandomState(0).rand(32, 32, 32)})
        return torch.device(cli_test.main([
            "--test", "test_realdata", "--data", mat, "--size", "16",
            "--model", tmp, "--out", tmp, *_argv(kw)])["device"])


ENTRY_POINTS = {
    "build_nlospose": lambda **kw: next(
        build_nlospose(CFG.model, **kw)[0].parameters()).device,
    "build_nlospose posenet2d": lambda **kw: next(build_nlospose(
        dataclasses.replace(CFG.model, backbone="posenet2d"),
        **kw)[0].parameters()).device,
    "build_deepvoxels": lambda **kw: next(build_deepvoxels(
        basedim=2, image_size=8, time_size=8, **kw)[0].parameters()).device,
    "build_posenet3d basic": lambda **kw: next(build_posenet3d(
        block="basic", layers=(1, 1, 1, 1), widths=(8, 8, 8, 8),
        conv1_t_stride=2, no_max_pool=True, **kw).parameters()).device,
    "MultiViewResampler": lambda **kw: MultiViewResampler(
        4, 4, 2.0, **kw).view_grids.device,
    "build_tokenpose": lambda **kw: next(
        build_tokenpose(**TP_KW, **kw).parameters()).device,
    "InferenceServer": _server,
    "make_lct_params": lambda **kw: make_lct_params(16, 16, 0.04,
                                                    **kw).mtx.device,
    "build_sformer": lambda **kw: next(
        build_sformer(CFG.model, **kw).parameters()).device,
    "build_timesformer": lambda **kw: next(
        build_timesformer(**TS_KW, **kw).parameters()).device,
    "train": _train,
    "evaluate": _evaluate,
    "initialize": lambda **kw: (distributed.initialize(**kw),
                                distributed.local_device(**kw))[1],
    "build_nlospose spatial_mesh": lambda **kw: next(build_nlospose(
        CFG.model, spatial_mesh=Mesh(1, 1, 0, (None, None),
                                     torch.device("cpu")),
        **kw)[0].parameters()).device,
    "entry": lambda **kw: entry(**kw)[1][1].device,
    "dryrun_multichip": lambda **kw: torch.device(
        dryrun_multichip(1, **kw)["device"]),
    "cli.train": _cli_train,
    "cli.test": _cli_test,
}


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_gpu(name):
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert build().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert build(device="cpu").type == "cpu"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda:0")
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(None)  # None is the GPU
    else:
        assert resolve_device(None).type == "cuda"
