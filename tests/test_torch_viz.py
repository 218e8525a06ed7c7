"""The port's figures (``hiddenpose_tpu_torch/viz``) against the JAX
package's: the same files under the same names, and the same arrays
drawn.  Every matplotlib call that draws data (``imshow``, ``scatter``,
``plot``) is recorded while each package draws the same inputs; the two
records must agree call for call (exactly: both compute the same numpy
reductions in float32 on the host).  Then the train loop's figures
(``log_visuals``, the JAX loop's ``_log_visuals``) on one batch, the
model stubbed to return the same heatmaps and refinement on both sides
(the predicted skeleton within 1e-6: each package's own soft-argmax),
and its histograms of the parameters under the JAX tree's tags.
"""

import os
import sys
import types

import matplotlib
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

matplotlib.use("Agg")

import matplotlib.axes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from mpl_toolkits.mplot3d import Axes3D  # noqa: E402

from hiddenpose_tpu.train import loop as jax_loop  # noqa: E402
from hiddenpose_tpu.viz import heatmap3d as jax_heatmap3d  # noqa: E402
from hiddenpose_tpu.viz import visualizer as jax_viz  # noqa: E402
from hiddenpose_tpu_torch.config import Config  # noqa: E402
from hiddenpose_tpu_torch.models.nlospose import NlosPose  # noqa: E402
from hiddenpose_tpu_torch.train import loop  # noqa: E402
from hiddenpose_tpu_torch.utils.jax_bridge import to_jax  # noqa: E402
from hiddenpose_tpu_torch.viz import heatmap3d, visualizer  # noqa: E402


@pytest.fixture
def drawn(monkeypatch):
    """A list that collects (call, arrays) for every data-drawing call."""
    calls = []

    def spy(cls, name):
        real = getattr(cls, name)

        def call(self, *args, **kw):
            arrays = [np.asarray(a, np.float64) for a in args
                      if isinstance(a, (np.ndarray, list, tuple))]
            if "c" in kw and not isinstance(kw["c"], str):
                arrays.append(np.asarray(kw["c"], np.float64))
            calls.append((name, arrays))
            return real(self, *args, **kw)

        monkeypatch.setattr(cls, name, call)

    for name in ("imshow", "scatter", "plot"):
        spy(matplotlib.axes.Axes, name)
    for name in ("scatter", "plot"):
        spy(Axes3D, name)
    return calls


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_calls(a, b, rtol=0.0):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (_, xa), (_, xb) in zip(a, b):
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            np.testing.assert_allclose(u, v, rtol=rtol, atol=0)


def _draw_both(drawn, tmp_path, fn_name, *args, **kw):
    out = {}
    for tag, mod in (("jax", jax_viz), ("port", visualizer)):
        if fn_name == "plot_heatmap3d":
            mod = jax_heatmap3d if tag == "jax" else heatmap3d
        drawn.clear()
        d = tmp_path / tag
        path = getattr(mod, fn_name)(*args[:1], str(d), *args[1:], **kw)
        out[tag] = (os.path.relpath(path, d), list(drawn), _files(d))
    return out


VOL = np.random.RandomState(0).randn(1, 1, 6, 7, 8).astype(np.float32)
JOINTS = np.random.RandomState(1).rand(24, 3).astype(np.float32) * 6


@pytest.mark.parametrize("fn_name,args,kw", [
    ("volume_log", ("vol", 3), dict(joints=JOINTS)),
    ("volume_log", ("vol", 0), {}),
    ("threeviews_log", ("views", 2), {}),
    ("joints_log", ("joints", 1), {}),
    ("plot_heatmap3d", ("hm",), dict(threshold=0.3, max_points=40)),
], ids=["volume_joints", "volume", "threeviews", "joints", "heatmap3d"])
def test_figures_match_jax(drawn, tmp_path, fn_name, args, kw):
    first = JOINTS if fn_name == "joints_log" else VOL
    out = _draw_both(drawn, tmp_path, fn_name, first, *args, **kw)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][2] == out["jax"][2]
    assert out["port"][1]  # something was drawn
    _same_calls(out["port"][1], out["jax"][1])


def test_figures_take_tensors(drawn, tmp_path):
    """A bf16 CUDA-or-CPU tensor is drawn as its float32 values."""
    t = torch.from_numpy(VOL).bfloat16()
    visualizer.threeviews_log(t, str(tmp_path / "a"), "v")
    a = list(drawn)
    drawn.clear()
    jax_viz.threeviews_log(t.float().numpy(), str(tmp_path / "b"), "v")
    _same_calls(a, drawn)


def test_joints_txt_is_written_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(visualizer, "_pyplot", lambda: (_ for _ in ()).throw(
        ImportError("no matplotlib")))
    with pytest.raises(ImportError):
        visualizer.joints_log(JOINTS, str(tmp_path), "j")
    np.testing.assert_allclose(np.loadtxt(tmp_path / "j.txt"), JOINTS,
                               rtol=1e-6)


class _Recorder:
    def __init__(self):
        self.hist = []

    def histogram(self, tag, values, step):
        self.hist.append((tag, np.asarray(values, np.float32), step))


def test_loop_figures_match_jax(drawn, tmp_path, monkeypatch):
    """One interval's figures of the loop, each package's model stubbed to
    return the same heatmaps and refinement; the histograms of the
    parameters under the same tags."""
    cfg = Config().tiny(16)
    rng = np.random.RandomState(2)
    hm = rng.randn(2, 24, 8, 8, 8).astype(np.float32)
    refine = rng.rand(2, 1, 16, 16, 16).astype(np.float32)
    batch = {"meas": rng.rand(2, 1, 16, 16, 16).astype(np.float32),
             "vol": rng.rand(2, 1, 16, 16, 16).astype(np.float32),
             "joints": rng.rand(2, 24, 3).astype(np.float32) * 8}

    model = NlosPose(cfg.model)
    model.forward = lambda meas, lct: (torch.from_numpy(hm),
                                       torch.from_numpy(refine))
    named = dict(model.named_parameters())
    records, files = {}, {}
    for tag in ("jax", "port"):
        drawn.clear()
        writer = _Recorder()
        c = cfg.__class__(**{**cfg.__dict__,
                             "result_dir": str(tmp_path / tag)})
        if tag == "jax":
            stub = types.SimpleNamespace(apply=lambda v, m, l, train: (
                hm, refine))
            state = types.SimpleNamespace(params=to_jax(named),
                                          batch_stats={})
            jax_loop._log_visuals(c, stub, state, batch, None, 7,
                                  writer=writer)
        else:
            tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
            loop.log_visuals(c, model, tbatch, None, 7, writer=writer)
        records[tag] = (list(drawn), writer.hist)
        files[tag] = _files(tmp_path / tag)
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 10  # 3 volume, 2 x (png + txt), 3 views
    # the predicted skeleton: each package's own soft-argmax of the same
    # heatmaps (held against each other in test_torch_nlospose.py), a few
    # ulps apart; every other array exactly
    _same_calls(records["port"][0], records["jax"][0], rtol=1e-6)
    hp, hj = records["port"][1], records["jax"][1]
    assert [h[0] for h in hp] == [h[0] for h in hj] and hp
    for (_, a, sa), (_, b, sb) in zip(hp, hj):
        assert sa == sb == 7
        np.testing.assert_array_equal(a, b)


def test_loop_figures_are_best_effort(tmp_path, monkeypatch, caplog):
    """A figure that fails (no matplotlib on the GPU host) is a warning,
    not a failed step."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = Config().tiny(16)
    model = NlosPose(cfg.model)
    model.forward = lambda meas, lct: (torch.zeros(1, 24, 8, 8, 8),
                                       torch.zeros(1, 1, 16, 16, 16))
    batch = {"meas": torch.zeros(1, 1, 16, 16, 16),
             "vol": torch.zeros(1, 1, 16, 16, 16),
             "joints": torch.zeros(1, 24, 3)}
    c = cfg.__class__(**{**cfg.__dict__, "result_dir": str(tmp_path)})
    with caplog.at_level("WARNING", logger="hiddenpose"):
        loop.log_visuals(c, model, batch, None, 1)
    assert "viz failed" in caplog.text
