"""The train step at the JAX package's default precision and in bfloat16,
whole, on the CPU, against the JAX package (the module-level tests of the
same paths are ``tests/test_torch_train_precision.py``, which says how
the 'bwd' route and the bf16 model round).

* One f32 step at 'default' at tiny(32) (the JAX model routing 'bwd' with
  ``conv3mxu_enabled`` patched on, as ``tests/test_conv3mxu.py`` patches
  it): the tolerances of ``tests/test_torch_train_step.py`` at
  'highest', whose readings these match (loss 1e-5 relative against 1e-4,
  gradients 0.06 relative L2 against 0.15, per module 0.09 against 0.25,
  statistics 2e-4 of each max against 1e-3); and the step's rounding is
  real: its gradients lie farther from the port's 'highest' step than a
  1e-6 relative L2.
* One bf16 step at 'default' against the JAX bf16 step (JAX on its CPU
  routes, compiled as above).  Its losses lie no farther from the JAX
  bf16 step's than those lie from the JAX f32 step's, plus the port's
  own spread: how far its bf16 step's losses move when the measurement
  moves by 1e-6 (relative), the move that reads the JAX step's own spread
  below; both distances are read in the run (read: joint loss 5.15e-3
  against 3.33e-3 + 4.02e-3, at any thread count, since the port's CPU
  batch norm takes a contiguous input, ``flax_batch_norm``).  Its
  gradients, parameter updates and new statistics cannot be held so: at
  tiny(32) the bf16 step is chaotic.  The JAX bf16 step itself moves by a
  relative L2 of 1.32 in its gradients, 1.23 in its updates and 0.16 of a
  statistic's max when its measurement moves by 1e-6, as far as it lies
  from its f32 step (1.43, 1.26, 0.19).  So those are held within twice
  the larger of the two (read: the port at 1.36, 1.27, 0.21);
  FeatureExtraction's gradient, which the joint loss reaches through the
  min/max of the normalisation, flips its sign between such runs (cosine
  -0.99 to 0.99), so the modules' gradients are not held one by one.  A floor fails a zeroed or negated backward: at least 55% of
  the large gradient elements (above 1% of their tensor's max) share the
  JAX bf16 step's sign (read: 61%; the JAX step moved, 64%; bf16 against
  f32, 62%; negated, 39%).  And the port's bf16 step lies at least a
  tenth of the JAX bf16-f32 distance from its own f32 step, in every
  reading, so that an f32 path posing as bf16 fails.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hiddenpose_tpu.ops.pallas.conv3mxu as jax_conv3mxu
from hiddenpose_tpu.config import Config, TrainConfig as JaxTrainConfig
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_train_step as jax_make_train_step
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config as PortConfig, TrainConfig
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.ops.kernels import conv3mxu
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax, to_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 32


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_tree():
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(Config().tiny(SIZE).model)
    sd = peaked_state_dict(template, 1)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


def _batch(moved=False):
    """``make_batch([0, 1])`` at tiny(32); ``moved``: its measurement moved
    by 1e-6 (relative, a numpy seed), to read a step's own spread."""
    m = Config().tiny(SIZE).model
    batch = make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                       m.heatmap_size[0], m.bin_len)
    if moved:
        noise = np.random.RandomState(0).randn(*batch["meas"].shape)
        batch["meas"] = (batch["meas"] * (1 + 1e-6 * noise)).astype(
            np.float32)
    return batch


def _jax_steps(bf16, batches):
    """The JAX package's step at 'default' on each batch (one compile,
    without excess precision, as ``_exact_jit``)."""
    cfg = Config().tiny(SIZE)
    cfg = cfg.with_bf16() if bf16 else cfg
    tree = _jax_tree()
    jmodel, jlct = jax_build(cfg.model)
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    step = jax_make_train_step(jmodel, donate=False,
                               matmul_precision="default")
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    step = step.lower(state, batches[0], jlct).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out = []
    for batch in batches:
        new, metrics = step(state, batch, jlct)
        out.append(dict(
            loss={k: float(v) for k, v in metrics.items()},
            grads={k: v / np.float32(0.1)
                   for k, v in _flat(new.opt_state[0].mu).items()},
            params=_flat(new.params), stats=_flat(new.batch_stats)))
    return out


def _port_step(bf16, precision, moved=False):
    cfg = PortConfig().tiny(SIZE)
    cfg = cfg.with_bf16() if bf16 else cfg
    model, lct = build_nlospose(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(_jax_tree()))
    state = TrainState.create(model, TrainConfig())
    metrics = make_train_step(model, matmul_precision=precision)(
        state, {k: torch.from_numpy(v) for k, v in _batch(moved).items()},
        lct)
    named = dict(model.named_parameters())
    assert conv3mxu.current_precision() == "highest"  # restored after the step
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in named.values())
    return dict(
        loss={k: float(v) for k, v in metrics.items()},
        grads=_flat(to_jax({n: p.grad for n, p in named.items()})),
        params=_flat(to_jax(named)),
        stats=_flat(convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()},
            strict=True)["batch_stats"]))


@pytest.fixture(scope="module")
def steps(monkeypatch_module):
    """One step of each: the JAX package's at 'default' with its conv2
    router on (f32 and bf16 models), the port's at 'default' (both) and
    at 'highest' (f32); and each bf16 step again on the measurement moved
    by 1e-6."""
    monkeypatch_module.setattr(jax_conv3mxu, "conv3mxu_enabled",
                               lambda: True)
    for var in ("HP_CONV3MXU_ROUTE", "HP_CONV3MXU_DT", "HP_CONV3MXU_CIN",
                "HP_CONV3MXU_C512"):
        monkeypatch_module.delenv(var, raising=False)
    (jax32,) = _jax_steps(False, [_batch()])
    jax16, jax16_moved = _jax_steps(True, [_batch(), _batch(moved=True)])
    return dict(jax32=jax32, jax16=jax16, jax16_moved=jax16_moved,
                port32=_port_step(False, "default"),
                port16=_port_step(True, "default"),
                port16_moved=_port_step(True, "default", moved=True),
                port32_highest=_port_step(False, "highest"))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _rel_l2(a, b, keys):
    num = np.sqrt(sum(np.sum(np.square(a[k] - b[k], dtype=np.float64))
                      for k in keys))
    den = np.sqrt(sum(np.sum(np.square(b[k], dtype=np.float64))
                      for k in keys))
    return num / den


MODULES = ("feature_extraction", "autoencoder", "pose_net")


def _distances(a, b, params0):
    """How far step ``a`` lies from step ``b``: each loss (relative), the
    gradients (relative L2, over all and per module), the parameter updates
    (relative L2 of new - old) and the new statistics (max error over each
    tensor's max)."""
    g = b["grads"]
    out = {f"loss {k}": abs(a["loss"][k] - b["loss"][k]) / abs(b["loss"][k])
           for k in b["loss"]}
    sq = {}  # per module: (|a - b|^2, |b|^2)
    for k in g:
        mod = k.split("'")[1]
        d = np.sum(np.square(a["grads"][k] - g[k], dtype=np.float64))
        n = np.sum(np.square(g[k], dtype=np.float64))
        sq[mod] = (sq.get(mod, (0.0, 0.0))[0] + d,
                   sq.get(mod, (0.0, 0.0))[1] + n)
    out["grads"] = np.sqrt(sum(v[0] for v in sq.values())
                           / sum(v[1] for v in sq.values()))
    for mod in MODULES:
        out[f"grads {mod}"] = np.sqrt(sq[mod][0] / sq[mod][1])
    du = {k: a["params"][k] - params0[k] for k in params0}
    dv = {k: b["params"][k] - params0[k] for k in params0}
    out["updates"] = _rel_l2(du, dv, dv)
    out["stats"] = max(_rel(a["stats"][k], b["stats"][k]) for k in b["stats"])
    return out


def test_f32_default_step_matches_jax(steps):
    port, jx = steps["port32"], steps["jax32"]
    for k in jx["loss"]:
        np.testing.assert_allclose(port["loss"][k], jx["loss"][k], rtol=1e-4,
                                   err_msg=k)
    g = jx["grads"]
    assert _rel_l2(port["grads"], g, g) < 0.15
    for mod in MODULES:
        keys = [k for k in g if k.startswith(f"['{mod}']")]
        assert _rel_l2(port["grads"], g, keys) < 0.25, mod
    for k in jx["stats"]:
        assert _rel(port["stats"][k], jx["stats"][k]) <= 1e-3, k
    # the one bf16 pass of each routed dx moves the gradients upstream of
    # the conv2s
    hi = steps["port32_highest"]["grads"]
    assert _rel_l2(port["grads"], hi, hi) > 1e-6


def _sign_agreement(a, b):
    """Share of the gradient elements above 1% of their tensor's max in b
    whose sign a shares."""
    agree = total = 0
    for k, gb in b["grads"].items():
        big = np.abs(gb) > 1e-2 * np.abs(gb).max()
        agree += int(((np.sign(a["grads"][k]) == np.sign(gb)) & big).sum())
        total += int(big.sum())
    return agree / total


def test_bf16_default_step_matches_jax(steps):
    params0 = _flat(_jax_tree()["params"])
    ref = _distances(steps["jax16"], steps["jax32"], params0)
    moved = _distances(steps["jax16_moved"], steps["jax16"], params0)
    got = _distances(steps["port16"], steps["jax16"], params0)
    own = _distances(steps["port16"], steps["port32"], params0)
    # the port's own spread: its bf16 step on the moved measurement
    spread = _distances(steps["port16_moved"], steps["port16"], params0)
    for k in ref:
        assert np.isfinite(got[k]), k
        if k.startswith("loss"):
            assert got[k] <= ref[k] + spread[k], (k, got[k], ref[k],
                                                  spread[k])
        elif not k.startswith("grads "):
            # chaotic at this size: within twice the JAX bf16 step's own
            # spread (from its f32 step, or from itself on a measurement
            # moved by 1e-6)
            assert got[k] <= 2 * max(ref[k], moved[k]), (k, got[k], ref[k],
                                                        moved[k])
        # the port's bf16 step is not its f32 step
        assert own[k] >= 0.1 * ref[k], (k, own[k], ref[k])
    # a floor that a zeroed or negated backward fails: most large gradient
    # elements share the JAX bf16 step's sign
    assert _sign_agreement(steps["port16"], steps["jax16"]) >= 0.55
