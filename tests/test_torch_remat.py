"""The three rematerialisation knobs (``cfg.stage_remat``,
``cfg.posenet_remat``, ``cfg.posenet_remat_stem``; ``utils/remat.py``).

One train step of the tiny(32) NlosPose (``tests/test_torch_train_step.
py``'s weights and batch: the peaked weights carried through the JAX
package's ``convert_state_dict``, ``make_batch([0, 1])``) with every knob
off, with each knob on alone and with all three on:

* on the CPU a recompute runs the same ops on the same inputs, so each
  knob's step equals the step without it **bit for bit**: the losses, the
  gradients, the new parameters and every BatchNorm buffer;
* the buffers are updated once (``num_batches_tracked`` 1 after the
  step, the running statistics those of one update), though the
  recompute runs each BatchNorm's forward again;
* the recompute does run: the kernels' plain versions (which the CPU
  runs) are called again in the backward, by as many calls as the
  recomputed forward makes;
* the step with all three knobs against the JAX package's step with the
  same three knobs, at ``tests/test_torch_train_step.py``'s limits (the
  losses 1e-4 relative, the new statistics 1e-3 of each tensor's max,
  the gradients 0.15 relative L2 over all and 0.25 by module).  One JAX
  step with the three knobs is compiled (each knob's port step equals the
  all-on step bit for bit, so it stands for each).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import Config as JaxConfig
from hiddenpose_tpu.config import TrainConfig as JaxTrainConfig
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_train_step as jax_make_train_step
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config, TrainConfig
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.ops.kernels import conv3p, phase_pool
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax, to_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

SIZE = 32
OFF = dict(stage_remat=False, posenet_remat=False, posenet_remat_stem=False)
CASES = {"off": OFF, "stage_remat": dict(OFF, stage_remat=True),
         "posenet_remat": dict(OFF, posenet_remat=True),
         "posenet_remat_stem": dict(OFF, posenet_remat_stem=True),
         "all": dict(stage_remat=True, posenet_remat=True,
                     posenet_remat_stem=True)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(a, b, keys):
    num = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2)
                      for k in keys))
    den = np.sqrt(sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys))
    return num / den


def _model_cfg(**knobs):
    return dataclasses.replace(Config().tiny(SIZE).model, **knobs)


@pytest.fixture(scope="module")
def setup():
    with torch.device("meta"):
        template = NlosPose(_model_cfg())
    tree = convert_state_dict({k: v.numpy() for k, v in peaked_state_dict(
        template, 1).items()}, strict=True)
    m = _model_cfg()
    batch = make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                       m.heatmap_size[0], m.bin_len)
    return tree, batch


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.fixture(scope="module")
def port_steps(setup):
    """One port step a case: losses, gradients, new parameters and
    buffers, and the calls of the plain versions of K1 (``conv3_planes``)
    and K3 (the stem pool) in the step."""
    tree, batch = setup
    weights = state_dict_from_jax(tree)
    model, lct = build_nlospose(_model_cfg(**OFF), device="cpu")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for case, knobs in CASES.items():
            calls = {}
            # the knobs are read at each forward: NlosPose's cfg, its
            # PoseNet3D's remat and remat_stem
            model.cfg = _model_cfg(**knobs)
            model.pose_net.remat = knobs["posenet_remat"]
            model.pose_net.remat_stem = knobs["posenet_remat_stem"]
            with mp.context() as m:
                _counting(m, conv3p, "conv3_planes_ref", calls)
                _counting(m, phase_pool, "maxpool3d_k3s2p1_ref", calls)
                model.load_state_dict(weights)
                state = TrainState.create(model, TrainConfig())
                metrics = make_train_step(model)(
                    state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    lct)
            out[case] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad.clone() for n, p in
                       model.named_parameters()},
                params={n: p.detach().clone() for n, p in
                        model.named_parameters()},
                buffers={n: b.clone() for n, b in model.named_buffers()},
                calls=calls)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", ["stage_remat", "posenet_remat",
                                  "posenet_remat_stem", "all"])
def test_knob_step_equals_the_step_without(port_steps, case):
    got, want = port_steps[case], port_steps["off"]
    assert got["metrics"] == want["metrics"]
    for what in ("grads", "params", "buffers"):
        assert got[what].keys() == want[what].keys()
        for n, t in want[what].items():
            assert torch.equal(got[what][n], t), (what, n)


@pytest.mark.parametrize("case", ["stage_remat", "posenet_remat",
                                  "posenet_remat_stem", "all"])
def test_buffers_updated_once(port_steps, case):
    """After one step every BatchNorm counts one batch, and its running
    statistics are one update from their start (0.9 x 0 + 0.1 x mean,
    0.9 x 1 + 0.1 x var: the same as the step without the knob, which
    the test above holds bit for bit, and not two updates' values)."""
    bufs = port_steps[case]["buffers"]
    tracked = [n for n in bufs if n.endswith("num_batches_tracked")]
    assert len(tracked) > 50
    assert all(int(bufs[n]) == 1 for n in tracked)


@pytest.mark.parametrize("case", ["stage_remat", "posenet_remat_stem"])
def test_recompute_runs_the_kernels_again(port_steps, case):
    """Stage remat calls K1's plain version again for every
    FeatureExtraction and UNet conv (the forward's calls twice); stem
    remat calls the stem pool's again (one call more)."""
    got, off = port_steps[case]["calls"], port_steps["off"]["calls"]
    if case == "stage_remat":
        assert got["conv3_planes_ref"] == 2 * off["conv3_planes_ref"] > 0
        assert got["maxpool3d_k3s2p1_ref"] == off["maxpool3d_k3s2p1_ref"]
    else:
        assert got["conv3_planes_ref"] == off["conv3_planes_ref"]
        assert (got["maxpool3d_k3s2p1_ref"]
                == off["maxpool3d_k3s2p1_ref"] + 1)


@pytest.fixture(scope="module")
def jax_all(setup):
    """The JAX package's step with the three knobs on, from the same
    weights and batch, at 'highest'."""
    tree, batch = setup
    cfg = dataclasses.replace(JaxConfig().tiny(SIZE).model,
                              **CASES["all"])
    jmodel, jlct = jax_build(cfg)
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    step = jax_make_train_step(jmodel, donate=False,
                               matmul_precision="highest")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jlct)
    adam = new.opt_state[0]
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={k: v / np.float32(0.1) for k, v in
                       _flat(adam.mu).items()},
                stats=_flat(new.batch_stats))


def test_all_knobs_step_matches_jax(port_steps, jax_all):
    port = port_steps["all"]
    for k, v in jax_all["metrics"].items():
        np.testing.assert_allclose(port["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    sd = {n: t for n, t in port["buffers"].items()}
    stats = _flat(convert_state_dict(
        {n: t.numpy() for n, t in {**port["params"], **sd}.items()},
        strict=True)["batch_stats"])
    for k, v in jax_all["stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=k)
    grads = _flat(to_jax(port["grads"]))
    want = jax_all["grads"]
    assert grads.keys() == want.keys()
    assert _rel_l2(grads, want, want) < 0.15
    for module in ("feature_extraction", "autoencoder", "pose_net"):
        keys = [k for k in want if k.startswith(f"['{module}']")]
        assert _rel_l2(grads, want, keys) < 0.25, module
