"""The other objectives' train steps: the port (``hiddenpose_tpu_torch/
train/alt_steps.py``) against the JAX package's, one step each from the
same weights and batch.

* ``make_heatmap3d_step`` on NlosPose at tiny(32), the JAX
  ``TrainState`` against the port's (weights: the peaked recipe through
  ``convert_state_dict``, as ``test_torch_train_step.py``);
* ``make_heatmap2d_step`` on a narrow TokenPose against Gaussian targets
  from ``generate_gaussian_heatmap_2d``, optax's Adam against the port's
  ``torch.optim.Adam`` (``train/optim.py``);
* ``make_simdr_step`` on an ``NlosPoseSformer`` of depth 2 and dim 32,
  with bins past the end of the axis among the targets.

For the two steps that take parameters, a second step starts from the
JAX package's parameters and Adam state after the first, carried into a
fresh ``torch.optim.Adam`` by ``jax_bridge.load_adam``.

Tolerances.  The NlosPose step as ``test_torch_train_step.py`` (loss
1e-4 relative, statistics 1e-3 of a tensor's max, gradients 0.15
relative L2 over all and 0.25 a module: max-pool winners and ReLU masks
that a rounding flips).  The transformers have neither: loss 1e-5,
gradients 1e-4 relative L2.  New parameters, all steps: within 1e-6
where the two gradients agree within 25% and |g| >= 1e-5 (Adam's first
step is about lr x sign(g)), and 99% of the large gradient elements of
one sign.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hiddenpose_tpu.config import Config, TrainConfig as JaxTrainConfig
from hiddenpose_tpu.models import sformer as jax_sformer
from hiddenpose_tpu.models import tokenpose as jax_tokenpose
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train import alt_steps as jax_alt
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config as PortConfig, TrainConfig
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.data.targets import generate_gaussian_heatmap_2d
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.models.sformer import NlosPoseSformer
from hiddenpose_tpu_torch.models.tokenpose import TokenPose
from hiddenpose_tpu_torch.train import alt_steps
from hiddenpose_tpu_torch.train.optim import make_optimizer
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import (
    load_adam,
    sformer_params_to_jax,
    sformer_state_dict_from_jax,
    state_dict_from_jax,
    to_jax,
)
from hiddenpose_tpu_torch.utils.peaked import (
    peaked_state_dict,
    peaked_transformer_state_dict,
)

SIZE = 32
LR = 1e-3
TP_KW = dict(feature_size=(16, 16), patch_size=(4, 4), num_keypoints=5,
             dim=16, channels=8, depth=2, heads=2, mlp_ratio=3,
             hidden_heatmap_dim=64, heatmap_size=(16, 16))
SF_KW = dict(dim=32, num_frames=2, num_joints=4, image_size=16,
             patch_size=4, channels=1, depth=2, heads=2, dim_head=8,
             out_dim=64)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(a, b, keys=None):
    keys = list(b) if keys is None else keys
    num = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2)
                      for k in keys))
    den = np.sqrt(sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys))
    return num / den


def _check_new_params(port, jx):
    agree = total = 0
    for k, gj in jx["grads"].items():
        gp = port["grads"][k]
        close = (np.abs(gp - gj) <= 0.25 * np.abs(gj)) & (np.abs(gj) >= 1e-5)
        np.testing.assert_allclose(port["params"][k][close],
                                   jx["params"][k][close], rtol=0, atol=1e-6,
                                   err_msg=k)
        big = np.abs(gj) > 1e-2 * np.abs(gj).max()
        agree += int(((np.sign(gp) == np.sign(gj)) & big).sum())
        total += int(big.sum())
    assert total > 0 and agree >= 0.99 * total


# -- the 3D-heatmap step ------------------------------------------------------


def _nlos_batch():
    m = Config().tiny(SIZE).model
    return make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                      m.heatmap_size[0], m.bin_len)


@functools.lru_cache(maxsize=None)
def _nlos_tree():
    with torch.device("meta"):
        template = NlosPose(PortConfig().tiny(SIZE).model)
    sd = peaked_state_dict(template, 1)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


@pytest.fixture(scope="module")
def heatmap3d_pair():
    tree, batch = _nlos_tree(), _nlos_batch()
    jmodel, jlct = jax_build(Config().tiny(SIZE).model)
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    new, metrics = jax_alt.make_heatmap3d_step(jmodel)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jlct)
    jx = dict(loss=float(metrics["loss"]),
              grads={k: v / np.float32(0.1)
                     for k, v in _flat(new.opt_state[0].mu).items()},
              params=_flat(new.params), stats=_flat(new.batch_stats))

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model, lct = build_nlospose(PortConfig().tiny(SIZE).model, device="cpu")
    model.load_state_dict(state_dict_from_jax(tree))
    pstate = TrainState.create(model, TrainConfig())
    metrics = alt_steps.make_heatmap3d_step(model)(pstate, tbatch, lct)
    named = dict(model.named_parameters())
    port = dict(loss=float(metrics["loss"]),
                grads=_flat(to_jax({n: p.grad for n, p in named.items()})),
                params=_flat(to_jax(named)),
                stats=_flat(convert_state_dict(
                    {k: v.numpy() for k, v in model.state_dict().items()},
                    strict=True)["batch_stats"]),
                step=pstate.step, keys=set(metrics))

    # make_train_step's joint loss on the same weights and batch
    model.load_state_dict(state_dict_from_jax(tree))
    full = make_train_step(model)(TrainState.create(model, TrainConfig()),
                                  tbatch, lct)
    return dict(jax=jx, port=port, joint_loss=float(full["joint_loss"]))


def test_heatmap3d_loss_matches_jax(heatmap3d_pair):
    port, jx = heatmap3d_pair["port"], heatmap3d_pair["jax"]
    assert port["keys"] == {"loss"} and port["step"] == 1
    assert np.isfinite(port["loss"])
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=1e-4)


def test_heatmap3d_loss_is_the_joint_loss(heatmap3d_pair):
    """The joint loss alone: make_train_step's joint_loss on the same
    weights and batch, the same forward (1e-6 relative)."""
    np.testing.assert_allclose(heatmap3d_pair["port"]["loss"],
                               heatmap3d_pair["joint_loss"], rtol=1e-6)


def test_heatmap3d_statistics_and_gradients_match_jax(heatmap3d_pair):
    port, jx = heatmap3d_pair["port"], heatmap3d_pair["jax"]
    assert port["stats"].keys() == jx["stats"].keys()
    for k, v in jx["stats"].items():
        np.testing.assert_allclose(port["stats"][k], v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=k)
    assert port["grads"].keys() == jx["grads"].keys()
    assert _rel_l2(port["grads"], jx["grads"]) < 0.15
    for module in ("feature_extraction", "autoencoder", "pose_net"):
        keys = [k for k in jx["grads"] if k.startswith(f"['{module}']")]
        assert _rel_l2(port["grads"], jx["grads"], keys) < 0.25, module


def test_heatmap3d_new_params_match_jax(heatmap3d_pair):
    _check_new_params(heatmap3d_pair["port"], heatmap3d_pair["jax"])


# -- steps on parameters: 2D heatmaps and SimDR -------------------------------


def _tp_batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    joints = rng.uniform(-2, 18, (b, 5, 2))
    joints[1, 4] = 30.0  # off the map: weight 0, an all-zero target
    maps, weights = zip(*(generate_gaussian_heatmap_2d(
        j, heatmap_size=(16, 16), sigma=1.5) for j in joints))
    return {"feature": rng.randn(b, 8, 16, 16).astype(np.float32),
            "target_heatmaps": np.stack(maps),
            "target_weight": np.stack(weights)[..., 0]}


def _sf_batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, 16, (b, 4, 3)).astype(np.int32)
    bins[0, 0, 2], bins[1, 1, 2] = 20, 31  # past the end of the axis
    return {"video": rng.rand(b, 2, 1, 16, 16).astype(np.float32),
            "target_bins": bins,
            "target_weight": (rng.rand(b, 4) > 0.2).astype(np.float32)}


def _run_pair(kind):
    """Two steps of each package: (step 1 results, step 2 results), each
    {"jax": ..., "port": ...}; the port's second step starts from the
    JAX parameters and Adam state after the first."""
    if kind == "heatmap2d":
        port_model = TokenPose(**TP_KW)
        jmodel = jax_tokenpose.TokenPose(**TP_KW)
        batch = _tp_batch()

        def apply_fn(p, bt):
            return jmodel.apply({"params": p}, bt["feature"])

        jstep = jax.jit(jax_alt.make_heatmap2d_step(apply_fn),
                        static_argnums=(2,))

        def port_step(model, opt):
            return alt_steps.make_heatmap2d_step(
                lambda bt: model(bt["feature"]), opt)(tbatch)
    else:
        port_model = NlosPoseSformer(**SF_KW)
        jmodel = jax_sformer.NlosPoseSformer(**SF_KW)
        batch = _sf_batch()
        jstep = jax_alt.make_simdr_step(jmodel)

        def port_step(model, opt):
            return alt_steps.make_simdr_step(model)(opt, tbatch)

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    sd = peaked_transformer_state_dict(port_model, 1)
    params = sformer_params_to_jax(sd)
    tx = optax.adam(LR)
    opt_state = tx.init(params)

    out = []
    for _ in range(2):
        new, new_opt, metrics = jstep(params, opt_state, tx, jbatch)
        mu, nu = new_opt[0].mu, new_opt[0].nu
        count = int(opt_state[0].count)
        jx = dict(loss=float(metrics["loss"]), params=_flat(new),
                  grads=_flat(jax.tree_util.tree_map(
                      lambda m_new, m_old: (m_new - 0.9 * m_old) / 0.1, mu,
                      opt_state[0].mu)))
        model = type(port_model)(**(TP_KW if kind == "heatmap2d"
                                    else SF_KW))
        model.load_state_dict(sformer_state_dict_from_jax(params))
        opt = make_optimizer(TrainConfig(), model.parameters())[0]
        named = dict(model.named_parameters())
        if count:
            load_adam(opt, named,
                      sformer_state_dict_from_jax(opt_state[0].mu),
                      sformer_state_dict_from_jax(opt_state[0].nu), count)
        metrics = port_step(model, opt)
        port = dict(loss=float(metrics["loss"]),
                    params=_flat(sformer_params_to_jax(named)),
                    grads=_flat(sformer_params_to_jax(
                        {n: p.grad for n, p in named.items()})),
                    mu=_flat(sformer_params_to_jax(
                        {n: opt.state[p]["exp_avg"]
                         for n, p in named.items()})),
                    nu=_flat(sformer_params_to_jax(
                        {n: opt.state[p]["exp_avg_sq"]
                         for n, p in named.items()})))
        jx.update(mu=_flat(mu), nu=_flat(nu))
        out.append(dict(jax=jx, port=port))
        params, opt_state = new, new_opt
    return out


@pytest.fixture(scope="module", params=["heatmap2d", "simdr"])
def param_steps(request):
    return _run_pair(request.param)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_param_step_loss_and_gradients_match_jax(param_steps, i):
    port, jx = param_steps[i]["port"], param_steps[i]["jax"]
    assert np.isfinite(port["loss"])
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=1e-5)
    assert port["grads"].keys() == jx["grads"].keys()
    assert _rel_l2(port["grads"], jx["grads"]) < 1e-4


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_param_step_moments_and_new_params_match_jax(param_steps, i):
    """Adam's moments after the step (the second from the carried state)
    and the new parameters."""
    port, jx = param_steps[i]["port"], param_steps[i]["jax"]
    for what in ("mu", "nu"):
        assert _rel_l2(port[what], jx[what]) < 1e-4, what
    _check_new_params(port, jx)


def test_heatmap2d_targets_spread():
    """The targets the 2D step reads: Gaussian maps of distinct joints,
    one joint off the map with weight 0."""
    batch = _tp_batch()
    w = batch["target_weight"]
    assert 0 < w.sum() < w.size
    peaks = batch["target_heatmaps"].reshape(2, 5, -1).argmax(-1)
    assert len(set(peaks[0][w[0] > 0].tolist())) >= 2


def test_simdr_step_after_a_serving_forward():
    """Repair: the rotary tables are cached per shape; a serving forward
    (``serve_video``, under ``torch.inference_mode``) that built them first
    made them inference tensors, and a SimDR step on the same shapes then
    raised ("Inference tensors cannot be saved for backward"), as phase
    12a did after phase 7 on the card."""
    from hiddenpose_tpu_torch.models import rotary
    from hiddenpose_tpu_torch.models.sformer import serve_video

    rotary._rotary_1d.cache_clear()
    rotary._rotary_axial.cache_clear()
    model = NlosPoseSformer(**dict(SF_KW, image_size=12))  # fresh shapes
    model.load_state_dict(peaked_transformer_state_dict(model, 1))
    batch = {k: torch.from_numpy(v) for k, v in _sf_batch().items()}
    batch["video"] = batch["video"][..., :12, :12].contiguous()
    serve_video(model, batch["video"])
    opt = make_optimizer(TrainConfig(), model.parameters())[0]
    loss = alt_steps.make_simdr_step(model)(opt, batch)["loss"]
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())

