"""The port's train step against the JAX package's, on identical weights.

Weights: the port's peaked random weights (``utils/peaked.py``, seed 1),
carried to the JAX layout by ``convert_state_dict`` (the strict oracle for
names) and back by ``utils/jax_bridge``; batch: ``make_batch([0, 1])``.

**Size.**  The whole step runs at tiny(32), not tiny(16).  At tiny(16)
layer4 is 1^3, so each of its BatchNorms normalises 2 values per channel
(batch 2); the step is then so ill-conditioned that the JAX package's own
gradients move by a median 340% of their norm, and its loss by 3e-3, when
the measurement is perturbed by 1e-6 (relative); the port against the JAX
package there reads alike: loss 1.0e-3 relative, new BatchNorm statistics
0.24 of a tensor's max, gradients 0.59 relative L2.  At tiny(32) (layer4 2^3,
16 values) the same perturbation moves the loss by 1e-6 and the gradients
by 1-4% of their norm (mostly max-pool winners and ReLU masks that flip).
So the whole-step gradients are compared by relative L2 norm per module,
with tolerances set from the readings below; the backward math itself is
held tightly module by module (the UNet here; every kernel and Function in
``test_torch_train_kernels.py``), and the optimizer against optax's formula
on the port's own gradients.

Readings at tiny(32), CPU (f32 on both sides; the step compiles in about
25 s and runs in about 1 s on the JAX side, about 2 s in the port):
loss rel. error 8e-6 (tolerance 1e-4); new BatchNorm statistics 2.4e-4 of
each tensor's max (1e-3); gradients, relative L2 over all 0.073 (0.15),
per module up to 0.10 (0.25); Adam moments as the gradients; new
parameters equal within 1e-6 wherever the two gradients have one sign.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hiddenpose_tpu.config import Config, TrainConfig as JaxTrainConfig
from hiddenpose_tpu.losses import (
    bce_dice_loss as jax_bce_dice,
    l2_joint_location_loss as jax_l2,
)
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.models.unet3d import UNet3d as JaxUNet
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.optim import multistep_lr as jax_multistep_lr
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_eval_step as jax_make_eval_step
from hiddenpose_tpu.train.step import make_train_step as jax_make_train_step
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import TrainConfig
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.losses import bce_dice_loss, l2_joint_location_loss
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.models.posenet3d import FlaxBatchNorm3d
from hiddenpose_tpu_torch.train.optim import multistep_lr
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import (
    make_eval_step,
    make_forward,
    make_train_step,
)
from hiddenpose_tpu_torch.utils.jax_bridge import (
    from_jax,
    state_dict_from_jax,
    to_jax,
)
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

SIZE = 32
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model_cfg(size):
    return Config().tiny(size).model


@functools.lru_cache(maxsize=None)
def _jax_tree(size, seed=1):
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(_model_cfg(size))
    sd = peaked_state_dict(template, seed)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


def _batch(size):
    m = _model_cfg(size)
    return make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                      m.heatmap_size[0], m.bin_len)


def _port(size, tree=None, train=True):
    model, lct = build_nlospose(_model_cfg(size))
    model.load_state_dict(state_dict_from_jax(tree or _jax_tree(size)))
    return model.train(train), lct


@pytest.fixture(scope="module")
def step_pair():
    """One train step of each package from the same weights and batch."""
    tree, batch = _jax_tree(SIZE), _batch(SIZE)
    jmodel, jlct = jax_build(_model_cfg(SIZE))
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    step = jax_make_train_step(jmodel, donate=False,
                               matmul_precision="highest")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jlct)
    adam = new.opt_state[0]
    jax_out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: v / np.float32(1 - B1) for k, v in _flat(adam.mu).items()},
        mu=_flat(adam.mu), nu=_flat(adam.nu), params=_flat(new.params),
        stats=_flat(new.batch_stats))

    model, lct = _port(SIZE, tree)
    pstate = TrainState.create(model, TrainConfig())
    metrics = make_train_step(model)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, lct)
    named = dict(model.named_parameters())
    opt = pstate.optimizer.state
    port_out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=_flat(to_jax({n: p.grad for n, p in named.items()})),
        mu=_flat(to_jax({n: opt[p]["exp_avg"] for n, p in named.items()})),
        nu=_flat(to_jax({n: opt[p]["exp_avg_sq"] for n, p in named.items()})),
        params=_flat(to_jax(named)),
        stats=_flat(convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()},
            strict=True)["batch_stats"]),
        step=pstate.step)
    return dict(jax=jax_out, port=port_out, params0=_flat(tree["params"]),
                batch=batch)


def _rel_l2(a, b, keys):
    num = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2)
                      for k in keys))
    den = np.sqrt(sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys))
    return num / den


def test_batch_joints_spread(step_pair):
    """The two samples' joints differ (a comparison of identical samples
    would hide batch-axis errors)."""
    joints = step_pair["batch"]["joints"].reshape(2, 24, 3)
    assert np.abs(joints[0] - joints[1]).max() > 0.5


def test_losses_match(step_pair):
    got, want = step_pair["port"]["metrics"], step_pair["jax"]["metrics"]
    assert got.keys() == want.keys() == {"loss", "joint_loss", "voxel_loss"}
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert step_pair["port"]["step"] == 1


def test_new_batch_statistics_match(step_pair):
    got, want = step_pair["port"]["stats"], step_pair["jax"]["stats"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-3 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("what", ["grads", "mu", "nu"])
def test_gradients_and_moments_match(step_pair, what):
    got, want = step_pair["port"][what], step_pair["jax"][what]
    assert got.keys() == want.keys()
    assert _rel_l2(got, want, want) < 0.15
    for module in ("feature_extraction", "autoencoder", "pose_net"):
        keys = [k for k in want if k.startswith(f"['{module}']")]
        assert _rel_l2(got, want, keys) < 0.25, module


def test_adam_update_is_optax_formula(step_pair):
    """The port's moments and new parameters from its own gradients, by
    optax's first Adam step: mu = 0.1 g, nu = 0.001 g^2,
    p - lr * mu_hat / (sqrt(nu_hat) + eps)."""
    port, p0 = step_pair["port"], step_pair["params0"]
    for k, g in port["grads"].items():
        np.testing.assert_allclose(port["mu"][k], (1 - B1) * g, rtol=1e-6,
                                   atol=1e-30, err_msg=k)
        np.testing.assert_allclose(port["nu"][k], (1 - B2) * g * g,
                                   rtol=1e-5, atol=1e-30, err_msg=k)
        g64 = g.astype(np.float64)
        want = p0[k] - LR * g64 / (np.abs(g64) + EPS)
        np.testing.assert_allclose(port["params"][k], want, rtol=0,
                                   atol=1e-6, err_msg=k)


def test_new_params_match_where_gradients_agree(step_pair):
    """Adam's first step moves each parameter by lr * g / (|g| + eps),
    about lr * sign(g): a gradient near 0 on one side may move it the
    other way on the other, and below |g| ~ 1e-5 the step still depends on
    |g| itself.  So compare where the two gradients agree within 25% and
    |g| >= 1e-5 (there the steps differ by at most 2.5e-7), and require
    one sign for at least 99% of the elements whose |g| is above 1% of
    their tensor's max."""
    port, jx = step_pair["port"], step_pair["jax"]
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
    assert agree >= 0.99 * total


def test_unet_train_gradients_match_jax():
    """The UNet's backward alone (convs K1/K5/K6 through the Function, the
    K8 pool, GroupNorm, trilinear) against JAX autodiff: tight, since a
    random input gives no near-ties to flip."""
    tree = _jax_tree(16)
    model, _ = _port(16, tree)
    rng = np.random.RandomState(3)
    x = rng.rand(2, 1, 16, 16, 16).astype(np.float32)
    r = rng.randn(2, 1, 16, 16, 16).astype(np.float32)

    def loss(p, v):
        out = JaxUNet(in_channels=1, n_channels=4).apply({"params": p}, v,
                                                         True)
        return jnp.sum(out * jnp.asarray(r.transpose(0, 2, 3, 4, 1)))

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        tree["params"]["autoencoder"], jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    xt = torch.from_numpy(x).requires_grad_()
    (model.autoencoder(xt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(gx).transpose(0, 4, 1, 2, 3),
                               rtol=0, atol=1e-5 * np.abs(gx).max())
    got = _flat(to_jax({n: (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                        for n, p in model.named_parameters()})["autoencoder"])
    want = _flat(gp)
    scale = np.sqrt(sum(np.sum(v ** 2) for v in want.values()))
    for k in want:
        # a conv bias right before GroupNorm has a gradient that is zero
        # or a near-cancellation, so each tensor is held to 1e-5 of its own
        # norm plus 1e-6 of the whole UNet gradient's
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-5 * np.linalg.norm(want[k]) + 1e-6 * scale, k


def test_train_mode_uses_batch_statistics_everywhere():
    """Repair: in training every BatchNorm (the stem's and the K4 blocks'
    bn2 included) normalises with the batch statistics, so the running
    statistics cannot change the training forward."""
    model, lct = _port(16)
    meas = torch.from_numpy(_batch(16)["meas"])
    with torch.no_grad():
        hm0, _ = model(meas, lct)
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm3d):
                m.running_mean.add_(3.0)
                m.running_var.mul_(5.0)
        hm1, _ = model(meas, lct)
    assert torch.equal(hm0, hm1)


def test_running_variance_update_is_flax_biased():
    """Repair: running_var <- 0.9 * old + 0.1 * the BIASED batch variance
    (flax's update; torch's own BatchNorm3d uses the unbiased one)."""
    bn = FlaxBatchNorm3d(3).train()
    with torch.no_grad():
        bn.running_mean.fill_(0.5)
        bn.running_var.fill_(2.0)
    x = torch.from_numpy(
        np.random.RandomState(4).randn(2, 3, 1, 1, 1).astype(np.float32))
    y = bn(x)
    xs = x.numpy().transpose(1, 0, 2, 3, 4).reshape(3, -1)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * 2.0 + 0.1 * xs.var(axis=1), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.9 * 0.5 + 0.1 * xs.mean(axis=1), rtol=1e-6)
    torch.testing.assert_close(y, F.batch_norm(
        x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps))


def test_losses_and_their_gradients_match_jax():
    rng = np.random.RandomState(5)
    hm = rng.randn(2, 24, 4, 4, 4).astype(np.float32) * 3
    joints = rng.rand(2, 72).astype(np.float32) * 4
    vis = (rng.rand(2, 72) > 0.2).astype(np.float32)
    logits = rng.randn(2, 512).astype(np.float32) * 2
    logits[0, :5] = 0.0  # the BCE's max(x, 0) and |x| at exactly 0
    vol = (rng.rand(2, 512) > 0.9).astype(np.float32)
    for jfn, tfn, args, arg0 in (
            (jax_l2, l2_joint_location_loss, (hm, joints, vis), hm),
            (jax_bce_dice, bce_dice_loss, (logits, vol), logits)):
        want, gwant = jax.value_and_grad(
            lambda a: jfn(a, *map(jnp.asarray, args[1:])))(jnp.asarray(arg0))
        t = torch.from_numpy(arg0).requires_grad_()
        got = tfn(t, *map(torch.from_numpy, args[1:]))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gwant),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("before", [True, False])
def test_multistep_lr_matches_jax(before):
    args = (1e-3, (2, 4, 13), 0.2, 3, before)
    got, want = multistep_lr(*args), jax_multistep_lr(*args)
    for count in range(0, 60, 2):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6)


def test_schedule_reaches_the_optimizer():
    """The rate of the count BEFORE each update is written into the param
    groups, as optax evaluates its schedule."""
    model, lct = _port(16)
    state = TrainState.create(model, TrainConfig(lr_step=(2,)),
                              steps_per_epoch=1)
    seen = []
    real_step = state.optimizer.step
    state.optimizer.step = lambda: (seen.append(
        state.optimizer.param_groups[0]["lr"]), real_step())[1]
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    state.apply_gradients()
    state.apply_gradients()
    assert seen == [pytest.approx(1e-3), pytest.approx(1e-3 * 0.2)]
    assert state.step == 2


def test_bridge_carries_param_shaped_trees_both_ways():
    """to_jax gives exactly the paths convert_state_dict gives (the strict
    oracle for names); from_jax inverts it, for params and batch_stats."""
    tree = _jax_tree(16, seed=2)
    model, _ = _port(16, tree)
    named = dict(model.named_parameters())
    back = to_jax(named)
    want = _flat(tree["params"])
    got = _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = from_jax(back)
    assert again.keys() == named.keys()
    for k in named:
        assert torch.equal(again[k], named[k].detach()), k
    stats = from_jax(tree["batch_stats"], "batch_stats")
    sd = model.state_dict()
    for k, v in stats.items():
        assert torch.equal(v, sd[k]), k


def test_eval_step_matches_jax():
    tree, batch = _jax_tree(16), _batch(16)
    jmodel, jlct = jax_build(_model_cfg(16))
    want = jax_make_eval_step(jmodel)(
        JaxTrainState.create(tree["params"], tree["batch_stats"],
                             jax_make_optimizer(JaxTrainConfig())),
        {k: jnp.asarray(v) for k, v in batch.items()}, jlct)
    model, lct = _port(16, tree, train=True)
    state = TrainState.create(model, TrainConfig())
    got = make_eval_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, lct)
    assert not model.training
    joints, _ = make_forward(model)(torch.from_numpy(batch["meas"]), lct)
    assert torch.equal(got["pred_joints"], joints)
    for k in ("pred_joints", "heatmaps", "refine", "joint_loss"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_only_highest_precision_is_ported():
    model, _ = _port(16)
    for prec in ("default", "high"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            make_train_step(model, matmul_precision=prec)


def test_step_refuses_a_state_of_another_model():
    model, lct = _port(16)
    other, _ = _port(16)
    with pytest.raises(ValueError):
        make_train_step(model)(TrainState.create(other, TrainConfig()), {},
                               lct)
