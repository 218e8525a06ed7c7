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
on the port's own gradients.  The step's other parts (the losses,
BatchNorm's training rules, the schedule, the weight bridge, the eval
step, each precision) are ``test_torch_train_step_parts.py``'s.

Readings at tiny(32), CPU (f32 on both sides; the step compiles in about
25 s and runs in about 1 s on the JAX side, about 2 s in the port):
loss rel. error 8e-6 (tolerance 1e-4); new BatchNorm statistics 2.4e-4 of
each tensor's max (1e-3); gradients, relative L2 over all 0.073 (0.15),
per module up to 0.10 (0.25); Adam moments as the gradients; new
parameters equal within 1e-6 wherever the two gradients have one sign.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import TrainConfig as JaxTrainConfig
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.models.unet3d import UNet3d as JaxUNet
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_train_step as jax_make_train_step
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import TrainConfig
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import to_jax
import torch_threads  # noqa: F401  (caps this worker's CPU threads)
from torch_train_case import flat, jax_tree, model_cfg, port_model, tiny_batch

SIZE = 32
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


@pytest.fixture(scope="module")
def step_pair():
    """One train step of each package from the same weights and batch."""
    tree, batch = jax_tree(SIZE), tiny_batch(SIZE)
    jmodel, jlct = jax_build(model_cfg(SIZE))
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    step = jax_make_train_step(jmodel, donate=False,
                               matmul_precision="highest")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jlct)
    adam = new.opt_state[0]
    jax_out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: v / np.float32(1 - B1) for k, v in flat(adam.mu).items()},
        mu=flat(adam.mu), nu=flat(adam.nu), params=flat(new.params),
        stats=flat(new.batch_stats))

    model, lct = port_model(SIZE, tree)
    pstate = TrainState.create(model, TrainConfig())
    metrics = make_train_step(model)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, lct)
    named = dict(model.named_parameters())
    opt = pstate.optimizer.state
    port_out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=flat(to_jax({n: p.grad for n, p in named.items()})),
        mu=flat(to_jax({n: opt[p]["exp_avg"] for n, p in named.items()})),
        nu=flat(to_jax({n: opt[p]["exp_avg_sq"] for n, p in named.items()})),
        params=flat(to_jax(named)),
        stats=flat(convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()},
            strict=True)["batch_stats"]),
        step=pstate.step)
    return dict(jax=jax_out, port=port_out, params0=flat(tree["params"]),
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
    tree = jax_tree(16)
    model, _ = port_model(16, tree)
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
    got = flat(to_jax({n: (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                        for n, p in model.named_parameters()})["autoencoder"])
    want = flat(gp)
    scale = np.sqrt(sum(np.sum(v ** 2) for v in want.values()))
    for k in want:
        # a conv bias right before GroupNorm has a gradient that is zero
        # or a near-cancellation, so each tensor is held to 1e-5 of its own
        # norm plus 1e-6 of the whole UNet gradient's
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 1e-5 * np.linalg.norm(want[k]) + 1e-6 * scale, k
