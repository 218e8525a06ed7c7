"""The train step's parts in the port against the JAX package, on the
tiny NlosPose of ``tests/test_torch_train_step.py`` (``torch_train_case``
has its weights and batch): the losses and their gradients, BatchNorm's
training rules, the learning-rate schedule and its way to the optimizer,
the weight bridge both ways, the eval step, a step at each precision and
dtype, and the check of a state's model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hiddenpose_tpu.config import TrainConfig as JaxTrainConfig
from hiddenpose_tpu.losses import (
    bce_dice_loss as jax_bce_dice,
    l2_joint_location_loss as jax_l2,
)
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.optim import multistep_lr as jax_multistep_lr
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_eval_step as jax_make_eval_step
from hiddenpose_tpu_torch.config import Config as PortConfig, TrainConfig
from hiddenpose_tpu_torch.losses import bce_dice_loss, l2_joint_location_loss
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.models.posenet3d import FlaxBatchNorm3d
from hiddenpose_tpu_torch.ops.kernels import conv3mxu
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
import torch_threads  # noqa: F401  (caps this worker's CPU threads)
from torch_train_case import flat, jax_tree, model_cfg, port_model, tiny_batch


def test_train_mode_uses_batch_statistics_everywhere():
    """Repair: in training every BatchNorm (the stem's and the K4 blocks'
    bn2 included) normalises with the batch statistics, so the running
    statistics cannot change the training forward."""
    model, lct = port_model(16)
    meas = torch.from_numpy(tiny_batch(16)["meas"])
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
    model, lct = port_model(16)
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
    tree = jax_tree(16, seed=2)
    model, _ = port_model(16, tree)
    named = dict(model.named_parameters())
    back = to_jax(named)
    want = flat(tree["params"])
    got = flat(back)
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
    tree, batch = jax_tree(16), tiny_batch(16)
    jmodel, jlct = jax_build(model_cfg(16))
    want = jax_make_eval_step(jmodel)(
        JaxTrainState.create(tree["params"], tree["batch_stats"],
                             jax_make_optimizer(JaxTrainConfig())),
        {k: jnp.asarray(v) for k, v in batch.items()}, jlct)
    model, lct = port_model(16, tree, train=True)
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


@pytest.mark.parametrize("bf16", [False, True])
def test_every_precision_and_dtype_builds_a_step(bf16):
    """'default', 'high' and 'highest' each build a step for a float32 and
    a bfloat16 model, which runs (tiny(16), one step each); the ambient
    precision is 'highest' again after each step; anything else raises."""
    cfg = PortConfig().tiny(16)
    cfg = cfg.with_bf16() if bf16 else cfg
    model, lct = build_nlospose(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_tree(16)))
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch(16).items()}
    assert model.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
    for prec in ("default", "high", "highest"):
        state = TrainState.create(model, TrainConfig())
        metrics = make_train_step(model, matmul_precision=prec)(
            state, batch, lct)
        assert np.isfinite(float(metrics["loss"])), prec
        assert conv3mxu.current_precision() == "highest", prec
    for prec in ("fastest", "float32", None):
        with pytest.raises(ValueError, match="matmul_precision"):
            make_train_step(model, matmul_precision=prec)


def test_step_refuses_a_state_of_another_model():
    model, lct = port_model(16)
    other, _ = port_model(16)
    with pytest.raises(ValueError):
        make_train_step(model)(TrainState.create(other, TrainConfig()), {},
                               lct)
