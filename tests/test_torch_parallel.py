"""The port's mesh, tensor-parallel rules, sharded LCT and data-parallel
reductions (``hiddenpose_tpu_torch/parallel/``, ``ops/lct.py``) against
the JAX package and against one process.

The port's ranks are gloo processes on the CPU (``tests/torch_gloo.py``,
each job with its own time limit), running ``tests/
torch_parallel_workers.py``; the JAX side uses the 8 virtual CPU devices
of ``tests/conftest.py``.  Limits: the sharded LCT at the JAX package's
own (``tests/test_parallel.py``: rtol 2e-4, atol 2e-5 of the largest
value), forward and VJP; the BatchNorm moments, its output, the Dice loss
and their input gradients on 2 ranks equal to one process on the whole
batch within 1e-6 relative (only the order of two sums differs).  The
data-parallel x tensor-parallel train step is
``tests/test_torch_parallel_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import default_config as jax_default_config
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.ops.lct import (
    lct_apply as jax_lct_apply,
    lct_apply_sharded as jax_lct_apply_sharded,
    make_lct_params as jax_make_lct_params,
)
from hiddenpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hiddenpose_tpu.parallel.sharding_rules import (
    params_tp_sharding as jax_params_tp_sharding,
)
from hiddenpose_tpu_torch.config import default_config
from hiddenpose_tpu_torch.losses import dice_loss
from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.models.posenet3d import FlaxBatchNorm3d
from hiddenpose_tpu_torch.parallel.mesh import Mesh
from hiddenpose_tpu_torch.parallel.sharding_rules import params_tp_sharding
from hiddenpose_tpu_torch.utils.jax_bridge import to_jax
from torch_gloo import run_ranks
from torch_parallel_workers import _lct_inputs

LCT_SIZE = 16


def test_mesh_shapes_groups_and_layout(tmp_path):
    """A (2, 2) mesh over 4 ranks: rank r at (r // 2, r % 2) as the JAX
    mesh reshapes its devices; each axis's group holds that row or column;
    the batch's rows split over 'data' in order (both 'model' ranks of a
    row hold the same share); ``replicate`` gives rank 0's values."""
    out = run_ranks("torch_parallel_workers:mesh_layout", 4, tmp_path,
                    args=[2, 2], timeout=120)
    rows = np.arange(12).reshape(4, 3)
    for r, o in enumerate(out):
        d, m = r // 2, r % 2
        assert o["rank"] == r
        assert o["shape"] == {"data": 2, "model": 2}
        assert o["index"] == {"data": d, "model": m}
        assert o["members"] == {"data": [m, 2 + m], "model": [2 * d,
                                                              2 * d + 1]}
        np.testing.assert_array_equal(o["share"].numpy(),
                                      rows[2 * d:2 * d + 2])
        assert o["replicated"].tolist() == [0.0, 0.0]
        assert o["specs"] == (("data",), ())


def _jax_params(backbone):
    cfg = jax_default_config().tiny(LCT_SIZE)
    model, lct = jax_build(dataclasses.replace(cfg.model, backbone=backbone))
    meas = jnp.zeros((1, 1, LCT_SIZE, LCT_SIZE, LCT_SIZE), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), meas, lct, train=False))["params"]
    # zero-stride arrays: the rule reads shapes only
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), v


@pytest.mark.parametrize("backbone", ["posenet3d_50", "posenet2d"])
def test_tp_sharded_leaves_are_the_jax_ones(backbone):
    """The port's rule on a (4, 2) mesh shards exactly the JAX rule's
    leaves of the same model, leaf by leaf through ``utils/jax_bridge.py``
    (which relayouts each tensor as the JAX tree holds it), and each on
    the JAX leaf's last (output-channel) axis: PoseNet3D's
    ``ConvTranspose3d`` head and the 2D net's ``ConvTranspose2d`` head on
    torch's dim 1, every conv and dense weight on dim 0."""
    jparams = _jax_params(backbone)
    jmesh = jax_make_mesh(n_data=4, n_model=2,
                          devices=jax.devices("cpu")[:8])
    jspec = dict(_leaves(jax_params_tp_sharding(jparams, jmesh)))
    jax_sharded = {p for p, s in jspec.items() if s.spec != ()}
    assert len(jax_sharded) > 20

    cfg = default_config().tiny(LCT_SIZE)
    model = NlosPose(dataclasses.replace(cfg.model, backbone=backbone))
    rules = params_tp_sharding(model, Mesh(4, 2, 0, (None, None),
                                           torch.device("cpu")))
    assert set(rules) == {n for n, _ in model.named_parameters()}
    # each tensor counts along its sharded axis (0 elsewhere): through the
    # bridge, a JAX leaf the port shards counts along its last axis
    marks = {}
    for name, p in model.named_parameters():
        dim = rules[name]
        t = torch.zeros(p.shape)
        if dim is not None:
            shape = [1] * p.dim()
            shape[dim] = -1
            t += torch.arange(1, p.shape[dim] + 1,
                              dtype=torch.float32).view(shape)
        marks[name] = t
    port = dict(_leaves(to_jax(marks)))
    assert set(port) == set(jspec)
    port_sharded = {p for p, a in port.items() if a.any()}
    assert port_sharded == jax_sharded
    kinds = {type(m).__name__ for n, m in model.named_modules()
             if f"{n}.weight" in rules and rules[f"{n}.weight"] == 1}
    assert kinds == {"ConvTranspose3d" if backbone == "posenet3d_50"
                     else "ConvTranspose2d"}
    for path in port_sharded:
        a = port[path]
        want = np.arange(1, a.shape[-1] + 1, dtype=np.float32)
        np.testing.assert_array_equal(a, np.broadcast_to(want, a.shape))


@pytest.fixture(scope="module")
def jax_lct():
    """The JAX package's LCT of a seeded batch of 4 at 16^3: plain and
    sharded on a (2, 4) mesh of the virtual devices, each with the VJP of
    sum(out * w)."""
    params = jax_make_lct_params(image_size=LCT_SIZE, time_size=LCT_SIZE,
                                 bin_len=0.32)
    meas, wgt = (jnp.asarray(t.numpy()) for t in _lct_inputs(LCT_SIZE, 0, 4))
    mesh = jax_make_mesh(n_data=2, n_model=4, devices=jax.devices("cpu")[:8])

    def run(f):
        out, vjp = jax.vjp(f, meas)
        return np.asarray(out), np.asarray(vjp(wgt)[0])

    return {"plain": run(lambda m: jax_lct_apply(m, params)),
            "sharded": run(jax.jit(
                lambda m: jax_lct_apply_sharded(m, params, mesh)))}


@pytest.mark.parametrize("n_model", [2, 4])
def test_lct_sharded_matches_jax(tmp_path, jax_lct, n_model):
    """``lct_apply_sharded`` on 1 x ``n_model`` gloo ranks, forward and
    VJP, against the JAX ``lct_apply_sharded`` on a (2, 4) mesh and
    against the JAX ``lct_apply``, on every rank."""
    out = run_ranks("torch_parallel_workers:lct_sharded", n_model, tmp_path,
                    args=[1, n_model, LCT_SIZE, 0, 4], timeout=120)
    for o in out:
        for ref in ("plain", "sharded"):
            want, want_grad = jax_lct[ref]
            np.testing.assert_allclose(o["out"].numpy(), want, rtol=2e-4,
                                       atol=2e-5 * np.abs(want).max())
            np.testing.assert_allclose(o["grad"].numpy(), want_grad,
                                       rtol=2e-4,
                                       atol=2e-5 * np.abs(want_grad).max())


def test_bn_moments_and_dice_over_two_ranks(tmp_path):
    """Inside ``data_parallel``, a training ``FlaxBatchNorm3d`` and the
    Dice loss on 2 ranks (2 samples each) equal one process on the whole
    batch of 4: the output, the new running statistics, the loss, and the
    input gradients of sum(y * w) + dice.  Each rank's loss holds the
    whole Dice term, as the data-parallel step's (whose gradient average
    divides by the ranks), so the reference's gradient is that of
    sum(y * w) + 2 dice."""
    out = run_ranks("torch_parallel_workers:bn_dice", 2, tmp_path,
                    args=[2, 7], timeout=120)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 3, 4, 5, 6).astype(np.float32) * 2 + 1)
    w = torch.from_numpy(rng.randn(4, 3, 4, 5, 6).astype(np.float32))
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32))
    t = torch.from_numpy((rng.rand(4, 50) > 0.5).astype(np.float32))
    bn = FlaxBatchNorm3d(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2]))
    x.requires_grad_()
    logits.requires_grad_()
    y = bn(x)
    dice = dice_loss(logits, t)
    ((y * w).sum() + 2 * dice).backward()

    def close(got, want):
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err

    for r, o in enumerate(out):
        rows = slice(2 * r, 2 * r + 2)
        close(o["y"], y.detach()[rows])
        close(o["running_mean"], bn.running_mean)
        close(o["running_var"], bn.running_var)
        close(o["dice"], dice.detach())
        close(o["x_grad"], x.grad[rows])
        close(o["logits_grad"], logits.grad[rows])
