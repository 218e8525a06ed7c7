"""A step with a pretrained, frozen autoencoder: the port's against the
JAX package's ``freeze_autoencoder`` step, on the CPU at tiny(32).

Both load one pretrained UNet3d (the autoencoder of the peaked weights of
seed 2, saved by each package's ``save_autoencoder``) into the peaked
weights of seed 1, freeze it and take one Adam step on
``make_batch([0, 1])`` at 'highest'.  Then:

* the autoencoder's parameters are the pretrained ones, bit for bit, on
  both sides, and carry no Adam moments (in the port: no gradient, outside
  the optimizer);
* the losses agree within 1e-4 (relative), as in
  ``tests/test_torch_train_step.py``;
* every other parameter moved (the FeatureExtraction's too: gradients
  flow through the frozen UNet), and the new parameters agree within 1e-6
  wherever the two gradients agree within 25% and |g| >= 1e-5 (Adam's
  first step is about lr * sign(g)), with at least 99% of the large
  gradient elements of one sign: the criteria of
  ``tests/test_torch_train_step.py::test_new_params_match_where_gradients_agree``.
  Readings (2 and 8 torch threads): one sign for 99.95% and 99.97% of
  them; the new parameters within 3.2e-7; the losses 1.9e-6 apart
  (relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import Config as JaxConfig
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train import pretrain as jax_pretrain
from hiddenpose_tpu.train.optim import make_optimizer as jax_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_train_step as jax_train_step
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.train import pretrain
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import to_jax
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 32


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _weights(seed):
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(Config().tiny(SIZE).model)
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    return peaked_state_dict(template, seed)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pretrain")
    m = Config().tiny(SIZE).model
    batch = make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                       m.heatmap_size[0], m.bin_len)
    tree = convert_state_dict({k: v.numpy() for k, v in _weights(1).items()},
                              strict=True)
    donor = convert_state_dict(
        {k: v.numpy() for k, v in _weights(2).items()}, strict=True)

    # the JAX package
    jmodel, jlct = jax_build(JaxConfig().tiny(SIZE).model)
    path = jax_pretrain.save_autoencoder(str(tmp / "jax_unet"),
                                         donor["params"])
    variables = jax_pretrain.load_pretrained_autoencoder(path, tree)
    tx = jax_pretrain.freeze_autoencoder(
        jax_optimizer(JaxConfig().train), variables["params"])
    state = JaxTrainState.create(variables["params"],
                                 variables["batch_stats"], tx)
    step = jax_train_step(jmodel, donate=False, matmul_precision="highest")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jlct)
    adam = new.opt_state.inner_states["train"].inner_state[0]
    jax_out = dict(
        loss=float(metrics["loss"]), params=_flat(new.params),
        grads={k: v / np.float32(0.1) for k, v in _flat(adam.mu).items()})

    # the port
    model, lct = build_nlospose(Config().tiny(SIZE).model, device="cpu")
    model.load_state_dict(_weights(1))
    upath = pretrain.save_autoencoder(str(tmp / "unet.pth"), _weights(2))
    pretrain.load_pretrained_autoencoder(upath, model)
    pstate = TrainState.create(model, Config().train,
                               params=pretrain.freeze_autoencoder(model))
    pmetrics = make_train_step(model, matmul_precision="highest")(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, lct)
    named = dict(model.named_parameters())
    port_out = dict(
        loss=float(pmetrics["loss"]), params=_flat(to_jax(named)),
        grads=_flat(to_jax({n: (p.grad if p.grad is not None
                                else torch.zeros_like(p))
                            for n, p in named.items()})),
        no_state=all(p not in pstate.optimizer.state and p.grad is None
                     and not p.requires_grad
                     for n, p in named.items()
                     if n.startswith("autoencoder.")))
    return dict(jax=jax_out, port=port_out, params0=_flat(tree["params"]),
                donor=_flat(donor["params"]))


def _is_ae(key):
    return key.startswith("['autoencoder']")


def test_autoencoder_is_the_pretrained_one_on_both_sides(steps):
    for side in ("jax", "port"):
        for k, v in steps[side]["params"].items():
            if _is_ae(k):
                np.testing.assert_array_equal(v, steps["donor"][k],
                                              err_msg=f"{side} {k}")
    assert steps["port"]["no_state"]
    # the JAX frozen branch holds no moments for them either
    assert not any(_is_ae(k) for k in steps["jax"]["grads"])


def test_frozen_step_losses_match(steps):
    got, want = steps["port"]["loss"], steps["jax"]["loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_frozen_step_other_parameters_match(steps):
    port, jx, p0 = steps["port"], steps["jax"], steps["params0"]
    agree = total = 0
    for k, gj in jx["grads"].items():
        assert not _is_ae(k)
        assert np.any(port["params"][k] != p0[k]), k  # it moved
        gp = port["grads"][k]
        close = (np.abs(gp - gj) <= 0.25 * np.abs(gj)) & (np.abs(gj) >= 1e-5)
        np.testing.assert_allclose(port["params"][k][close],
                                   jx["params"][k][close], rtol=0, atol=1e-6,
                                   err_msg=k)
        big = np.abs(gj) > 1e-2 * np.abs(gj).max()
        agree += int(((np.sign(gp) == np.sign(gj)) & big).sum())
        total += int(big.sum())
    assert agree >= 0.99 * total, agree / total
