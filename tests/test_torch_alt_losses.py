"""The other objectives' losses and the re-centred soft-argmax: the port
(``hiddenpose_tpu_torch/losses.py``, ``train/alt_steps.py::simdr_loss``,
``ops/softargmax.py``) against the JAX package on the same numpy inputs
made from a seed, values and gradients (``jax.grad`` against autograd).

Tolerances: float32 on both sides, differing in summation order only:
1e-6 relative on values (1e-5 on gradients, 1e-7 absolute for the
smallest elements).  The SimDR cases include out-of-range bins, which the
JAX package reads by its indexing rules (a negative bin counts from the
end; past that, the smoothed one-hot drops the label, the NLL clamps it
and the NLL's gradient drops it): the port must give the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu import losses as jax_losses
from hiddenpose_tpu.ops import softargmax as jax_softargmax
from hiddenpose_tpu.train import alt_steps as jax_alt
from hiddenpose_tpu_torch import losses
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral_normalized
from hiddenpose_tpu_torch.train.alt_steps import simdr_loss

RTOL, GRAD_RTOL, ATOL = 1e-6, 1e-5, 1e-7


def _value_and_grad(port_fn, jax_fn, *arrays):
    """(port value, port grad, jax value, jax grad) w.r.t. the first
    array."""
    x = torch.from_numpy(arrays[0]).requires_grad_()
    rest = [torch.from_numpy(a) if a is not None else None
            for a in arrays[1:]]
    got = port_fn(x, *rest)
    (g,) = torch.autograd.grad(got, x)
    want, wg = jax.value_and_grad(jax_fn)(
        jnp.asarray(arrays[0]),
        *[jnp.asarray(a) if a is not None else None for a in arrays[1:]])
    return got.detach().numpy(), g.numpy(), np.asarray(want), np.asarray(wg)


def _check(got, g, want, wg):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, wg, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(wg).max())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(2, 5, 8, 8), (3, 4, 6, 7, 5)])
def test_joints_mse_loss_matches_jax(weighted, shape):
    rng = np.random.RandomState(0)
    pred = rng.randn(*shape).astype(np.float32)
    gt = rng.rand(*shape).astype(np.float32)
    w = (rng.rand(*shape[:2]) > 0.3).astype(np.float32) if weighted else None
    _check(*_value_and_grad(losses.joints_mse_loss, jax_losses.joints_mse_loss,
                            pred, gt, w))


def _labels(seed, n, k, out_of_range):
    lab = np.random.RandomState(seed).randint(0, k, n).astype(np.int32)
    if out_of_range:
        lab[:6] = [k, k + 5, 2 * k, -1, -k, -k - 3]
    return lab


@pytest.mark.parametrize("smoothing", [0.2, 0.1, 0.0])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_nmt_norm_criterion_matches_jax(smoothing, out_of_range):
    n, k = 20, 16
    logits = (np.random.RandomState(1).randn(n, k) * 3).astype(np.float32)
    labels = _labels(2, n, k, out_of_range)

    def port(x, lab):
        return losses.nmt_norm_criterion(x, lab, smoothing).sum()

    def jfn(x, lab):
        return jax_losses.nmt_norm_criterion(x, lab, smoothing).sum()

    _check(*_value_and_grad(port, jfn, logits, labels))
    per = losses.nmt_norm_criterion(torch.from_numpy(logits),
                                    torch.from_numpy(labels), smoothing)
    want = jax_losses.nmt_norm_criterion(jnp.asarray(logits),
                                         jnp.asarray(labels), smoothing)
    assert per.shape == (n,)
    np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_nmt_norm_criterion_out_of_range_rules():
    """The rules themselves, on a row whose label is past the end: with
    smoothing the row is all ``smoothing / (K - 1)`` (no confidence
    anywhere); without, the NLL of the last bin, with no gradient."""
    logits = torch.randn(1, 8, generator=torch.Generator().manual_seed(0))
    lp = torch.log_softmax(logits, dim=1)
    p = torch.full((1, 8), 0.2 / 7)
    want = (p * (torch.log(p) - lp)).mean(dim=1)
    got = losses.nmt_norm_criterion(logits, torch.tensor([9]), 0.2)
    torch.testing.assert_close(got, want)
    got = losses.nmt_norm_criterion(logits, torch.tensor([9]), 0.0)
    torch.testing.assert_close(got, -lp[:, 7])
    got = losses.nmt_norm_criterion(logits, torch.tensor([-1]), 0.0)
    torch.testing.assert_close(got, -lp[:, 7])
    x = logits.clone().requires_grad_()
    losses.nmt_norm_criterion(x, torch.tensor([9]), 0.0).sum().backward()
    assert (x.grad == 0).all()


@pytest.mark.parametrize("smoothing", [0.2, 0.0])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_simdr_loss_matches_jax(smoothing, out_of_range):
    """(B, J, 3, K) logits, (B, J, 3) bins, (B, J) weights; the
    out-of-range case puts bins past K as the Sformer's K = 128 meets
    ``generate_sa_simdr``'s 256-bin z axis."""
    b, j, k = 2, 6, 16
    rng = np.random.RandomState(3)
    logits = (rng.randn(b, j, 3, k) * 3).astype(np.float32)
    bins = _labels(4, b * j * 3, k, out_of_range).reshape(b, j, 3)
    if out_of_range:
        bins[:, :, 2] = rng.randint(0, 2 * k, (b, j))
    w = (rng.rand(b, j) > 0.25).astype(np.float32)

    def port(x, tb, tw):
        return simdr_loss(x, tb, tw, smoothing)

    def jfn(x, tb, tw):
        return jax_alt.simdr_loss(x, tb, tw, smoothing)

    _check(*_value_and_grad(port, jfn, logits, bins, w))


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 24, 8, 8, 8)])
def test_softmax_integral_normalized_matches_jax(shape):
    hm = (np.random.RandomState(5).randn(*shape) * 4).astype(np.float32)
    j = shape[1]

    def port(x):
        return (softmax_integral_normalized(x, j) ** 2).sum()

    def jfn(x):
        return (jax_softargmax.softmax_integral_normalized(x, j) ** 2).sum()

    _check(*_value_and_grad(port, jfn, hm))
    got = softmax_integral_normalized(torch.from_numpy(hm), j)
    want = jax_softargmax.softmax_integral_normalized(jnp.asarray(hm), j)
    assert got.shape == (shape[0], 3 * j)
    assert (got.abs() <= 0.5).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
