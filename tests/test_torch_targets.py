"""The port's target generators (``hiddenpose_tpu_torch/data/targets.py``,
its own numpy copy) against the JAX package's: the same joints, made from
a numpy seed, give bit-equal targets and weights (tolerance: none), with
joints in bounds, at the edges, out of bounds on each side and with
visibility zero."""

import numpy as np
import pytest

from hiddenpose_tpu.data import targets as jax_targets
from hiddenpose_tpu_torch.data import targets
import torch_threads  # noqa: F401  (caps this worker's CPU threads)


def _joints(seed, n, hi, dims=3):
    """``n`` joints uniform over [-8, hi + 8), one exactly at 0, one at
    the far edge, and two far out of bounds (one on each side)."""
    j = np.random.RandomState(seed).uniform(-8, hi + 8, (n, dims))
    j[0] = 0.0
    j[1] = hi - 1
    j[2] = -30.0
    j[3] = 10.0 * hi
    return j


def _vis(seed, n):
    v = np.ones((n, 3), np.float32)
    v[np.random.RandomState(seed).rand(n) < 0.2] = 0.0
    return v


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_oob_weight_matches_jax():
    mu = _joints(0, 40, 32)
    dims = np.asarray([32, 32, 16])
    got = targets._oob_weight(mu, dims, 6.0)
    want = jax_targets._oob_weight(mu, dims, 6.0)
    assert 0 < got.sum() < len(got)  # both kinds present
    _equal([got], [want])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("kw", [{}, dict(image_size=(32, 48, 16),
                                         split_ratio=3.0, sigma=1.5)])
def test_generate_sa_simdr_matches_jax(seed, vis, kw):
    joints = _joints(seed, 24, 64)
    jv = _vis(seed, 24) if vis else None
    got = targets.generate_sa_simdr(joints, jv, **kw)
    want = jax_targets.generate_sa_simdr(joints, jv, **kw)
    _equal(got, want)
    w = got[3][:, 0]
    assert 0 < w.sum() < len(w)  # some joints dropped, some kept
    assert (got[0][w == 0] == 0).all() and got[0].max() > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("size", [(64, 64), (24, 40)])
def test_generate_gaussian_heatmap_2d_matches_jax(seed, vis, size):
    joints = _joints(seed, 24, max(size), dims=2)
    jv = _vis(seed, 24) if vis else None
    got = targets.generate_gaussian_heatmap_2d(joints, jv, size, sigma=2.0)
    want = jax_targets.generate_gaussian_heatmap_2d(joints, jv, size,
                                                    sigma=2.0)
    _equal(got, want)
    assert got[0].shape == (24, *size)
    assert 0 < got[1].sum() < 24


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("size", [(16, 16, 16), (8, 12, 20)])
def test_generate_gaussian_heatmap_3d_matches_jax(seed, vis, size):
    joints = _joints(seed, 24, max(size))
    jv = _vis(seed, 24) if vis else None
    got = targets.generate_gaussian_heatmap_3d(joints, jv, size, sigma=1.5)
    want = jax_targets.generate_gaussian_heatmap_3d(joints, jv, size,
                                                    sigma=1.5)
    _equal(got, want)
    assert got[0].shape == (24, *size)
    assert 0 < got[1].sum() < 24
