"""K2 (stem conv) and K3 (stem max-pool) against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

The TPU kernels work in 2x2x2 space-to-depth form: the stem returns its
output as (B, D/2, H/2, W/2, 8*64) and the pool reads that phase layout.
The port's kernels work at full resolution, NDHWC, so the comparison goes
through ``depth_to_space_3d`` / ``space_to_depth_3d``.  On the CPU the
port's wrappers run their plain versions; the CUDA kernels are compared
with those on the GPU by ``tests/test_torch_kernels_cuda.py``.
Tolerances: the stem is a 343-tap f32 sum in another order, 1e-4
absolute and relative; max-pool selects values and must match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hiddenpose_tpu.ops.pallas.phase_pool import phase_maxpool_pallas
from hiddenpose_tpu.ops.pallas.stem_conv import stem_conv_raw_pallas
from hiddenpose_tpu.ops.space_to_depth import (
    depth_to_space_3d,
    make_s2d_kernel,
    space_to_depth_3d,
)
from hiddenpose_tpu_torch.ops.kernels import maxpool3d_k3s2p1, stem_conv_raw


def _stem_inputs(seed, shape=(1, 16, 16, 16, 1)):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    k = (rng.randn(7, 7, 7, 1, 64) * 0.05).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    shift = (rng.randn(64) * 0.1).astype(np.float32)
    return x, k, scale, shift


def _jax_stem(x, k, scale, shift):
    """The TPU stem: raw volume in, space-to-depth result out."""
    return stem_conv_raw_pallas(
        jnp.asarray(x), make_s2d_kernel(jnp.asarray(k)),
        jnp.tile(jnp.asarray(scale), 8), jnp.tile(jnp.asarray(shift), 8),
        relu=True)


def test_stem_conv_matches_jax():
    x, k, scale, shift = _stem_inputs(0)
    want = np.asarray(depth_to_space_3d(_jax_stem(x, k, scale, shift)))
    got = stem_conv_raw(*map(torch.from_numpy, (x, k, scale, shift)))
    assert got.shape == (1, 16, 16, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_stem_then_pool_matches_jax():
    """The stem as the model runs it: K2 then K3, against
    stem_conv_raw_pallas then phase_maxpool_pallas."""
    x, k, scale, shift = _stem_inputs(1)
    want = np.asarray(phase_maxpool_pallas(
        _jax_stem(x, k, scale, shift), interpret=True))
    got = maxpool3d_k3s2p1(
        stem_conv_raw(*map(torch.from_numpy, (x, k, scale, shift))))
    assert got.shape == want.shape == (1, 8, 8, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _pool_input(kind, shape, seed=2):
    rng = np.random.RandomState(seed)
    y = rng.randn(*shape).astype(np.float32)
    if kind == "ties":
        # post-ReLU data quantised to a coarse grid: most windows hold
        # several exact zeros and many hold repeated nonzero maxima
        y = np.maximum(np.round(y, 1), 0.0).astype(np.float32)
    elif kind == "negative":
        # all values below zero: a zero-padded pool would differ at borders
        y = -np.abs(y) - 1.0
    return y


@pytest.mark.parametrize("kind", ["random", "ties", "negative"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 16), (2, 8, 8, 16, 32)])
def test_maxpool_matches_jax_phase_pool(kind, shape):
    y = _pool_input(kind, shape)
    want = np.asarray(phase_maxpool_pallas(
        space_to_depth_3d(jnp.asarray(y)), interpret=True))
    got = maxpool3d_k3s2p1(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pool_output_extent_for_odd_sizes():
    y = torch.zeros((1, 9, 10, 11, 4))
    assert maxpool3d_k3s2p1(y).shape == (1, 5, 5, 6, 4)


def test_wrappers_validate_input():
    x, k, scale, shift = map(torch.from_numpy, _stem_inputs(3))
    with pytest.raises(ValueError):
        stem_conv_raw(x.expand(1, 16, 16, 16, 2).contiguous(), k, scale,
                      shift)                                # 2 channels
    with pytest.raises(ValueError):
        stem_conv_raw(x, k[..., :32].contiguous(), scale, shift)
    with pytest.raises(ValueError):
        maxpool3d_k3s2p1(torch.zeros((1, 4, 4, 4, 6)))      # C % 4 != 0
