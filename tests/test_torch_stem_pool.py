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
from hiddenpose_tpu_torch.ops.kernels import (
    maxpool3d_k3s2p1,
    stem_conv,
    stem_conv_raw,
)
from hiddenpose_tpu_torch.ops.kernels._tf32 import tf32_split
import torch_threads  # noqa: F401  (caps this worker's CPU threads)


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


# ------------------------------------------- K2: the kernel's bookkeeping
# (``stem_conv_tiled_ref``: the block tiles, the hi / lo halo, each lane's
# A gather, the B operands read back through the descriptor, the three
# passes summed a kd at a time), against the plain version and float64.

def _stem64(x, k, scale, shift):
    y = torch.nn.functional.conv3d(x.double().permute(0, 4, 1, 2, 3),
                                   k.double().permute(4, 3, 0, 1, 2),
                                   padding=3)
    return y.permute(0, 2, 3, 4, 1) * scale.double() + shift.double()


def _stem_case(shape, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(*shape, 1).astype(np.float32))
    k = torch.from_numpy(
        (rng.randn(7, 7, 7, 1, 64) * 343 ** -0.5).astype(np.float32))
    scale = torch.from_numpy((rng.rand(64) + 0.5).astype(np.float32))
    shift = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32))
    return x, k, scale, shift


# ragged: extents that the 8 x 16 block tile does not divide
@pytest.mark.parametrize("shape", [(1, 5, 6, 7), (1, 9, 17, 33),
                                   (2, 8, 8, 16)])
def test_stem_conv_tiled_bookkeeping_matches_plain(shape):
    """The kernel's bookkeeping gives the conv: within 1e-5 of the plain
    version's max, and no further from float64 than twice the plain f32
    conv (or one f32 ulp of the max)."""
    x, k, scale, shift = _stem_case(shape, sum(shape))
    got = stem_conv.stem_conv_tiled_ref(x, k, scale, shift, relu=False)
    want = stem_conv.stem_conv_raw_ref(x, k, scale, shift, relu=False)
    want64 = _stem64(x, k, scale, shift)
    scale_ = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale_
    err = (got.double() - want64).abs().max().item()
    err_plain = (want.double() - want64).abs().max().item()
    assert err <= max(2 * err_plain, 2.0 ** -23 * scale_), (err, err_plain)
    relu = stem_conv.stem_conv_tiled_ref(x, k, scale, shift)
    assert torch.equal(relu, torch.clamp_min(got, 0.0))


@pytest.mark.parametrize("drop", ["lo_hi", "hi_lo"])
def test_stem_conv_without_a_cross_term_fails_the_float64_check(drop):
    """The check above refuses two TF32 passes: a dropped cross term errs
    a hundred times more than the plain f32 conv."""
    x, k, scale, shift = _stem_case((1, 5, 6, 7), 1)
    terms = tuple(t for t in stem_conv.TERMS if t != drop)
    got = stem_conv.stem_conv_tiled_ref(x, k, scale, shift, relu=False,
                                        terms=terms)
    want = stem_conv.stem_conv_raw_ref(x, k, scale, shift, relu=False)
    want64 = _stem64(x, k, scale, shift)
    err = (got.double() - want64).abs().max().item()
    err_plain = (want.double() - want64).abs().max().item()
    assert err > 100 * max(err_plain, 2.0 ** -23 * want.abs().max().item())


def test_stem_prepared_weights_are_the_split_taps_in_column_order():
    """B of each (kd, kh) read back through the descriptor and put in
    channel order is the TF32 split of the taps, kw 7 zero; the parts are
    TF32 values (13 low bits clear) that sum to the weights within 2^-21."""
    _, k, _, _ = _stem_case((1, 1, 1, 1), 2)
    wp = stem_conv.prepare_weights(k)  # the plain version, on the CPU
    assert torch.equal(wp, stem_conv.prepare_weights_ref(k))
    assert wp.shape == (49, 2, 2, 8, 8, 4)
    b = stem_conv.operand_b(wp)  # (kd, kh, part, k, column)
    got = torch.empty_like(b)
    got[..., stem_conv.column_channels()] = b
    taps = torch.nn.functional.pad(k.reshape(7, 7, 7, 64), (0, 0, 0, 1))
    hi, lo = tf32_split(taps)
    assert torch.equal(got[:, :, 0], hi) and torch.equal(got[:, :, 1], lo)
    assert not (wp.view(torch.int32) & 0x1fff).any()
    assert (got[:, :, :, 7] == 0).all()
    total = hi.double() + lo.double()
    assert ((total - taps.double()).abs()
            <= 2.0 ** -21 * taps.double().abs()).all()
    assert sorted(stem_conv.column_channels().tolist()) == list(range(64))


def test_stem_lane_gather_is_the_implicit_im2col():
    """What the lanes load, put where the MMA's A fragment puts it, is the
    im2col of the warpgroup's 8 x 8 patch: row m = 16 w + 8 half + g is the
    voxel (2w + half, g) of the patch, k slot k is tap kw = k, and k-step
    kh reads halo row voxel + kh; the halo starts 3 before the tile."""
    hy, wx = stem_conv.a_gather()
    m = torch.arange(64).view(1, 1, 64, 1)
    kh = torch.arange(7).view(1, 7, 1, 1)
    kslot = torch.arange(8).view(1, 1, 1, 8)
    wg = torch.arange(2).view(2, 1, 1, 1)
    assert torch.equal(hy, (2 * (m // 16) + (m % 16) // 8 + kh).expand(
        2, 7, 64, 8))
    assert torch.equal(wx, (8 * wg + m % 8 + kslot).expand(2, 7, 64, 8))
    # inside the halo plane of a 8 x 16 tile: 14 rows, 22 columns + zeros
    assert hy.max().item() == 13 and wx.max().item() == 22
