"""K4 (``hiddenpose_tpu_torch/ops/kernels/conv3mxu.py``) against the JAX
package's Pallas tap-pack conv, run in interpret mode in f32 on the CPU.

Shapes are the scaled-down Bottleneck conv2 analogues of
``tests/test_conv3mxu.py``.  On the CPU the port's wrapper runs its plain
version; the CUDA kernel is compared with that on the GPU by
``tests/test_torch_kernels_cuda.py``.  Tolerance: both sides are f32 sums
of 27 * C_in products in different orders, so 2e-5 relative and 2e-4
absolute (the JAX kernel's own tolerance against XLA).

The CUDA kernel multiplies on the tensor cores in three TF32 passes
(3xTF32).  Its arithmetic is emulated here in plain PyTorch
(``conv3_mxu_3xtf32_ref``) and held to an error budget before any GPU sees
it: against a float64 conv it may err at most twice as much as the plain
f32 conv, and it must agree with the JAX package's f32 kernel and its dx
to 1e-5 of the output's max.  A one-pass TF32 emulation must fail the same
float64 check, so the check can tell the two apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch.nn.functional as F

from hiddenpose_tpu.ops.pallas.conv3mxu import conv3_mxu as jax_conv3_mxu
from hiddenpose_tpu.ops.pallas.conv3mxu import conv3_mxu_bwd_diff
from hiddenpose_tpu_torch.ops.kernels import conv3_mxu
from hiddenpose_tpu_torch.ops.kernels.conv3mxu import (
    conv3_mxu_3xtf32_ref,
    conv3_mxu_dx_ref,
    conv3_mxu_ref,
    conv3mxu_supported,
    flip_swap,
    prepare_weights,
    prepare_weights_ref,
    tf32_round,
    tf32_split,
    unpack_weights,
)

SHAPES = [
    # (b, d, h, w, cin, cout), as tests/test_conv3mxu.py::SHAPES
    (1, 4, 8, 16, 64, 64),
    (2, 2, 4, 8, 128, 64),
    (1, 2, 8, 32, 64, 128),
    (1, 3, 4, 16, 256, 64),
]


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv3_mxu_matches_jax(shape, epilogue):
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, d, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32) if epilogue else None
    shift = (rng.randn(cout) * 0.1).astype(np.float32) if epilogue else None
    j = [None if a is None else jnp.asarray(a) for a in (x, k, scale, shift)]
    want = jax_conv3_mxu(*j, relu=epilogue, interpret=True,
                         compute_dtype="f32")
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, k, scale, shift)]
    got = conv3_mxu(*t, relu=epilogue)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


def test_supported_channels():
    # the model's stride-1 Bottleneck widths
    assert all(conv3mxu_supported(c, c) for c in (64, 128, 256))
    assert not conv3mxu_supported(8, 64)
    assert not conv3mxu_supported(64, 32)


def test_wrapper_validates_input():
    x = torch.zeros((1, 2, 2, 2, 64))
    k = torch.zeros((3, 3, 3, 64, 64))
    with pytest.raises(ValueError):
        conv3_mxu(x, k, scale=torch.ones(64))          # shift missing
    with pytest.raises(ValueError):
        conv3_mxu(x, torch.zeros((3, 3, 3, 64, 48)))   # C_out % 64
    with pytest.raises(ValueError):
        conv3_mxu(x, k, torch.ones(32), torch.ones(32))


def _is_tf32(t):
    """Every value has its low 13 mantissa bits clear."""
    return bool((t.view(torch.int32) & 0x1FFF).eq(0).all())


def test_tf32_split_parts_are_tf32_and_sum_to_the_input():
    rng = np.random.RandomState(0)
    # magnitudes from 1e-6 to 1e6, both signs
    t = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    hi, lo = tf32_split(t)
    assert _is_tf32(hi) and _is_tf32(lo)
    rel = ((hi.double() + lo.double() - t.double()).abs()
           / t.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    # hi alone is TF32's 11 significant bits, to nearest
    assert ((hi - t).abs() / t.abs()).max().item() <= 2.0 ** -11


def test_tf32_split_zeros_and_infinities():
    t = torch.tensor([0.0, -0.0, float("inf"), float("-inf")])
    hi, lo = tf32_split(t)
    assert torch.equal(hi, t)
    assert torch.equal(torch.signbit(hi), torch.signbit(t))
    assert torch.equal(lo[:2], torch.zeros(2))
    # ties round away from zero, as cvt.rna does: 1 + 2^-11 -> 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tf32_round(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


def _conv64(x, k):
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                 k.double().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def _one_pass_tf32(x, k):
    """What a single TF32 pass would give: the hi parts only."""
    return conv3_mxu_ref(tf32_round(x), tf32_round(k))


def _inputs(c, seed):
    """Small extents that the JAX kernel's layouts take too: W 16 at c64
    (it folds W pairs into lanes), a multiple of 8 at c128 and c256."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 3, 4, 16 if c == 64 else 8, c).astype(np.float32)
    k = (rng.randn(3, 3, 3, c, c) * (27 * c) ** -0.5).astype(np.float32)
    return x, k


@pytest.mark.parametrize("c", [64, 128, 256])
def test_3xtf32_within_the_f32_error_budget(c):
    x, k = (torch.from_numpy(a) for a in _inputs(c, c))
    want = _conv64(x, k)
    err_plain = (conv3_mxu_ref(x, k).double() - want).abs().max().item()
    err_3x = (conv3_mxu_3xtf32_ref(x, k).double() - want).abs().max().item()
    err_1x = (_one_pass_tf32(x, k).double() - want).abs().max().item()
    assert err_3x <= 2 * err_plain, (err_3x, err_plain)
    # the same check must refuse one TF32 pass
    assert err_1x > 20 * err_plain, (err_1x, err_plain)


@pytest.mark.parametrize("c", [64, 128, 256])
def test_3xtf32_dx_within_the_f32_error_budget(c):
    dz, k = (torch.from_numpy(a) for a in _inputs(c, c + 1))
    want = _conv64(dz, flip_swap(k))
    err_plain = (conv3_mxu_dx_ref(dz, k).double() - want).abs().max().item()
    got = conv3_mxu_3xtf32_ref(dz, flip_swap(k))
    err_3x = (got.double() - want).abs().max().item()
    err_1x = (_one_pass_tf32(dz, flip_swap(k)).double()
              - want).abs().max().item()
    assert err_3x <= 2 * err_plain, (err_3x, err_plain)
    assert err_1x > 20 * err_plain, (err_1x, err_plain)


@pytest.mark.parametrize("c", [64, 128, 256])
def test_3xtf32_matches_jax_f32_kernel(c):
    x, k = _inputs(c, 2 * c)
    rng = np.random.RandomState(7)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = (rng.randn(c) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv3_mxu(
        *(jnp.asarray(a) for a in (x, k, scale, shift)), relu=True,
        interpret=True, compute_dtype="f32"))
    got = conv3_mxu_3xtf32_ref(
        *(torch.from_numpy(a) for a in (x, k, scale, shift)), relu=True)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", [64, 128, 256])
def test_3xtf32_dx_matches_jax_bwd_diff(c, monkeypatch):
    monkeypatch.setenv("HP_CONV3MXU_DT", "f32")
    x, k = _inputs(c, 3 * c)
    dy = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda x_: (conv3_mxu_bwd_diff(x_, jnp.asarray(k))
                    * jnp.asarray(dy)).sum())(jnp.asarray(x)))
    got = conv3_mxu_3xtf32_ref(torch.from_numpy(dy),
                               flip_swap(torch.from_numpy(k)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 64)])
def test_weight_preparation_round_trips(cin, cout, transposed):
    rng = np.random.RandomState(cin + cout)
    k = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32))
    wp = prepare_weights(k, transposed)      # the plain version, on the CPU
    assert torch.equal(wp, prepare_weights_ref(k, transposed))
    w = flip_swap(k) if transposed else k    # the conv the kernel runs
    assert wp.shape == (27 * w.shape[3] // 16, w.shape[4] // 64, 2, 2, 2, 8,
                        8, 4)
    hi, lo = unpack_weights(wp)
    want_hi, want_lo = tf32_split(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert ((hi.double() + lo.double() - w.double()).abs()
            <= 2.0 ** -21 * w.double().abs()).all()


def test_prepared_weights_feed_the_mma_operands():
    """The layout, read as the kernel's MMAs read it: of k-step kb and
    n-block nb, element e of row r of core matrix (kc, ng) of MMA kk is k
    slot 4 kc + e, input channel 4e + 2kk + kc of the k-step, at column r
    of n-tile ng, output channel 16 (ng / 2) + 4 (r / 2) + 2 (ng % 2) +
    r % 2 of the block."""
    cin, cout = 32, 128
    # index-valued weights (up to 17 bits: hi + lo holds them exactly)
    k = torch.arange(27 * cin * cout, dtype=torch.float32).reshape(
        3, 3, 3, cin, cout) * 2.0 ** -4
    wp = prepare_weights_ref(k)
    flat = k.reshape(27, cin, cout)
    for kb, nb, kk, kc, ng, r, e in [(0, 0, 0, 0, 0, 0, 0),
                                     (5, 1, 1, 0, 3, 6, 2),
                                     (53, 1, 0, 1, 7, 7, 3)]:
        tap, c16 = divmod(kb, cin // 16)
        ci = c16 * 16 + 4 * e + 2 * kk + kc
        co = nb * 64 + (ng // 2) * 16 + 4 * (r // 2) + 2 * (ng % 2) + r % 2
        hi, lo = (wp[kb, nb, part, kk, kc, ng, r, e].item()
                  for part in (0, 1))
        assert hi + lo == flat[tap, ci, co].item()
