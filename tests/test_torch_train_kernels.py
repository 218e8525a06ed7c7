"""The train step's kernels (K5-K8, K4-dx) and their ``autograd.Function``s,
on the CPU, against the JAX package.

* The plain versions the CPU wrappers run are held against the Pallas
  kernels in interpret mode, as the JAX package's own tests call them, and
  against the JAX autodiff those kernels replace.  Tolerances: K5 and K6
  are f32 sums in another order, 1e-5 of the output's max; K7 splits ties
  by powers of two, so it is exact against the autodiff of the XLA chain
  and within 2 ulp (of the largest cotangent it sums) of the Pallas
  kernel, which groups its sums differently; K8 routes values and is
  exact.
* Each Function's backward is held against the autograd of its plain
  forward: masks, ``dres``, ``needs_input_grad`` and the relu / leaky
  rules at exactly 0.
* The repairs of the port's train path: raw kernel wrappers refuse inputs
  that require grad (on the GPU their outputs would have no ``grad_fn``),
  the stem pool splits ties 0.5/0.5, and relu's gradient at 0 is 0.
The CUDA kernels themselves are held against these plain versions on the
GPU by ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hiddenpose_tpu.models.unet3d import max_pool2_planes
from hiddenpose_tpu.ops.pallas.conv3p import (
    conv3_planes_adjoint as jax_adjoint,
    conv3_planes_wgrad as jax_wgrad,
    conv3_planes_xla,
)
from hiddenpose_tpu.ops.pallas.phase_pool import phase_maxpool_vjp_pallas
from hiddenpose_tpu.ops.pallas.pool2p import pool2_bwd_planes_pallas
from hiddenpose_tpu.ops.space_to_depth import (
    depth_to_space_3d,
    phase_maxpool_k3s2,
    space_to_depth_3d,
)
from hiddenpose_tpu_torch.ops import kernels as K
from hiddenpose_tpu_torch.ops.kernels import conv3p as conv3p_mod
from hiddenpose_tpu_torch.ops.kernels.conv3mxu import flip_swap


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _xla_conv_vjp(x, k, dz, pad_mode):
    """JAX autodiff of the reference semantics, (dx, dk, db)."""
    def f(x, k, b):
        return conv3_planes_xla(x, k, b, pad_mode=pad_mode)
    b = jnp.zeros((k.shape[4],), jnp.float32)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), b)
    return [np.asarray(v) for v in vjp(jnp.asarray(dz))]


# ---------------------------------------------------------------- K5, K6

PALLAS_CASES = [  # (cin, cout, d, h, w): H % 8 == 0, W <= 128
    (1, 1, 4, 8, 16), (1, 4, 4, 8, 16), (4, 4, 4, 8, 16), (4, 8, 2, 8, 8),
    (8, 4, 2, 8, 8),
]


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("cin,cout,d,h,w", PALLAS_CASES)
def test_adjoint_ref_matches_pallas(cin, cout, d, h, w, pad_mode):
    rng = np.random.RandomState(cin * 10 + cout)
    dz, k = _np(rng, 2, cout, d, h, w), _np(rng, 3, 3, 3, cin, cout, scale=0.2)
    want = np.asarray(jax_adjoint(jnp.asarray(dz), jnp.asarray(k),
                                  pad_mode=pad_mode, interpret=True))
    got = K.conv3_planes_adjoint(_t(dz), _t(k), pad_mode=pad_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("cin,cout,d,h,w", PALLAS_CASES)
def test_wgrad_ref_matches_pallas(cin, cout, d, h, w, pad_mode):
    if cin * cout > 32:
        pytest.skip("the Pallas wgrad takes cin * cout <= 32")
    rng = np.random.RandomState(cin * 10 + cout + 1)
    x, dz = _np(rng, 2, cin, d, h, w), _np(rng, 2, cout, d, h, w)
    dk_w, db_w = jax_wgrad(jnp.asarray(x), jnp.asarray(dz),
                           pad_mode=pad_mode, interpret=True)
    dk, db = K.conv3_planes_wgrad(_t(x), _t(dz), pad_mode=pad_mode)
    for got, want in ((dk, dk_w), (db, db_w)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(3, 3, 3), (3, 4, 5), (5, 3, 4), (1, 2, 3)])
def test_adjoint_wgrad_tiny_volumes_match_jax_autodiff(shape, pad_mode):
    """Every voxel a boundary voxel: the edge-pad folding at corners (up to
    8 folded terms) against JAX's autodiff of pad + VALID conv."""
    rng = np.random.RandomState(sum(shape))
    cin, cout = 2, 3
    x, k = _np(rng, 2, cin, *shape), _np(rng, 3, 3, 3, cin, cout, scale=0.3)
    dz = _np(rng, 2, cout, *shape)
    dx_w, dk_w, db_w = _xla_conv_vjp(x, k, dz, pad_mode)
    dx = K.conv3_planes_adjoint(_t(dz), _t(k), pad_mode=pad_mode).numpy()
    dk, db = K.conv3_planes_wgrad(_t(x), _t(dz), pad_mode=pad_mode)
    for got, want in ((dx, dx_w), (dk.numpy(), dk_w), (db.numpy(), db_w)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_wgrad_without_bias():
    rng = np.random.RandomState(5)
    dk, db = K.conv3_planes_wgrad(_t(_np(rng, 1, 2, 3, 4, 5)),
                                  _t(_np(rng, 1, 3, 3, 4, 5)), has_bias=False)
    assert dk.shape == (3, 3, 3, 2, 3) and db is None


# ---------------------------------------------------------------- K7

def _post_relu(rng, shape):
    """ReLU data on a coarse grid: most windows hold several exact zeros
    and many hold repeated positive maxima."""
    return np.maximum(np.round(rng.randn(*shape), 1), 0.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 16), (2, 8, 16, 16, 16)])
def test_stem_pool_vjp_ref_matches_jax(shape):
    rng = np.random.RandomState(7)
    y = _post_relu(rng, shape)
    b, d, h, w, c = shape
    g = _np(rng, b, d // 2, h // 2, w // 2, c)
    got = K.maxpool3d_k3s2p1_vjp(_t(y), _t(g)).numpy()
    y2 = space_to_depth_3d(jnp.asarray(y))
    # exact against the autodiff of the XLA chain the kernel replaces
    chain = jax.vjp(phase_maxpool_k3s2, y2)[1](jnp.asarray(g))[0]
    np.testing.assert_array_equal(got, np.asarray(depth_to_space_3d(chain)))
    # within 2 ulp of the largest |g| against the Pallas kernel
    pallas = np.asarray(depth_to_space_3d(
        phase_maxpool_vjp_pallas(y2, jnp.asarray(g), interpret=True)))
    np.testing.assert_allclose(got, pallas, rtol=0,
                               atol=2 * np.spacing(np.abs(g).max()))


def test_stem_pool_ties_split_half_and_half():
    """Repair: an all-zero window (the common case after the stem's ReLU)
    splits its cotangent 0.5/0.5 at every maximum of the chain, as the
    JAX package's autodiff does; F.max_pool3d's would send it all to one
    element."""
    y = torch.zeros((1, 4, 4, 4, 4), requires_grad=True)
    out = K.maxpool3d_k3s2p1_ref(y)
    assert torch.equal(out, F.max_pool3d(
        y.detach().permute(0, 4, 1, 2, 3), 3, 2, 1).permute(0, 2, 3, 4, 1))
    out.sum().backward()
    want = jax.grad(lambda v: phase_maxpool_k3s2(v).sum())(
        jnp.zeros((1, 2, 2, 2, 32), jnp.float32))
    np.testing.assert_array_equal(y.grad.numpy(),
                                  np.asarray(depth_to_space_3d(want)))
    # not the first-element rule: more than one element per window is hit
    assert (y.grad > 0).sum() > out.numel()


def test_stem_pool_ref_odd_extents():
    rng = np.random.RandomState(8)
    y = _t(_post_relu(rng, (1, 5, 6, 7, 4)))
    want = F.max_pool3d(y.permute(0, 4, 1, 2, 3), 3, 2, 1)
    assert torch.equal(K.maxpool3d_k3s2p1_ref(y),
                       want.permute(0, 2, 3, 4, 1).contiguous())


# ---------------------------------------------------------------- K8

POOL2_SHAPES = [(1, 2, 4, 32, 64), (2, 3, 4, 32, 32), (1, 2, 2, 16, 16)]


@pytest.mark.parametrize("kind", ["random", "ties", "all_ties"])
@pytest.mark.parametrize("shape", POOL2_SHAPES)
def test_pool2_bwd_ref_matches_pallas(shape, kind):
    rng = np.random.RandomState(9)
    if kind == "random":
        x = _np(rng, *shape)
    elif kind == "ties":
        x = rng.randint(0, 3, size=shape).astype(np.float32)
    else:
        x = np.ones(shape, np.float32)
    dy = _np(rng, *shape[:2], *(s // 2 for s in shape[2:]))
    got = K.max_pool2_bwd(_t(x), _t(dy)).numpy()
    want = pool2_bwd_planes_pallas(jnp.asarray(x), jnp.asarray(dy),
                                   interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    autodiff = jax.vjp(max_pool2_planes, jnp.asarray(x))[1](
        jnp.asarray(dy))[0]
    np.testing.assert_array_equal(got, np.asarray(autodiff))


# ---------------------------------------------------------------- K4-dx

def test_conv3_mxu_dx_ref_is_the_flipped_conv():
    """dx = the same conv on flipped, in/out-swapped taps (what K4-dx runs
    on the GPU) = conv3d_input (the plain version)."""
    rng = np.random.RandomState(10)
    dz, k = _t(_np(rng, 1, 3, 4, 5, 64)), _t(_np(rng, 3, 3, 3, 64, 64,
                                                  scale=0.05))
    flipped = K.conv3_mxu_ref(dz, flip_swap(k))
    got = K.conv3_mxu_dx(dz, k)
    torch.testing.assert_close(got, flipped, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the autograd.Functions

def _grads(fn, inputs, g):
    for t in inputs:
        if t is not None and t.grad is not None:
            t.grad = None
    out = fn(*inputs)
    out.backward(g)
    return out.detach(), [None if t is None or t.grad is None
                          else t.grad.clone() for t in inputs]


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("bias,residual", [(True, True), (False, False)])
def test_conv3_planes_function_matches_plain_autograd(act, pad_mode, bias,
                                                      residual):
    rng = np.random.RandomState(11)
    b, cin, cout, shape = 2, 3, 2, (4, 5, 6)
    x = _t(_np(rng, b, cin, *shape), True)
    k = _t(_np(rng, 3, 3, 3, cin, cout, scale=0.2), True)
    bb = _t(_np(rng, cout), True) if bias else None
    res = _t(_np(rng, b, cout, *shape), True) if residual else None
    g = _t(_np(rng, b, cout, *shape))
    kw = dict(act=act, pad_mode=pad_mode)
    out, got = _grads(lambda *a: K.conv3_planes_diff(*a, **kw),
                      [x, k, bb, res], g)
    want_out, want = _grads(lambda *a: K.conv3_planes_ref(*a, **kw),
                            [x, k, bb, res], g)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act,slope_at_zero", [("relu", 0.0),
                                               ("leaky", 1.0)])
def test_activation_gradient_at_exactly_zero(act, slope_at_zero):
    """Repair: relu's gradient at an output of exactly 0 is 0 (the JAX
    backward's ``out > 0`` mask; ``clamp_min``'s would be 1), leaky's is 1
    (``out >= 0``), in the Function and in the plain version alike."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.zeros((3, 3, 3, 1, 1))
    res = torch.zeros((1, 1, 3, 3, 3), requires_grad=True)
    for fn in (K.conv3_planes_diff, K.conv3_planes_ref):
        res.grad = None
        fn(x, k, None, res, act=act).sum().backward()
        assert torch.equal(res.grad, torch.full_like(res, slope_at_zero))


def test_conv3_planes_function_skips_unneeded_grads(monkeypatch):
    """No dx (K5) when x needs no gradient, as for the measurement fed to
    FeatureExtraction; no dk (K6) when neither kernel nor bias needs one."""
    calls = []
    real_adj, real_wg = conv3p_mod.conv3_planes_adjoint, \
        conv3p_mod.conv3_planes_wgrad
    monkeypatch.setattr(conv3p_mod, "conv3_planes_adjoint",
                        lambda *a, **k: calls.append("dx") or real_adj(*a, **k))
    monkeypatch.setattr(conv3p_mod, "conv3_planes_wgrad",
                        lambda *a, **k: calls.append("dk") or real_wg(*a, **k))
    rng = np.random.RandomState(12)
    x = _t(_np(rng, 1, 1, 3, 4, 5))
    k = _t(_np(rng, 3, 3, 3, 1, 1), True)
    K.conv3_planes_diff(x, k).sum().backward()
    assert calls == ["dk"] and x.grad is None
    calls.clear()
    x.requires_grad_(True)
    K.conv3_planes_diff(x, k.detach()).sum().backward()
    assert calls == ["dx"]


def test_conv3_mxu_function_matches_plain_autograd():
    rng = np.random.RandomState(13)
    x = _t(_np(rng, 1, 3, 4, 5, 64), True)
    k = _t(_np(rng, 3, 3, 3, 64, 64, scale=0.05), True)
    g = _t(_np(rng, 1, 3, 4, 5, 64))
    out, got = _grads(K.conv3_mxu_diff, [x, k], g)
    want_out, want = _grads(K.conv3_mxu_ref, [x, k], g)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)


def test_pool_functions_match_plain_autograd():
    rng = np.random.RandomState(14)
    y = _t(_post_relu(rng, (2, 6, 7, 8, 8)), True)
    g = _t(_np(rng, 2, 3, 4, 4, 8))
    out, got = _grads(K.maxpool3d_k3s2p1_diff, [y], g)
    want_out, want = _grads(K.maxpool3d_k3s2p1_ref, [y], g)
    assert torch.equal(out, want_out) and torch.equal(got[0], want[0])

    x = _t(rng.randint(0, 3, size=(2, 3, 4, 6, 8)).astype(np.float32), True)
    g = _t(_np(rng, 2, 3, 2, 3, 4))
    out, got = _grads(K.max_pool2_diff, [x], g)
    want_out, want = _grads(lambda v: F.max_pool3d(v, 2), [x], g)
    assert torch.equal(out, want_out) and torch.equal(got[0], want[0])


# ---------------------------------------------------- the grad-mode guard

def _raw_calls():
    x = torch.zeros((1, 1, 4, 4, 4), requires_grad=True)
    k = torch.zeros((3, 3, 3, 1, 1))
    y = torch.zeros((1, 4, 4, 4, 4), requires_grad=True)
    xm = torch.zeros((1, 2, 2, 2, 64), requires_grad=True)
    km = torch.zeros((3, 3, 3, 64, 64))
    return {
        "conv3_planes": lambda: K.conv3_planes(x, k),
        "conv3_planes_adjoint": lambda: K.conv3_planes_adjoint(x, k),
        "conv3_planes_wgrad": lambda: K.conv3_planes_wgrad(x, x),
        "conv3_mxu": lambda: K.conv3_mxu(xm, km),
        "conv3_mxu_dx": lambda: K.conv3_mxu_dx(xm, km),
        "maxpool3d_k3s2p1": lambda: K.maxpool3d_k3s2p1(y),
        "maxpool3d_k3s2p1_vjp": lambda: K.maxpool3d_k3s2p1_vjp(
            y, torch.zeros((1, 2, 2, 2, 4))),
        "max_pool2_bwd": lambda: K.max_pool2_bwd(x, torch.zeros(
            (1, 1, 2, 2, 2))),
        "stem_conv_raw": lambda: K.stem_conv_raw(
            torch.zeros((1, 4, 4, 4, 1)),
            torch.zeros((7, 7, 7, 1, 64), requires_grad=True),
            torch.ones(64), torch.zeros(64)),
    }


@pytest.mark.parametrize("name", sorted(_raw_calls()))
def test_raw_wrappers_refuse_inputs_that_require_grad(name):
    """Repair: on the GPU a kernel writes a fresh tensor through a pointer,
    so its output has no grad_fn and a backward would silently skip every
    weight before it.  Each raw wrapper therefore refuses an input that
    requires grad while grad mode is on (here on the CPU too); with grad
    mode off it runs."""
    call = _raw_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        call()


def test_every_kernel_is_listed():
    assert set(K.KERNELS) == set(K.SERVING) | set(K.TRAINING)
    for name, (wrapper, ref, source, replaces) in K.KERNELS.items():
        assert wrapper.launches >= 0 and callable(ref), name
        assert source.startswith("hiddenpose_tpu_torch/csrc/"), name
        assert replaces.startswith("hiddenpose_tpu/ops/pallas/"), name
