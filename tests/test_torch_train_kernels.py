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
        "conv3_mxu_dx_bf16": lambda: K.conv3_mxu_dx_bf16(xm, km),
        "maxpool3d_k3s2p1": lambda: K.maxpool3d_k3s2p1(y),
        "maxpool3d_k3s2p1_vjp": lambda: K.maxpool3d_k3s2p1_vjp(
            y, torch.zeros((1, 2, 2, 2, 4))),
        "max_pool2_bwd": lambda: K.max_pool2_bwd(x, torch.zeros(
            (1, 1, 2, 2, 2))),
        "stem_conv_raw": lambda: K.stem_conv_raw(
            torch.zeros((1, 4, 4, 4, 1)),
            torch.zeros((7, 7, 7, 1, 64), requires_grad=True),
            torch.ones(64), torch.zeros(64)),
        "conv3_planes_bf16": lambda: K.conv3_planes_bf16(
            x.detach().bfloat16().requires_grad_(), k),
        "conv3_mxu_bf16": lambda: K.conv3_mxu_bf16(
            xm.detach().bfloat16().requires_grad_(), km.bfloat16()),
        "maxpool3d_k3s2p1_bf16": lambda: K.maxpool3d_k3s2p1_bf16(
            torch.zeros((1, 4, 4, 4, 8), dtype=torch.bfloat16,
                        requires_grad=True)),
        "stem_conv_raw_bf16": lambda: K.stem_conv_raw_bf16(
            torch.zeros((1, 4, 4, 4, 1), dtype=torch.bfloat16),
            torch.zeros((7, 7, 7, 1, 64), dtype=torch.bfloat16,
                        requires_grad=True),
            torch.ones(64), torch.zeros(64)),
        "attend": lambda: K.attend(
            torch.zeros((1, 4, 8), requires_grad=True),
            torch.zeros((1, 6, 8)), torch.zeros((1, 6, 8))),
        "probe_im2col": lambda: K.probe_im2col(
            torch.zeros((8, 8, 8, 128), requires_grad=True)),
        "probe_slice_transpose": lambda: K.probe_slice_transpose(
            torch.zeros((4, 4), requires_grad=True)),
        "probe_dot_f32": lambda: K.probe_dot_f32(
            torch.zeros((4, 4)), torch.zeros((4, 4), requires_grad=True)),
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
    assert set(K.KERNELS) == (set(K.SERVING) | set(K.SERVING_BF16)
                              | set(K.TRAINING) | set(K.TRAINING_DEFAULT)
                              | set(K.TRAINING_BF16) | set(K.SFORMER)
                              | set(K.PROBES))
    assert set(K.KERNELS) == set(_raw_calls())
    for name, (wrapper, ref, source, replaces) in K.KERNELS.items():
        assert wrapper.launches >= 0 and callable(ref), name
        assert source.startswith("hiddenpose_tpu_torch/csrc/"), name
        assert replaces.startswith(
            "scripts/tpu_diag_stem_paired.py:" if name in K.PROBES
            else "hiddenpose_tpu/ops/pallas/"), name


# ------------------------------------- K7 and K6: the kernels' bookkeeping

@pytest.mark.parametrize("tile", [(16, 16), (4, 6), (2, 2)])
@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 4), (1, 9, 17, 33, 4),
                                   (1, 4, 18, 20, 64), (1, 7, 3, 5, 64)])
def test_stem_pool_vjp_tiled_bookkeeping_is_exact(shape, tile):
    """K7's tiles, halos (one voxel before, two after, -inf outside) and
    window indices, in plain PyTorch, against the autograd of the chain:
    odd extents, tiles that do not divide them, C = 4 and 64, post-ReLU
    ties.  Exact: the same powers-of-two weights and two-term sums."""
    from hiddenpose_tpu_torch.ops.kernels import phase_pool

    rng = np.random.RandomState(sum(shape))
    y = _t(_post_relu(rng, shape))
    b, d, h, w, c = shape
    g = _t(_np(rng, b, *(phase_pool.pooled_extent(n) for n in (d, h, w)), c))
    got = phase_pool.maxpool3d_k3s2p1_vjp_tiled_ref(y, g, *tile)
    want = phase_pool.maxpool3d_k3s2p1_vjp_ref(y, g)
    assert got.shape == want.shape and torch.equal(got, want)
    assert float(want.abs().sum()) > 0


WGRAD_SHAPES = [  # (b, cin, cout, d, h, w)
    (2, 1, 1, 5, 6, 7), (2, 3, 5, 5, 6, 7), (1, 4, 4, 9, 17, 40),
    (2, 8, 4, 4, 8, 16), (1, 32, 32, 8, 8, 8), (1, 2, 1, 4, 9, 33)]


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_plan_cuts_every_voxel_into_exactly_one_run(shape):
    """K6's plan: tile widths, channel groups and block columns the kernel
    takes, no more columns than tiles, and the columns' tile runs cover
    each voxel once."""
    b, cin, cout, d, h, w = shape
    plan = conv3p_mod.wgrad_plan(b, cin, cout, d, h, w)
    assert plan["tw"] in (8, 16, 32) and plan["cib"] in (1, 2, 4)
    assert plan["cot"] == (1 if cout == 1 else 4)
    assert plan["cib"] <= max(cin, 1)
    ntiles = int(np.prod(plan["tiles"]))
    assert 1 <= plan["chunks"] <= ntiles
    groups = -(-cin // plan["cib"]) * -(-cout // plan["cot"])
    assert plan["chunks"] * groups <= max(conv3p_mod.WGRAD_BLOCKS, groups)
    masks = conv3p_mod.wgrad_chunk_masks(plan, (b, d, h, w))
    assert len(masks) == plan["chunks"]
    assert torch.equal(sum(masks), torch.ones(b, 1, d, h, w))


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", WGRAD_SHAPES[:4])
def test_wgrad_fixed_order_fold_matches_the_plain_version(shape, pad_mode):
    """K6's two passes in plain PyTorch (a partial row per block column
    over its run of tiles, then the columns summed in order) against the
    one-call plain version: f32 sums in another order, 1e-5 of the max;
    and two folds are bit-identical."""
    b, cin, cout, d, h, w = shape
    rng = np.random.RandomState(sum(shape))
    x, dz = _t(_np(rng, b, cin, d, h, w)), _t(_np(rng, b, cout, d, h, w))
    got = conv3p_mod.conv3_planes_wgrad_fold_ref(x, dz, pad_mode=pad_mode)
    again = conv3p_mod.conv3_planes_wgrad_fold_ref(x, dz, pad_mode=pad_mode)
    want = conv3p_mod.conv3_planes_wgrad_ref(x, dz, pad_mode=pad_mode)
    for a, a2, w_ in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


# K5's tile walk in plain PyTorch (``conv3_planes_adjoint_tiled_ref``):
# K1's on flipped, swapped taps; under edge padding the first and last
# plane keep their outward tap and the tiles on a face of the volume add
# the extra taps of ``fold_taps``.

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_fold_taps_complete_the_reads_that_land_on_each_input(n):
    """For input i the (output o, tap t) with clamp(o + t - 1) == i are the
    forward conv's pairs that lie inside the volume, o = i - 1 + offset
    with t = 2 - offset, plus o = i with each outward tap 2 - staged."""
    for i in range(n):
        got = [(i - 1 + off, 2 - off) for off in range(3)
               if 0 <= i - 1 + off < n]
        got += [(i, 2 - t) for t in conv3p_mod.fold_taps(i, n)]
        want = [(o, t) for o in range(n) for t in range(3)
                if min(max(o + t - 1, 0), n - 1) == i]
        assert sorted(got) == want
        assert (conv3p_mod.fold_taps(i, n) == []) == (0 < i < n - 1)


@pytest.mark.parametrize("shape", [(2, 4, 1, 128, 128, 128),
                                   (1, 3, 5, 5, 48, 96), (1, 2, 2, 3, 8, 8)])
def test_face_tiles_are_the_tiles_with_a_clamped_read(shape):
    """``tile_is_face`` is true exactly for the tiles that hold a row or a
    column with an extra tap."""
    b, src, dst, d, h, w = shape
    plan = conv3p_mod.tile_plan(*shape)
    faces = 0
    for h0 in range(0, h, plan.th):
        for w0 in range(0, w, plan.tw):
            clamped = any(
                conv3p_mod.fold_taps(i, h)
                for i in range(h0, min(h0 + plan.th, h))) or any(
                conv3p_mod.fold_taps(i, w)
                for i in range(w0, min(w0 + plan.tw, w)))
            assert conv3p_mod.tile_is_face(plan, h0, w0, h, w) == clamped
            faces += clamped
    tiles = -(-h // plan.th) * -(-w // plan.tw)
    assert faces == tiles or (h > 2 * plan.th and w > 2 * plan.tw)


ADJOINT_TILED_CASES = [
    # (cin, cout, (d, h, w), plan)
    (1, 1, (1, 1, 1), None), (3, 2, (2, 2, 2), None), (5, 3, (5, 6, 7), None),
    (1, 1, (9, 17, 33), conv3p_mod.TilePlan(32, 1, 4, 2, 1, 4, 1, 1)),
    (3, 5, (9, 17, 33), conv3p_mod.TilePlan(32, 4, 4, 2, 2, 3, 4, 1)),
    (12, 20, (5, 6, 7), conv3p_mod.TilePlan(16, 4, 4, 1, 4, 2, 20, 1)),
    (2, 4, (1, 9, 40), None),
    # an interior tile among 3 x 3 (the compile-time taps under edge
    # padding), D runs of 2 with both end planes folding
    (2, 1, (4, 12, 96), conv3p_mod.TilePlan(32, 4, 4, 1, 1, 2, 1, 1)),
    # channel groups of 2 with 2 splits; one plane a block with 4 splits
    (3, 4, (5, 9, 20), conv3p_mod.TilePlan(32, 4, 4, 1, 2, 2, 2, 1)),
    (9, 5, (3, 9, 12), conv3p_mod.TilePlan(16, 8, 2, 1, 4, 1, 4, 0)),
]


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("cin,cout,dhw,plan", ADJOINT_TILED_CASES)
def test_adjoint_tiled_ref_matches_plain(cin, cout, dhw, plan, pad_mode):
    """1e-5 of the output's max: the two differ in summation order only."""
    rng = np.random.RandomState(11)
    b = 2 if dhw[2] < 30 else 1
    dz = _t(_np(rng, b, cout, *dhw))
    k = _t(_np(rng, 3, 3, 3, cin, cout, scale=(27 * cout) ** -0.5))
    want = K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad_mode)
    got = conv3p_mod.conv3_planes_adjoint_tiled_ref(dz, k, pad_mode=pad_mode,
                                                    plan=plan)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    if plan is not None and dhw == (4, 12, 96):
        assert not conv3p_mod.tile_is_face(plan, plan.th, plan.tw, *dhw[1:])


# ------------------------------------- K8: the kernel's window-per-thread math

@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
@pytest.mark.parametrize("shape", [(2, 4, 8, 10, 12), (1, 3, 5, 7, 9),
                                   (1, 2, 7, 8, 10), (2, 1, 8, 9, 11),
                                   (1, 1, 3, 2, 2)])
def test_pool2_window_per_thread_bookkeeping_is_exact(shape, kind):
    """K8 thread by thread in plain PyTorch (one thread a window, dy's
    order, the voxels past the last window of an odd axis zeroed by the
    window beside them): every voxel written once, and the result bit for
    bit the library backward's at even and odd extents, with ties (the
    first maximum in (d, h, w) order) and NaNs (a later NaN wins)."""
    from hiddenpose_tpu_torch.ops.kernels import pool2p

    rng = np.random.RandomState(sum(shape))
    x = _np(rng, *shape)
    if kind == "ties":
        x = rng.randint(0, 3, size=shape).astype(np.float32)
    elif kind == "nan":
        x = np.where(rng.rand(*shape) < 0.1, np.nan, np.round(x))
    x = _t(x.astype(np.float32))
    dy = _t(_np(rng, *shape[:2], *(s // 2 for s in shape[2:])))
    b, c, d, h, w = shape
    window, extra = pool2p.window_indices(b * c, d, h, w)
    assert window.dtype == extra.dtype == torch.int32
    assert window.shape == (dy.numel(), 8)
    written = torch.cat([window.reshape(-1), extra]).sort().values
    assert torch.equal(written.long(), torch.arange(x.numel()))
    got = pool2p.max_pool2_bwd_windows_ref(x, dy)
    assert torch.equal(got, K.max_pool2_bwd_ref(x, dy))
