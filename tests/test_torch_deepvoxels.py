"""DeepVoxels and its blocks: the port (``models/deepvoxels.py``,
``models/blocks.py``: ``Transient2Volumn``, ``FeatureExtraction(stride=2)``,
``SmartConv3D``) against the JAX package's, on the CPU, weights carried
by ``utils/jax_bridge.py``.

* ``Transient2Volumn`` and the stride-2 ``FeatureExtraction`` (odd and
  even extents): the forward within 1e-5 of the largest output, and the
  VJP of a fixed cotangent (input and every parameter) within 1e-5 by
  relative L2 (f32 convs summed in another order; LeakyReLU has no flat
  region to amplify them); their bf16 forms a bf16 output within half the
  JAX module's own bf16-vs-f32 distance of its bf16 output.
* ``SmartConv3D`` (f32 and bf16: its conv rounded once, then the bias in
  bf16) within 1e-5 / one bf16 ulp of the largest output.
* ``DeepVoxels`` (basedim 4): the forward within 1e-4 of its 1e5 scale
  (two f32 normalisations around an f32 FFT, 1e-5 of the LCT's peak
  apart, as ``test_torch_lct.py`` holds the LCT), and the VJP within 1e-3
  by relative L2 (the normalize's min / max gradients reach the input
  through the LCT's adjoint).
* ``deepvoxels_noise``: the JAX formula on the same draws, bit for bit;
  seeded draws that repeat and whose moments are the formula's.
* The bridge's round trip of each tree, against the JAX modules'
  structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.models import blocks as jax_blocks
from hiddenpose_tpu.models import deepvoxels as jax_dv
from hiddenpose_tpu_torch.models.blocks import (
    FeatureExtraction,
    SmartConv3D,
    Transient2Volumn,
)
from hiddenpose_tpu_torch.models.deepvoxels import (
    DeepVoxels,
    build_deepvoxels,
    deepvoxels_noise,
)
from hiddenpose_tpu_torch.ops.kernels import bf16_ulp_excess
from hiddenpose_tpu_torch.utils.jax_bridge import (
    deepvoxels_layout,
    dual_branch_layout,
    layout_state_dict_from_jax,
    layout_to_jax,
)
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

BF16 = jnp.bfloat16


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2))


def _random_params(shapes, seed):
    """Fan-in scaled kernels (the corner kernel kept as initialised,
    positive), random biases."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "corner" in name:
            return jnp.asarray(rng.rand(*leaf.shape) / 8, jnp.float32)
        if len(leaf.shape) == 1:
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), jnp.float32)
        return jnp.asarray(rng.randn(*leaf.shape)
                           / np.sqrt(np.prod(leaf.shape[:-1])), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _ndhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 4, 1)


def _ncdhw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 4, 1, 2, 3)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_vjp(apply, params, x, r):
    """apply(params, x) and its VJP of the cotangent ``r``, one compile."""
    def f(p, xin, rr):
        y, vjp = jax.vjp(apply, p, xin)
        return y, vjp(rr)

    y, (gp, gx) = jax.jit(f)(params, jnp.asarray(x), jnp.asarray(r))
    return np.asarray(y), gp, np.asarray(gx)


def _block_pair(kind, x, cin, seed):
    jm = (jax_blocks.Transient2Volumn(basedim=2) if kind == "t2v"
          else jax_blocks.FeatureExtraction(basedim=2, stride=2))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": _random_params(shapes["params"], seed)}
    port = (Transient2Volumn(2, cin) if kind == "t2v"
            else FeatureExtraction(2, cin, stride=2))
    layout = dual_branch_layout("", ())
    layout = [(n[1:], c, p, k) for n, c, p, k in layout]
    port.load_state_dict(layout_state_dict_from_jax(v, layout))
    return jm, v, port, layout


@pytest.mark.parametrize("kind,shape", [
    ("t2v", (1, 7, 8, 9, 2)), ("fe2", (2, 9, 7, 8, 1))],
    ids=["t2v_odd_2ch", "fe2_odd"])
def test_stride2_block_forward_and_vjp_match_jax(kind, shape):
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    jm, v, port, layout = _block_pair(kind, x, shape[-1], 1)
    y_shape = jax.eval_shape(jm.apply, v, jnp.asarray(x)).shape
    r = rng.randn(*y_shape).astype(np.float32)
    y, gp, gx = _jax_vjp(lambda p, xin: jm.apply({"params": p}, xin),
                         v["params"], x, r)

    xt = _ncdhw(x).requires_grad_()
    out = port(xt)
    assert out.shape[1] == (3 if kind == "t2v" else 2)
    np.testing.assert_allclose(_ndhwc(out.detach()), y, rtol=0,
                               atol=1e-5 * np.abs(y).max())
    (out * _ncdhw(r)).sum().backward()
    assert _rel_l2(_ndhwc(xt.grad), gx) < 1e-5
    got = _leaves(layout_to_jax({n: p.grad for n, p in
                                 port.named_parameters()}, layout))
    want = _leaves(gp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel_l2(got[k], w) < 1e-5, k


def test_stride2_blocks_in_bf16_round_as_jax():
    """The bf16 forms: a bf16 output, within a few bf16 ulps of the JAX
    module's (its library convs, which the port's stride-2 path follows)
    and away from the f32 output."""
    x = np.random.RandomState(2).rand(1, 8, 8, 8, 1).astype(np.float32)
    for kind in ("t2v", "fe2"):
        jm, v, port, _ = _block_pair(kind, x, 1, 3)
        want = np.asarray(jm.clone(dtype=BF16).apply(
            v, jnp.asarray(x)).astype(jnp.float32))
        want32 = np.asarray(jm.apply(v, jnp.asarray(x)))
        p16 = (Transient2Volumn(2, 1, dtype=torch.bfloat16) if kind == "t2v"
               else FeatureExtraction(2, 1, dtype=torch.bfloat16, stride=2))
        p16.load_state_dict(port.state_dict())
        with torch.no_grad():
            got = p16(_ncdhw(x))
        assert got.dtype == torch.bfloat16
        got = _ndhwc(got.float())
        own = np.abs(want - want32).max()
        assert own > 0
        assert np.abs(got - want).max() <= 0.5 * own + 1e-6, kind


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smart_conv3d_matches_jax(dtype):
    rng = np.random.RandomState(4)
    x = rng.rand(2, 6, 8, 8, 3).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else BF16
    jm = jax_blocks.SmartConv3D(features=5, dtype=jdt)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": _random_params(shapes["params"], 5)}
    want = jm.apply(v, jnp.asarray(x))
    assert want.dtype == jdt
    port = SmartConv3D(3, 5, dtype=getattr(torch, dtype))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(
            v["params"]["kernel"])).permute(4, 3, 0, 1, 2))
        port.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = port(_ncdhw(x))
    assert str(got.dtype) == f"torch.{dtype}"
    want = np.asarray(want.astype(jnp.float32))
    got = _ndhwc(got.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:  # the conv rounded, then the bias added in bf16: one ulp each
        assert bf16_ulp_excess(torch.from_numpy(got), torch.from_numpy(want),
                               2 ** -8 * np.abs(want).max()) <= 0


DV = dict(basedim=4, image_size=16, time_size=32, bin_len=0.02)


@pytest.fixture(scope="module")
def dv_pair():
    rng = np.random.RandomState(6)
    x = rng.rand(2, 1, 32, 16, 16).astype(np.float32)
    jm, jlct = jax_dv.build_deepvoxels(**DV)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jlct)
    v = {"params": _random_params(shapes["params"], 7)}
    port, lct = build_deepvoxels(**DV, device="cpu")
    port.load_state_dict(layout_state_dict_from_jax(v, deepvoxels_layout()))
    return dict(x=x, jm=jm, jlct=jlct, v=v, port=port, lct=lct)


def test_deepvoxels_forward_and_vjp_match_jax(dv_pair):
    d = dv_pair
    x, jm, jlct, v, port = d["x"], d["jm"], d["jlct"], d["v"], d["port"]
    r = np.random.RandomState(8).randn(2, 5, 12, 8, 8).astype(np.float32)
    y, gp, gx = _jax_vjp(lambda p, xin: jm.apply({"params": p}, xin, jlct),
                         v["params"], x, r)
    assert y.shape == r.shape  # 1 + basedim, 16 * 100 // 128

    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, d["lct"])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=0,
                               atol=1e-4 * np.abs(y).max())
    (out * torch.from_numpy(r)).sum().backward()
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-3
    got = _leaves(layout_to_jax({n: p.grad for n, p in
                                 port.named_parameters()},
                                deepvoxels_layout()))
    want = _leaves(gp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel_l2(got[k], w) < 1e-3, k


def test_deepvoxels_bridge_round_trip(dv_pair):
    sd = DeepVoxels(basedim=4).state_dict()
    tree = layout_to_jax(sd, deepvoxels_layout())
    shapes = jax.eval_shape(dv_pair["jm"].init, jax.random.PRNGKey(0),
                            jnp.asarray(dv_pair["x"]), dv_pair["jlct"])
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(shapes["params"])
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(shapes["params"])):
        assert a.shape == b.shape
    back = layout_state_dict_from_jax({"params": tree}, deepvoxels_layout())
    assert back.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("kind", ["t2v", "fe2"])
def test_dual_branch_bridge_round_trip(kind):
    x = np.zeros((1, 8, 8, 8, 1), np.float32)
    jm, v, port, layout = _block_pair(kind, x, 1, 9)
    tree = layout_to_jax(port.state_dict(), layout)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(v["params"])
    for k, a in _leaves(tree).items():
        np.testing.assert_array_equal(a, _leaves(v["params"])[k])


def test_deepvoxels_noise_is_the_jax_formula(monkeypatch):
    """On the same draws (the JAX function's ``jax.random.normal`` made to
    return them), bit for bit; seeded draws repeat; over a large sample
    the mean moves by 0.05 + E[0.03 n2 gau] = 0.05."""
    rng = np.random.RandomState(10)
    data = rng.rand(3, 4, 5).astype(np.float32)
    n1, n2 = (rng.randn(3, 4, 5).astype(np.float32) for _ in range(2))
    draws = iter([jnp.asarray(n1), jnp.asarray(n2)])
    monkeypatch.setattr(jax_dv.jax.random, "normal",
                        lambda key, shape, dtype: next(draws))
    want = np.asarray(jax_dv.deepvoxels_noise(jax.random.PRNGKey(0),
                                              jnp.asarray(data)))
    got = deepvoxels_noise(torch.from_numpy(data), draws=(
        torch.from_numpy(n1), torch.from_numpy(n2))).numpy()
    np.testing.assert_array_equal(got, want)

    big = torch.full((200000,), 0.5)
    a = deepvoxels_noise(big, torch.Generator().manual_seed(1))
    b = deepvoxels_noise(big, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.equal(a, deepvoxels_noise(
        big, torch.Generator().manual_seed(2)))
    # gau ~ 0.55 + 0.03 n1; out = gau (1 + 0.03 n2): mean 0.55, variance
    # 0.03^2 + 0.03^2 E[gau^2]
    var = 0.03 ** 2 + 0.03 ** 2 * (0.55 ** 2 + 0.03 ** 2)
    assert abs(a.mean().item() - 0.55) < 5 * np.sqrt(var / big.numel())
    assert abs(a.var().item() / var - 1) < 0.02
