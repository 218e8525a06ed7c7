"""The train step at the JAX package's default precision and in bfloat16,
on the CPU, against the JAX package.

Inputs come from numpy seeds.  At 'default' the JAX router sends each
admitted Bottleneck conv2 the 'bwd' way: the library's forward, and dx by
the Pallas kernel at ``compute_dtype='bf16'`` (dz and the flipped, swapped
taps rounded to bf16, one pass with f32 sums).  The port's K4-dx-bf16
(``conv3_mxu_dx_bf16``) runs its plain version here, ``conv3d_input`` of
the rounded operands in f32.  Tolerances, each from the readings given
beside it:

* K4-dx-bf16 against the Pallas kernel in interpret mode: the same exact
  products of bf16 values summed in another order, so the f32 result within
  1e-5 of its max (read: at most 6e-7), the bf16 one within one bf16 ulp
  of each output plus 2^-16 of the max (read: 0 excess).
* The 'bwd' route's VJP (``Conv3MxuBwd``) against ``jax.vjp`` of
  ``conv3_mxu_bwd_diff`` under ``jax.default_matmul_precision``: float32
  within 1e-5 of each output's max (read: at most 8e-7); bfloat16 within
  one bf16 ulp plus 2^-16 of the max (read: 0 excess).  At 'highest' the
  JAX kernel computes in f32 and the port takes the 'full' route; at
  'default' the dx must lie at least 1e-4 of its max from the f32 one
  (read: 3e-3), so that the check tells bf16 from f32.
* ``Conv3Planes``, ``MaxPoolK3S2P1`` and ``MaxPool2`` on bf16 against the
  JAX custom VJPs (Pallas in interpret mode): K1-bf16's output and dx, the
  rounded cotangents, within one bf16 ulp (read: 0 excess), its f32 dk and
  db within 1e-5 of their max (read: 4e-7); the pools exact (read: exact).
* The bf16 model's modules in training, each against the JAX module on
  the same weights with the JAX package's Pallas gates on (as on its own
  hardware): FeatureExtraction, a DoubleConv on the kernel route and one
  on the library route, GroupNormP, OutConv, the trilinear x2, the LCT,
  a c64 Bottleneck at 'default' and the stem with its pool.  Each reading
  (output, input and parameter gradients, new statistics) lies within a
  share of the JAX module's own bf16-vs-f32 distance set from its reading
  (``PART_LIMITS``; the Bottleneck 0.5, read 0.28; the stem 0.15, read
  0.064), and the port's bf16 lies at least half that distance from its
  own f32.  The JAX side is compiled without XLA's excess precision
  (``_exact_jit``), which otherwise drops roundings the program writes.
  The whole bf16 UNet is not held so: it is chaotic in itself (the JAX
  UNet moves by 0.56 of its bf16-vs-f32 distance when its input moves by
  1e-6), so its parts are.
* The whole steps, one f32 step at 'default' and one bf16 step against
  the JAX package's, are ``tests/test_torch_train_precision_steps.py``
  (a file of their own, so that the test runner's workers can take them
  apart from these module-level tests).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hiddenpose_tpu.ops.pallas.conv3mxu as jax_conv3mxu
from hiddenpose_tpu.config import Config
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.models.unet3d import max_pool2_planes
from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes_diff as jax_k1_diff
from hiddenpose_tpu.ops.pallas.phase_pool import phase_maxpool_diff
from hiddenpose_tpu.ops.pallas.pool2p import pool2_bwd_planes_pallas
from hiddenpose_tpu.ops.space_to_depth import (
    depth_to_space_3d,
    space_to_depth_3d,
)
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config as PortConfig
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.ops import kernels as K
from hiddenpose_tpu_torch.ops.kernels import conv3mxu
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax, to_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

BF16 = torch.bfloat16
SIZE = 32


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _bf16_np(a):
    """``a`` rounded to bf16, as float32 numpy (what both packages get)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _excess(got, want):
    """How far ``got`` strays beyond one bf16 ulp of ``want`` plus 2^-16 of
    its max (<= 0 passes)."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    return K.bf16_ulp_excess(got, want, 2.0 ** -16 * want.abs().max().item())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ----------------------------------------------------------- K4-dx-bf16

# (b, d, h, w, c_in, c_out) of the forward conv; its dx runs the kernel
# c_out -> c_in, which the JAX kernel takes at these W (64 folded: W / 2 a
# multiple of 8; 128: W a multiple of 8)
DX_SHAPES = [(1, 4, 8, 16, 64, 64), (1, 2, 8, 16, 128, 64),
             (1, 3, 4, 16, 64, 128)]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DX_SHAPES)
def test_conv3_mxu_dx_bf16_matches_the_pallas_kernel(shape, out_dtype):
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(cin + cout + d)
    dz = _np(rng, b, d, h, w, cout)
    k = _np(rng, 3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    kadj = jnp.flip(jnp.asarray(k), (0, 1, 2)).swapaxes(3, 4)
    want = jax_conv3mxu.conv3_mxu(jnp.asarray(dz).astype(jdt),
                                  kadj.astype(jdt), interpret=True,
                                  compute_dtype="bf16")
    assert want.dtype == jdt
    tdt = getattr(torch, out_dtype)
    got = K.conv3_mxu_dx_bf16(torch.from_numpy(dz).to(tdt),
                              torch.from_numpy(k).to(tdt), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (b, d, h, w, cin)
    if out_dtype == "float32":
        assert _rel(got.numpy(), _f32(want)) <= 1e-5
    else:
        assert _excess(got.float(), _f32(want)) <= 0.0
    # the kernel's operands are rounded: the result is not the f32 dx
    f32 = conv3mxu.conv3_mxu_dx_ref(torch.from_numpy(dz),
                                    torch.from_numpy(k))
    assert _rel(got.float().numpy(), f32.numpy()) > 1e-4


def test_dx_bf16_weight_preparation_folds_the_flip():
    """The transposed weight layout is the forward layout of flip_swap(k)
    (what the kernel's preparation reads with its flag)."""
    rng = np.random.RandomState(31)
    k = torch.from_numpy(_np(rng, 3, 3, 3, 64, 96)).to(BF16)
    got = conv3mxu.prepare_weights_bf16_ref(k, transposed=True)
    want = conv3mxu.prepare_weights_bf16_ref(conv3mxu.flip_swap(k))
    assert got.shape == (3, 96 // 32, 64 // 64, 9, 2, 2, 8, 8, 8)
    assert torch.equal(got, want)


def test_routes_follow_the_jax_policy(monkeypatch):
    """route / compute_dtype against the JAX package's own functions under
    each ambient precision (their environment overrides unset)."""
    for var in ("HP_CONV3MXU_ROUTE", "HP_CONV3MXU_DT"):
        monkeypatch.delenv(var, raising=False)
    for p in conv3mxu.PRECISIONS:
        with jax.default_matmul_precision(p):
            assert conv3mxu.route(p) == jax_conv3mxu._route_policy(), p
            assert conv3mxu.compute_dtype(p) == \
                jax_conv3mxu.resolve_compute_dtype(), p
    with pytest.raises(ValueError):
        conv3mxu.route("fastest")


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 64, 64), (2, 32, 32, 32, 128), (2, 16, 16, 16, 256),
    (2, 8, 8, 8, 512), (2, 16, 16, 16, 64), (2, 8, 8, 8, 128),
    (2, 4, 4, 4, 256), (2, 2, 2, 2, 512), (1, 4, 8, 12, 64),
    (1, 4, 2, 16, 128), (1, 4, 8, 8, 96)])
def test_router_admits_what_the_jax_router_admits(shape, monkeypatch):
    """t128's conv2 shapes (all but c512 admitted), tiny(32)'s (c256 @4^3
    not: W % 8), and shapes off the rules (W / 2 not a multiple of 8, H <
    3, C_in 96)."""
    monkeypatch.delenv("HP_CONV3MXU_CIN", raising=False)
    monkeypatch.delenv("HP_CONV3MXU_C512", raising=False)
    c = shape[4]
    assert conv3mxu.router_admits(shape, c, c) == \
        jax_conv3mxu.conv3mxu_supported(shape, c, c)


# ---------------------------------------------- the 'bwd' route's VJP

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_conv2_route_vjp_matches_jax(precision, dtype):
    """The port's route at ``precision`` (Conv3MxuBwd at 'default',
    Conv3Mxu at 'highest') against ``jax.vjp(conv3_mxu_bwd_diff)`` traced
    under that precision, whose dx resolves to the kernel at cdt bf16 or
    f32: output, dx and dk."""
    rng = np.random.RandomState(40)
    b, d, h, w, c = 1, 4, 8, 16, 64
    x = _np(rng, b, d, h, w, c)
    k = _np(rng, 3, 3, 3, c, c, scale=(27 * c) ** -0.5)
    g = _np(rng, b, d, h, w, c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.default_matmul_precision(precision):
        y, vjp = jax.vjp(jax_conv3mxu.conv3_mxu_bwd_diff,
                         jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt))
        want = [y, *vjp(jnp.asarray(g).astype(jdt))]
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    kt = torch.from_numpy(k).to(tdt).requires_grad_()
    if conv3mxu.route(precision) == "bwd":
        yt = K.conv3_mxu_bwd_diff(xt, kt)
    else:
        yt = K.conv3_mxu_diff(xt, kt)
    yt.backward(torch.from_numpy(g).to(tdt))
    got = [yt.detach(), xt.grad, kt.grad]
    for name, gv, wv in zip(("y", "dx", "dk"), got, want):
        assert gv.dtype == tdt and wv.dtype == jdt, name
        if dtype == "float32":
            assert _rel(gv.numpy(), _f32(wv)) <= 1e-5, name
        else:
            assert _excess(gv.float(), _f32(wv)) <= 0.0, name
    if precision == "default":
        dx32 = conv3mxu.conv3_mxu_dx_ref(torch.from_numpy(g),
                                         torch.from_numpy(k))
        assert _rel(got[1].float().numpy(), dx32.numpy()) > 1e-4


# -------------------------------------- K1, K3 / K7 and K8 on bf16

@pytest.mark.parametrize("act,pad_mode,residual", [
    ("leaky", "edge", True), ("relu", "zero", False), ("none", "zero", True)])
def test_conv3_planes_function_on_bf16_matches_jax(act, pad_mode, residual):
    """Conv3Planes on a bf16 x and residual (f32 kernel and bias) against
    jax.vjp of the JAX ``conv3_planes_diff`` (Pallas, interpret mode)."""
    rng = np.random.RandomState(50)
    b, cin, cout, d, h, w = 2, 2, 4, 2, 8, 16
    x = _bf16_np(_np(rng, b, cin, d, h, w))
    k = _np(rng, 3, 3, 3, cin, cout, scale=0.3)
    bias = _np(rng, cout, scale=0.1)
    r = _bf16_np(_np(rng, b, cout, d, h, w)) if residual else None
    g = _bf16_np(_np(rng, b, cout, d, h, w))

    def f(x_, k_, b_, r_):
        return jax_k1_diff(x_, k_, b_, r_, act=act, pad_mode=pad_mode,
                           interpret=True)

    args = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(bias),
            None if r is None else jnp.asarray(r, jnp.bfloat16)]
    y, vjp = jax.vjp(f, *args)
    want = [y, *vjp(jnp.asarray(g, jnp.bfloat16))]
    ts = [torch.from_numpy(x).to(BF16).requires_grad_(),
          torch.from_numpy(k).requires_grad_(),
          torch.from_numpy(bias).requires_grad_(),
          None if r is None else torch.from_numpy(r).to(BF16).requires_grad_()]
    yt = K.conv3_planes_diff(*ts, act=act, pad_mode=pad_mode)
    yt.backward(torch.from_numpy(g).to(BF16))
    got = [yt.detach()] + [None if t is None else t.grad for t in ts]
    for name, gv, wv in zip(("y", "dx", "dk", "db", "dres"), got, want):
        if wv is None:
            assert gv is None
            continue
        assert gv.dtype == (BF16 if wv.dtype == jnp.bfloat16
                            else torch.float32), name
        if gv.dtype == BF16:
            assert _excess(gv.float(), _f32(wv)) <= 0.0, name
        else:
            assert _rel(gv.numpy(), _f32(wv)) <= 1e-5, name


def _post_relu_bf16(rng, shape):
    return _bf16_np(np.maximum(np.round(rng.randn(*shape), 1), 0.0)
                    .astype(np.float32))


def test_stem_pool_function_on_bf16_matches_jax():
    """MaxPoolK3S2P1 on a bf16 stem output (post-ReLU, many ties) against
    the JAX ``phase_maxpool_diff`` pair (Pallas forward and VJP in
    interpret mode, the VJP in f32 then cast to bf16): exact."""
    rng = np.random.RandomState(51)
    y = _post_relu_bf16(rng, (1, 8, 16, 16, 16))
    g = _bf16_np(_np(rng, 1, 4, 8, 8, 16))
    y2 = space_to_depth_3d(jnp.asarray(y, jnp.bfloat16))
    out, vjp = jax.vjp(phase_maxpool_diff, y2)
    (dy2,) = vjp(jnp.asarray(g, jnp.bfloat16))
    yt = torch.from_numpy(y).to(BF16).requires_grad_()
    ot = K.maxpool3d_k3s2p1_diff(yt)
    ot.backward(torch.from_numpy(g).to(BF16))
    assert ot.dtype == BF16 and yt.grad.dtype == BF16
    np.testing.assert_array_equal(ot.detach().float().numpy(), _f32(out))
    np.testing.assert_array_equal(yt.grad.float().numpy(),
                                  _f32(depth_to_space_3d(dy2)))
    assert float(yt.grad.abs().sum()) > 0


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_unet_pool_function_on_bf16_matches_jax(kind):
    """MaxPool2 on a bf16 volume against the JAX K8 (interpret mode, f32
    inside, x's type out) and the custom VJP of ``max_pool2_planes``:
    exact, first maximum."""
    rng = np.random.RandomState(52)
    shape = (2, 3, 4, 16, 16)
    x = (_bf16_np(_np(rng, *shape)) if kind == "random"
         else rng.randint(0, 3, size=shape).astype(np.float32))
    dy = _bf16_np(_np(rng, 2, 3, 2, 8, 8))
    xj, dyj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    pallas = pool2_bwd_planes_pallas(xj, dyj, interpret=True)
    autodiff = jax.vjp(max_pool2_planes, xj)[1](dyj)[0]
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    K.max_pool2_diff(xt).backward(torch.from_numpy(dy).to(BF16))
    assert xt.grad.dtype == BF16 and pallas.dtype == jnp.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(), _f32(pallas))
    np.testing.assert_array_equal(xt.grad.float().numpy(), _f32(autodiff))


def test_stem_conv_vjp_on_bf16():
    """The train-mode stem conv on bf16 x and weight (the bf16 model's):
    its backward's products of the widened operands are exact and its sums
    f32, rounded once, so dx and dk lie within one bf16 ulp (plus 2^-16 of
    the max) of the float64 VJP of the same bf16 values (read: 0 excess)."""
    import torch.nn.functional as F

    from hiddenpose_tpu_torch.ops.stem_vjp import stem_conv_diff

    rng = np.random.RandomState(53)
    x = _bf16_np(rng.rand(2, 1, 8, 9, 10).astype(np.float32))
    w = _bf16_np(_np(rng, 16, 1, 7, 7, 7, scale=343 ** -0.5))
    dy = _bf16_np(_np(rng, 2, 16, 8, 9, 10))
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    wt = torch.from_numpy(w).to(BF16).requires_grad_()
    y = stem_conv_diff(xt, wt)
    assert y.dtype == BF16
    y.backward(torch.from_numpy(dy).to(BF16))
    x64 = torch.from_numpy(x).double().requires_grad_()
    w64 = torch.from_numpy(w).double().requires_grad_()
    F.conv3d(x64, w64, padding=3).backward(torch.from_numpy(dy).double())
    for got, want in ((xt.grad, x64.grad), (wt.grad, w64.grad)):
        assert got.dtype == BF16
        assert _excess(got.float(), want.float()) <= 0.0


# ----------------------------- the bf16 model's modules in training
# Each against ``jax.vjp`` of the JAX module on the same weights (tiny(32)'s
# ``_jax_tree``) and inputs, the JAX package's Pallas routes on (its gates
# as on its own hardware; Pallas in interpret mode), with a loss
# sum(y * r) of a fixed random r.  ``ref`` is the JAX bf16 module's
# distance from its f32 run, ``got`` the port's bf16 from the JAX bf16,
# ``own`` the port's bf16 from its f32: relative L2 of each output, input
# gradient and parameter gradient (``_module_distances``).


@pytest.fixture
def pallas_on(monkeypatch):
    """The JAX package's Pallas gates as on its own hardware: K1 in the
    FeatureExtraction and UNet, the stem pool pair, the conv2 router."""
    import hiddenpose_tpu.models.blocks as jax_blocks
    import hiddenpose_tpu.models.unet3d as jax_unet
    import hiddenpose_tpu.ops.pallas.conv3p as jax_conv3p

    for mod in (jax_blocks, jax_unet, jax_conv3p):
        monkeypatch.setattr(mod, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jax_conv3mxu, "conv3mxu_enabled", lambda: True)
    for var in ("HP_CONV3MXU_ROUTE", "HP_CONV3MXU_DT", "HP_CONV3MXU_CIN",
                "HP_CONV3MXU_C512", "HP_POOL2P"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def port_models():
    """The port's tiny(32) NlosPose in f32 and bf16 on ``_jax_tree``'s
    weights, in training mode, and its LCT constants."""
    out = {}
    for bf16 in (False, True):
        cfg = PortConfig().tiny(SIZE)
        cfg = cfg.with_bf16() if bf16 else cfg
        model, lct = build_nlospose(cfg.model, device="cpu")
        model.load_state_dict(state_dict_from_jax(_jax_tree()))
        out[bf16] = model.train()
    out["lct"] = lct
    return out


def _exact_jit(f, *args):
    """``jax.jit(f)(*args)``, compiled without XLA's excess precision, so
    that every bf16 rounding the JAX program writes takes place (by
    default the CPU compiler may drop a rounding between two casts: read,
    32% of a bf16 DoubleConv's outputs moved by it)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _module_vjp_jax(apply, params, x, r):
    """y, dx and d(params) of sum(y * r) for ``apply(params, x) -> (y,
    new batch_stats or None)``, numpy f32 ('s...' the statistics)."""
    def loss(p, v):
        y, stats = apply(p, v)
        return jnp.sum(y.astype(jnp.float32) * r), (y, stats)
    (_, (y, stats)), (gp, gx) = _exact_jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), params, x)
    return {"y": _f32(y), "dx": _f32(gx),
            **{f"d{k}": v for k, v in _flat(gp).items()},
            **{f"s{k}": v for k, v in _flat(stats or {}).items()}}


def _module_vjp_port(model, module, x, r, path=()):
    """The same of a port module of ``model`` (its weights and statistics
    loaded anew from ``_jax_tree``), as the JAX subtree at ``path``."""
    model.load_state_dict(state_dict_from_jax(_jax_tree()))
    model.zero_grad(set_to_none=True)
    x.requires_grad_()
    y = module(x)
    (y.float() * torch.from_numpy(r)).sum().backward()
    out = {"y": y.detach().float().numpy(), "dx": x.grad.float().numpy()}
    if path:
        tree = to_jax({n: (p.grad if p.grad is not None
                           else torch.zeros_like(p))
                       for n, p in model.named_parameters()})
        stats = convert_state_dict({k: v.numpy() for k, v in
                                    model.state_dict().items()},
                                   strict=True)["batch_stats"]
        for key in path:
            tree, stats = tree[key], stats.get(key, {})
        out.update({f"d{k}": v for k, v in _flat(tree).items()})
        out.update({f"s{k}": v for k, v in _flat(stats).items()})
    model.zero_grad(set_to_none=True)
    return out


def _module_distances(a, b):
    return {k: np.linalg.norm((a[k] - b[k]).astype(np.float64))
            / max(np.linalg.norm(b[k].astype(np.float64)), 1e-30)
            for k in b}


def _unet_part(part, port_models):
    """(JAX apply(dtype) -> f(params, x), its params, port module(bf16),
    JAX path of its parameters, x's shape, whether x takes the model's
    type (else float32))."""
    from hiddenpose_tpu.models.unet3d import (
        DoubleConv as JaxDoubleConv,
        GroupNormP as JaxGroupNormP,
        OutConv1x1 as JaxOutConv,
        resize_trilinear_planes,
    )
    from hiddenpose_tpu.ops.lct import lct_apply as jax_lct_apply
    from hiddenpose_tpu_torch.models.unet3d import upsample2
    from hiddenpose_tpu_torch.ops.lct import lct_apply as port_lct_apply

    ae = _jax_tree()["params"]["autoencoder"]
    if part == "double_conv_kernel":   # the UNet's top level: K1 admitted
        return (lambda dt: lambda p, v: (JaxDoubleConv(4, dtype=dt).apply(
                    {"params": p}, v, True), None),
                ae["conv"], lambda m: m.autoencoder.conv,
                ("autoencoder", "conv"), (2, 1, 4, 8, 32), False)
    if part == "double_conv_library":  # enc1 at 16^3: the gate refuses
        return (lambda dt: lambda p, v: (JaxDoubleConv(8, dtype=dt).apply(
                    {"params": p}, v, True), None),
                ae["enc1"], lambda m: m.autoencoder.enc1.encoder[1],
                ("autoencoder", "enc1"), (2, 4, 16, 16, 16), True)
    if part == "group_norm":
        return (lambda dt: lambda p, v: (JaxGroupNormP(4).apply(
                    {"params": p}, v), None),
                ae["conv"]["gn1"],
                lambda m: m.autoencoder.conv.double_conv[1],
                ("autoencoder", "conv", "gn1"), (2, 4, 32, 32, 32), True)
    if part == "out_conv":
        return (lambda dt: lambda p, v: (JaxOutConv(1, dtype=dt).apply(
                    {"params": p}, v), None),
                ae["out"], lambda m: m.autoencoder.out,
                ("autoencoder", "out"), (2, 4, 32, 32, 32), True)
    if part == "upsample":
        return (lambda dt: lambda p, v: (resize_trilinear_planes(
                    v, tuple(2 * n for n in v.shape[2:])), None),
                {}, lambda m: upsample2, (), (2, 8, 8, 8, 8), True)
    if part == "feature_extraction":
        from hiddenpose_tpu.models.blocks import FeatureExtraction as JaxFE
        return (lambda dt: _channels_last(lambda p, v: (JaxFE(
                    basedim=1, stride=1, dtype=dt).apply({"params": p}, v,
                                                         True), None)),
                _jax_tree()["params"]["feature_extraction"],
                lambda m: m.feature_extraction, ("feature_extraction",),
                (2, 1, 8, 8, 32), False)
    assert part == "lct"
    _, jlct = jax_build(Config().tiny(SIZE).model)
    lct = port_models["lct"]
    return (lambda dt: lambda p, v: (jax_lct_apply(v, jlct), None), {},
            lambda m: lambda v: port_lct_apply(v, lct), (),
            (2, SIZE, SIZE, SIZE), True)


UNET_PARTS = ("feature_extraction", "double_conv_kernel",
              "double_conv_library", "group_norm", "out_conv", "upsample",
              "lct")


def _module_readings(jax_fn, params, get, path, x, r, follows, port_models,
                     precision="highest"):
    """ref, got and own (see above) of one module: ``jax_fn(dtype)`` its
    JAX apply, ``get(model)`` the port's; x takes the model's type when
    ``follows`` (else float32); both traced / run at ``precision``."""
    runs = {}
    for name, bf16 in (("jax32", False), ("jax16", True)):
        xin = jnp.asarray(x).astype(jnp.bfloat16 if bf16 and follows
                                    else jnp.float32)
        with jax.default_matmul_precision(precision):
            runs[name] = _module_vjp_jax(
                jax_fn(jnp.bfloat16 if bf16 else jnp.float32), params, xin,
                r)
    for name, bf16 in (("port32", False), ("port16", True)):
        model = port_models[bf16]
        xin = torch.from_numpy(x).to(BF16 if bf16 and follows
                                     else torch.float32)
        with conv3mxu.matmul_precision(precision):
            runs[name] = _module_vjp_port(model, get(model), xin, r, path)
    return (_module_distances(runs["jax16"], runs["jax32"]),
            _module_distances(runs["port16"], runs["jax16"]),
            _module_distances(runs["port16"], runs["port32"]))


def _channels_last(apply):
    """A JAX module's apply on NDHWC, called on and returning NCDHW."""
    def f(p, v):
        y, stats = apply(p, jnp.transpose(v, (0, 2, 3, 4, 1)))
        return jnp.transpose(y, (0, 4, 1, 2, 3)), stats
    return f


# the largest port-vs-JAX distance each part may read, as a share of the
# JAX module's bf16-vs-f32 distance (readings: FeatureExtraction 1.5e-4,
# DoubleConv on the kernel route 1.3e-3, on the library route 8e-3,
# GroupNormP 0.029, OutConv 0, upsample 0, LCT 4e-3)
PART_LIMITS = {"feature_extraction": 0.01, "double_conv_kernel": 0.02,
               "double_conv_library": 0.05, "group_norm": 0.1,
               "out_conv": 0.01, "upsample": 0.01, "lct": 0.02}


def _hold(ref, got, own, limit, skip=()):
    """Every reading ``got`` within ``limit`` of ``ref``, and the port's
    bf16 at least half of ``ref`` from its own f32 (an f32 path posing as
    bf16 fails), but where ``ref`` exceeds 1: a near-cancelling gradient
    (a conv bias right before a norm) whose relative distance says
    nothing."""
    for k in ref:
        if k in skip:
            continue
        assert np.isfinite(got[k]) and got[k] <= limit * ref[k], \
            (k, got[k], ref[k])
        if ref[k] <= 1.0:
            assert own[k] >= 0.5 * ref[k], (k, own[k], ref[k])


@pytest.mark.parametrize("part", UNET_PARTS)
def test_bf16_unet_part_backward_matches_jax(part, port_models, pallas_on):
    """One module of the bf16 model's front half in training (the
    FeatureExtraction, a DoubleConv on each route of the JAX gate,
    GroupNormP, OutConv, the rounded trilinear x2, the LCT on a bf16
    input) against the JAX module, within ``PART_LIMITS``.  OutConv's bias
    gradient is held against float64 instead: the sum of the rounded
    cotangent in f32, rounded once (one bf16 ulp); the JAX package's CPU
    reduction of a bf16 cotangent accumulates in bf16 (read: 16% from its
    own f32 value, the port's 2%)."""
    jax_fn, params, get, path, shape, follows = _unet_part(part, port_models)
    rng = np.random.RandomState(60)
    x = rng.rand(*shape).astype(np.float32)
    r = _np(rng, *_module_out_shape(part, shape))
    ref, got, own = _module_readings(jax_fn, params, get, path, x, r,
                                     follows, port_models)
    bias = "d['bias']"
    _hold(ref, got, own, PART_LIMITS[part],
          skip=(bias,) if part == "out_conv" else ())
    if part == "out_conv":
        model = port_models[True]
        db = _module_vjp_port(model, get(model),
                              torch.from_numpy(x).to(BF16), r, path)[bias]
        want = np.sum(_bf16_np(r), dtype=np.float64)
        assert _excess(db, [want]) <= 0.0, (db, want)


def _module_out_shape(part, shape):
    b = shape[0]
    return {"double_conv_kernel": (b, 4, *shape[2:]),
            "double_conv_library": (b, 8, *shape[2:]),
            "out_conv": (b, 1, *shape[2:]),
            "upsample": (*shape[:2], *(2 * n for n in shape[2:]))}.get(
                part, shape)


def test_bf16_bottleneck_train_matches_jax(port_models, pallas_on):
    """layer1's second block (c64 at 16^3, its conv2 on the 'bwd' route:
    the library's forward, K4-dx-bf16) in training at 'default' against
    the JAX block: output, input and parameter gradients, new statistics,
    within half the JAX block's bf16-vs-f32 distance (read: at most 0.28
    of it, conv1's kernel gradient)."""
    from hiddenpose_tpu.models.posenet3d import Bottleneck as JaxBottleneck

    tree = _jax_tree()
    stats = tree["batch_stats"]["pose_net"]["layer1_1"]

    def jax_fn(dt):
        def f(p, v):
            y, new = JaxBottleneck(planes=64, train=True, dtype=dt).apply(
                {"params": p, "batch_stats": stats}, v,
                mutable=["batch_stats"])
            return y, new["batch_stats"]
        return _channels_last(f)

    rng = np.random.RandomState(61)
    x = rng.rand(2, 256, 16, 16, 16).astype(np.float32)
    r = _np(rng, 2, 256, 16, 16, 16)
    ref, got, own = _module_readings(
        jax_fn, tree["params"]["pose_net"]["layer1_1"],
        lambda m: m.pose_net.layer1[1], ("pose_net", "layer1_1"), x, r,
        False, port_models, precision="default")
    _hold(ref, got, own, 0.5)


def test_bf16_train_stem_and_pool_match_jax(port_models, pallas_on):
    """The train-mode stem (the 7^3 conv on bf16 operands with its
    matrix-product VJP, bn1 on the f32 widening, the ReLU rounded to bf16)
    and its pool (K3-bf16 forward, K7 on widened values) against the JAX
    ``StemS2D`` with its Pallas pool pair, within 0.15 of the JAX stem's
    bf16-vs-f32 distance (read: at most 0.064 of it, the kernel's
    gradient; the JAX package's XLA pool chain splits ties otherwise)."""
    from hiddenpose_tpu.models.posenet3d import StemS2D

    tree = _jax_tree()
    stats = tree["batch_stats"]["pose_net"]["conv1"]

    def jax_fn(dt):
        def f(p, v):
            y, new = StemS2D(features=64, train=True, dtype=dt).apply(
                {"params": p, "batch_stats": stats}, v,
                mutable=["batch_stats"])
            return y, new["batch_stats"]
        return _channels_last(f)

    rng = np.random.RandomState(62)
    x = (rng.rand(2, 1, SIZE, SIZE, SIZE) * 10).astype(np.float32)
    r = _np(rng, 2, 64, SIZE // 2, SIZE // 2, SIZE // 2)
    ref, got, own = _module_readings(
        jax_fn, tree["params"]["pose_net"]["conv1"],
        lambda m: m.pose_net.stem, ("pose_net", "conv1"), x, r, False,
        port_models)
    _hold(ref, got, own, 0.15)


# -------------------------------------------------- whole steps, tiny(32)

def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_tree():
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(Config().tiny(SIZE).model)
    sd = peaked_state_dict(template, 1)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)
