"""The port's bfloat16 serving path (``Config.with_bf16()``, the default of
both servers) against the JAX package's, on the CPU.

(a) Every stage boundary has the JAX model's dtype: the convolutions'
    outputs bf16, flax's ``nn.BatchNorm`` (built without a dtype) float32
    for a bf16 input, the LCT and normalisation float32, the heatmaps bf16.
(b) Each bf16 kernel's plain version against the JAX package's Pallas
    kernel in interpret mode on the same bf16 operands: within one bf16
    ulp of each output (plus 2^-16 of the largest output for sums that
    cancel near zero), K3 exact.  The JAX kernels' arithmetic is the port
    kernels' contract: bf16 operands widened exactly, f32 sums (K1: f32
    weights), the epilogue in f32, one rounding.
(c) The whole bf16 forward against the JAX package's.  Two bf16
    implementations agree bit for bit only where they round at the same
    places, and the JAX package's CPU path does not round where its TPU
    kernels (whose contract the port follows) do: its StencilConv3
    fallback rounds the weights to bf16 and the conv result before the
    bias and residual (``hiddenpose_tpu/models/blocks.py:221-228``), its
    stem and its Bottleneck conv2 round the raw conv before the BN affine.
    Each rounding is then noise of the bf16 size, independent on the two
    sides, so the port and the JAX package's bf16 forward sit about sqrt(2)
    times as far apart as either sits from float32 (measured at tiny(16):
    heatmap RMS 1.0e-2 against 9.2e-3, also with the JAX model's Pallas
    routes forced where its gates allow).  So the whole forward is held
    to 2.5 times the JAX package's own bf16-vs-f32 difference, and must sit
    at least a quarter of that difference away from the f32 forward (an
    f32 path posing as bf16 sits 1e-6 away and fails).  Where the
    rounding points are the same, a module is held a factor below the
    bf16-vs-f32 difference: FeatureExtraction against the JAX module on
    its Pallas route (K1 in interpret mode) and a Bottleneck against the
    JAX block on its fused route (K4 in interpret mode), at most a tenth
    of the JAX module's bf16-vs-f32 RMS (measured: a twentieth and a
    thirtieth).
(d) ``InferenceServer()`` defaults to bf16, casts requests to bf16 on the
    host and answers as the JAX ``InferenceServer()`` does, within (c)'s
    tolerance.

Weights: the port's peaked random weights (``utils/peaked.py``) through
the JAX package's importer and back (``utils/jax_bridge.py``), as in
``tests/test_torch_nlospose.py``.  The JAX forwards compile once, in a
module fixture.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hiddenpose_tpu.config import Config as JaxConfig
from hiddenpose_tpu.models.blocks import FeatureExtraction as JaxFE
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.models.posenet3d import Bottleneck as JaxBottleneck
from hiddenpose_tpu.ops.pallas.conv3mxu import conv3_mxu as jax_conv3_mxu
from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes as jax_conv3_planes
from hiddenpose_tpu.ops.pallas.phase_pool import phase_maxpool_pallas
from hiddenpose_tpu.ops.pallas.stem_conv import stem_conv_raw_pallas
from hiddenpose_tpu.ops.softargmax import softmax_integral as jax_joints
from hiddenpose_tpu.ops.space_to_depth import (
    depth_to_space_3d,
    make_s2d_kernel,
    space_to_depth_3d,
)
from hiddenpose_tpu.serve import InferenceServer as JaxServer
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.config import Config, t128_config
from hiddenpose_tpu_torch.models import nlospose as port_nlospose
from hiddenpose_tpu_torch.models.blocks import FeatureExtraction
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.models.posenet3d import Bottleneck
from hiddenpose_tpu_torch.ops import kernels as K
from hiddenpose_tpu_torch.ops.kernels import conv3mxu, conv3p, stem_conv
from hiddenpose_tpu_torch.serve import InferenceServer
from hiddenpose_tpu_torch.train.step import make_forward, make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

SIZE = 16
BF16 = jnp.bfloat16
# (b): one bf16 ulp of each output, plus this much of the largest output
ATOL = 2.0 ** -16
# (c), (d): against the JAX bf16 forward, at most WHOLE x the JAX package's
# own bf16-vs-f32 difference; from the f32 forward, at least AWAY x it
WHOLE, AWAY = 2.5, 0.25
# modules with the same rounding points: at most MATCHED x the JAX
# module's bf16-vs-f32 RMS
MATCHED = 0.1


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _bf16_values(a):
    """numpy f32 array (writable) of the bf16 values nearest ``a``."""
    return np.array(jnp.asarray(a, BF16).astype(jnp.float32))


def _jax_tree(size, seed=1):
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(Config().tiny(size).model)
    sd = peaked_state_dict(template, seed)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


def _port(cfg, tree):
    model, lct = build_nlospose(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model, lct


@pytest.fixture(scope="module")
def run():
    """The JAX f32 and bf16 forwards (the bf16 one with every module's
    output captured) and the port's bf16 forward with hooks at the stage
    boundaries, on the same weights and captures."""
    tree = _jax_tree(SIZE)
    meas = _bf16_values(np.random.RandomState(7).rand(
        2, 1, SIZE, SIZE, SIZE).astype(np.float32))
    out = {}
    for name, cfg in (("f32", JaxConfig().tiny(SIZE)),
                      ("bf16", JaxConfig().tiny(SIZE).with_bf16())):
        jm, jl = jax_build(cfg.model)

        def fwd(v, m, jm=jm, jl=jl):
            return jm.apply(v, m, jl, train=False)[0]

        def captured(v, m, jm=jm, jl=jl):
            return jm.apply(v, m, jl, train=False,
                            capture_intermediates=True,
                            mutable=["intermediates"])[1]["intermediates"]

        hm = jax.jit(fwd)(tree, jnp.asarray(meas))
        # the dtypes of every module's output, traced without a compile
        shapes = jax.eval_shape(captured, tree, jnp.asarray(meas))
        out[name] = dict(hm=np.asarray(hm.astype(jnp.float32)),
                         hm_dtype=hm.dtype.name,
                         joints=np.asarray(jax_joints(hm, 24)),
                         intermediates=jax.tree_util.tree_map(
                             lambda a: a.dtype.name, shapes))

    model, lct = _port(Config().tiny(SIZE).with_bf16(), tree)
    seen = {}
    pn = model.pose_net

    def keep(name):
        return lambda m, i, o: seen.__setitem__(name, o.dtype)

    def keep_in(name):
        return lambda m, i: seen.__setitem__(name, i[0].dtype)

    hooks = [
        model.feature_extraction.register_forward_pre_hook(keep_in("fe_in")),
        model.feature_extraction.register_forward_hook(keep("fe")),
        model.autoencoder.register_forward_pre_hook(keep_in("unet_in")),
        model.autoencoder.conv.double_conv[1].register_forward_hook(
            keep("unet_gn")),
        model.autoencoder.register_forward_hook(keep("unet")),
        pn.register_forward_pre_hook(keep_in("posenet_in")),
        pn.layer1.register_forward_pre_hook(keep_in("stem")),
        pn.layer1[0].bn1.register_forward_hook(keep("bn1")),
        pn.layer1[0].bn3.register_forward_hook(keep("bn3")),
        pn.layer2[0].downsample[1].register_forward_hook(keep("bn_proj")),
        pn.layer1.register_forward_hook(keep("layer1")),
        pn.layer4.register_forward_hook(keep("layer4")),
        pn.head.features[1].register_forward_hook(keep("head_bn")),
    ]
    lct_apply = port_nlospose.lct_apply

    def spy(x, *a, **kw):
        seen["lct_in"] = x.dtype
        y = lct_apply(x, *a, **kw)
        seen["lct_out"] = y.dtype
        return y

    port_nlospose.lct_apply = spy
    try:
        joints, hm = make_forward(model)(torch.from_numpy(meas), lct)
    finally:
        port_nlospose.lct_apply = lct_apply
        for h in hooks:
            h.remove()
    return dict(jax=out, hm=hm, joints=joints.numpy(), seen=seen, tree=tree,
                meas=meas)


# ---------------------------------------------------------------- (a)

def _jax_dtype(it, *path):
    node = it
    for p in path:
        node = node[p]
    return node["__call__"][0]


# (port boundary, path of the JAX module whose output it is, dtype name)
BOUNDARIES = [
    ("fe", ("feature_extraction",), "bfloat16"),
    ("unet_gn", ("autoencoder", "conv", "gn1"), "bfloat16"),
    ("unet", ("autoencoder",), "bfloat16"),
    ("stem", ("pose_net", "conv1"), "bfloat16"),
    ("bn1", ("pose_net", "layer1_0", "bn1"), "float32"),
    ("bn3", ("pose_net", "layer1_0", "bn3"), "float32"),
    ("bn_proj", ("pose_net", "layer2_0", "bn_proj"), "float32"),
    ("layer1", ("pose_net", "layer1_2"), "float32"),
    ("layer4", ("pose_net", "layer4_2"), "float32"),
    ("head_bn", ("pose_net", "head", "bn1"), "float32"),
]


@pytest.mark.parametrize("name,path,want", BOUNDARIES,
                         ids=[b[0] for b in BOUNDARIES])
def test_stage_dtype_is_the_jax_models(run, name, path, want):
    """A BN that returned bf16 where flax returns f32 (torch's
    ``BatchNorm3d`` on a bf16 input does) or an f32 conv fails here."""
    got = str(run["seen"][name]).replace("torch.", "")
    assert _jax_dtype(run["jax"]["bf16"]["intermediates"], *path) == want
    assert got == want


def test_lct_and_heatmap_dtypes(run):
    """The LCT takes the bf16 FeatureExtraction output and computes in
    f32, normalize stays f32, feature + refine promotes to f32, and the
    heatmaps come out bf16 (the soft-argmax widens them)."""
    seen = run["seen"]
    assert seen["fe_in"] == torch.float32  # meas; FE rounds it
    assert seen["lct_in"] == torch.bfloat16
    assert seen["lct_out"] == torch.float32
    assert seen["unet_in"] == torch.float32
    assert seen["posenet_in"] == torch.float32
    assert run["hm"].dtype == torch.bfloat16
    assert run["jax"]["bf16"]["hm_dtype"] == "bfloat16"


# ---------------------------------------------------------------- (b)

def _one_ulp(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(np.array(want))
    atol = ATOL * want.float().abs().max().item()
    assert K.bf16_ulp_excess(got, want, atol) <= 0.0


def _rb(rng, shape, scale=1.0):
    return _bf16_values(rng.randn(*shape) * scale)


K4_SHAPES = [(1, 4, 8, 16, 64, 64), (2, 2, 4, 8, 128, 64),
             (1, 2, 8, 32, 64, 128), (1, 3, 4, 16, 256, 64)]


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_bf16_plain_matches_jax(shape, epilogue):
    """``conv3_mxu`` at its default ``compute_dtype='bf16'`` on bf16
    operands: one pass, f32 sums, f32 epilogue, bf16 out."""
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(1)
    x = _rb(rng, (b, d, h, w, cin))
    k = _rb(rng, (3, 3, 3, cin, cout), (27 * cin) ** -0.5)
    sc = (rng.rand(cout) + 0.5).astype(np.float32) if epilogue else None
    sh = (rng.randn(cout) * 0.1).astype(np.float32) if epilogue else None
    want = jax_conv3_mxu(
        jnp.asarray(x, BF16), jnp.asarray(k, BF16),
        None if sc is None else jnp.asarray(sc),
        None if sh is None else jnp.asarray(sh), relu=epilogue,
        interpret=True, compute_dtype="bf16")
    assert want.dtype == BF16
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = K.conv3_mxu_bf16(t(x).bfloat16(), t(k).bfloat16(), t(sc), t(sh),
                           relu=epilogue)
    _one_ulp(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("relu", [True, False])
def test_k2_bf16_plain_matches_jax(relu):
    """``stem_conv_raw_pallas`` on the bf16 volume and s2d kernel the JAX
    model feeds it: exact products, f32 sums and affine, bf16 out."""
    rng = np.random.RandomState(2)
    x = _bf16_values(rng.rand(1, 16, 16, 16, 1))
    k = _rb(rng, (7, 7, 7, 1, 64), 0.05)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    shift = (rng.randn(64) * 0.1).astype(np.float32)
    want = stem_conv_raw_pallas(
        jnp.asarray(x, BF16), make_s2d_kernel(jnp.asarray(k, BF16)),
        jnp.tile(jnp.asarray(scale), 8), jnp.tile(jnp.asarray(shift), 8),
        relu=relu)
    assert want.dtype == BF16
    want = np.asarray(depth_to_space_3d(want).astype(jnp.float32))
    got = K.stem_conv_raw_bf16(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(shift), relu=relu)
    _one_ulp(got, want)


@pytest.mark.parametrize("shape,relu", [((1, 16, 16, 16), True),
                                        ((1, 16, 16, 16), False),
                                        ((1, 8, 24, 18), True)])
def test_k2_bf16_tiled_ref_matches_jax(shape, relu):
    """The bf16 kernel's bookkeeping (``stem_conv_bf16_tiled_ref``: its
    expanded plane slots, the mirrored ring, both operands read through
    their descriptors, the two f32 partials a plane) against
    ``stem_conv_raw_pallas`` on the same bf16 operands, within one bf16
    ulp; the (8, 24, 18) volume leaves the 16 x 16 block tiles ragged in H
    and W (the JAX kernel takes D and H in multiples of 8)."""
    rng = np.random.RandomState(4)
    x = _bf16_values(rng.rand(*shape, 1))
    k = _rb(rng, (7, 7, 7, 1, 64), 343 ** -0.5)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    shift = (rng.randn(64) * 0.1).astype(np.float32)
    want = stem_conv_raw_pallas(
        jnp.asarray(x, BF16), make_s2d_kernel(jnp.asarray(k, BF16)),
        jnp.tile(jnp.asarray(scale), 8), jnp.tile(jnp.asarray(shift), 8),
        relu=relu)
    want = np.asarray(depth_to_space_3d(want).astype(jnp.float32))
    got = stem_conv.stem_conv_bf16_tiled_ref(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(shift), relu=relu)
    assert got.dtype == torch.bfloat16
    _one_ulp(got, want)


def test_k2_bf16_weight_layout():
    """Read through the MMA's A descriptor offsets, every tap of the 7^3
    kernel sits in the prepared weights exactly once, at the k-step, half
    and kw that its (kd, kh) row and kw say, and every padded slot (row 49,
    kw 7) is zero."""
    k = torch.arange(1, 343 * 64 + 1, dtype=torch.float64).reshape(
        7, 7, 7, 1, 64)
    a = stem_conv.operand_a_bf16(stem_conv.prepare_weights_bf16_ref(k))
    assert a.shape == (25, 64, 16)
    j = torch.arange(25).view(25, 1, 1)
    c = torch.arange(64).view(1, 64, 1)
    kk = torch.arange(16).view(1, 1, 16)
    row, kw = (2 * j + kk // 8).expand_as(a), (kk % 8).expand_as(a)
    real = (row < 49) & (kw < 7)
    want = k.reshape(49, 7, 64)[row.clamp(max=48), kw.clamp(max=6),
                                c.expand_as(a)]
    assert torch.equal(a[real], want[real])
    assert (a[~real] == 0).all()
    assert torch.equal(a[real].sort().values, k.flatten())


@pytest.mark.parametrize("shape", [(1, 3, 20, 18), (2, 2, 7, 5)])
def test_k2_bf16_b_operand(shape):
    """Each k slot of each warpgroup's B, read through the descriptor
    offsets from the seven plane slots of an output plane, is the input
    voxel that the slot's tap reads for the column's voxel (zero outside
    the volume): the expanded rows, the straddling k-steps' LBO and the
    warpgroups' row offsets together."""
    b, d, h, w = shape
    x = torch.arange(1, b * d * h * w + 1, dtype=torch.float64).reshape(
        b, d, h, w, 1)
    e = stem_conv.expanded_planes_bf16(x)
    th, tw = e.shape[2], e.shape[3]
    e = e.reshape(b, d + 6, th, tw, -1)
    ring = torch.stack([e[:, kd:kd + d] for kd in range(7)], 4).flatten(4)
    got = ring[..., stem_conv.b_offsets_stem_bf16()]
    # (b, d, th, tw, wg, j, k, n): the padded input index is the input's + 3
    xp = F.pad(x[..., 0], (3, 16 * tw + 3 - w, 3, 16 * th + 3 - h, 3, 3))
    v = lambda n, at: torch.arange(n).view(*([1] * at), n, *([1] * (7 - at)))
    ib, iz, it, iu = v(b, 0), v(d, 1), v(th, 2), v(tw, 3)
    wg, j, kk, n = v(2, 4), v(25, 5), v(16, 6), v(128, 7)
    row, kw = 2 * j + kk // 8, kk % 8
    kd, kh = row // 7, row % 7
    real = ((row < 49) & (kw < 7)).expand_as(got)
    want = xp[ib, iz + kd.clamp(max=6),
              16 * it + 8 * wg + n // 16 + kh,
              16 * iu + n % 16 + kw.clamp(max=6)]
    assert torch.equal(got[real], want.expand_as(got)[real])


@pytest.mark.parametrize("cin,cout,act,residual,pad_mode", [
    (1, 1, "leaky", True, "edge"),    # FeatureExtraction
    (1, 1, "none", True, "zero"),     # its corner branch
    (4, 8, "none", False, "zero"),    # the UNet
    (8, 4, "relu", False, "edge"),
])
def test_k1_bf16_plain_matches_jax(cin, cout, act, residual, pad_mode):
    """``conv3_planes`` on a bf16 volume (and bf16 residual) with f32
    weights and bias: f32 sums, bf16 out (its docstring: the result in
    x's type)."""
    rng = np.random.RandomState(3)
    b, d, h, w = 2, 3, 8, 32
    x = _rb(rng, (b, cin, d, h, w))
    k = (rng.randn(3, 3, 3, cin, cout) * (27 * cin) ** -0.5).astype(
        np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    res = _rb(rng, (b, cout, d, h, w)) if residual else None
    want = jax_conv3_planes(
        jnp.asarray(x, BF16), jnp.asarray(k), jnp.asarray(bias),
        None if res is None else jnp.asarray(res, BF16), act=act,
        pad_mode=pad_mode, interpret=True)
    assert want.dtype == BF16
    got = K.conv3_planes_bf16(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
        torch.from_numpy(bias),
        None if res is None else torch.from_numpy(res).bfloat16(),
        act=act, pad_mode=pad_mode)
    _one_ulp(got, np.asarray(want.astype(jnp.float32)))


# K4-bf16's bookkeeping (``conv3mxu.conv3_mxu_bf16_tiled_ref``): each
# block's 256-voxel tile of one plane, the halo of each stage's input plane
# staged once, the nine taps' A rows gathered from it, the weights in
# stage order, one f32 partial a stage.  One case per tile the wrapper
# picks (``bf16_tile``): 8 x 32 (twice, ragged in H and W), 16 x 16 (the
# c256 @16^3 plan, two n-blocks), 32 x 8 (twice: C_in 32, one stage a
# plane, with a ragged W, and C_in 128).  The JAX kernel takes C_in 64
# (W / 2 % 8 == 0) or a multiple of 128 (W % 8 == 0), so the C_in 32 case
# is held to the plain conv alone.
K4_TILED = [((1, 3, 5, 40, 128, 64), True), ((1, 2, 9, 32, 64, 64), True),
            ((1, 3, 5, 7, 32, 64), False), ((1, 2, 16, 16, 256, 128), True),
            ((1, 3, 5, 8, 128, 128), True), ((1, 2, 6, 32, 64, 128), True)]


@pytest.mark.parametrize("shape,jax_takes", K4_TILED)
def test_k4_bf16_tiled_ref_matches_jax(shape, jax_takes):
    """Within one bf16 ulp of the plain conv and of the JAX ``conv3_mxu``
    at ``cdt='bf16'`` (Pallas interpret mode), and in f32 within the sums'
    order of the plain conv."""
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(5)
    x = _rb(rng, (b, d, h, w, cin))
    k = _rb(rng, (3, 3, 3, cin, cout), (27 * cin) ** -0.5)
    sc = (rng.rand(cout) + 0.5).astype(np.float32)
    sh = (rng.randn(cout) * 0.1).astype(np.float32)
    xt, kt = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    sct, sht = torch.from_numpy(sc), torch.from_numpy(sh)
    got = conv3mxu.conv3_mxu_bf16_tiled_ref(xt, kt, sct, sht, relu=True)
    _one_ulp(got, conv3mxu.conv3_mxu_ref(xt, kt, sct, sht, True).float())
    if jax_takes:
        want = jax_conv3_mxu(jnp.asarray(x, BF16), jnp.asarray(k, BF16),
                             jnp.asarray(sc), jnp.asarray(sh), relu=True,
                             interpret=True, compute_dtype="bf16")
        _one_ulp(got, np.asarray(want.astype(jnp.float32)))
    f32 = conv3mxu.conv3_mxu_bf16_tiled_ref(xt, kt, sct, sht, relu=True,
                                            out_dtype=torch.float32)
    plain = conv3mxu.conv3_mxu_ref(xt.float(), kt.float(), sct, sht, True)
    assert (f32 - plain).abs().max().item() <= 1e-5 * plain.abs().max()


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 128)])
def test_k4_bf16_weight_layout(cin, cout):
    """Every element of the prepared weights, read through the MMA's
    descriptor offsets, is the tap, input channel and output channel that
    the kernel's stage, k slot and column say."""
    k = torch.arange(27 * cin * cout, dtype=torch.float64).reshape(
        3, 3, 3, cin, cout)
    wp = conv3mxu.prepare_weights_bf16_ref(k)
    assert wp.shape == (3, cin // 32, cout // 64, 9, 2, 2, 8, 8, 8)
    b = wp.reshape(3, cin // 32, cout // 64, 9, 2, 1024)
    b = b[..., conv3mxu.b_offsets_bf16()]  # (kd, c, nb, tap, s, 16, 64)
    kd, c, nb, t, s, kk, n = torch.meshgrid(
        *(torch.arange(m) for m in b.shape), indexing="ij")
    ci = c * 32 + conv3mxu.unit_channels_bf16()[s, kk]
    co = nb * 64 + conv3mxu.column_channels_bf16()[n]
    assert torch.equal(b, k[kd, t // 3, t % 3, ci, co])


@pytest.mark.parametrize("h,w", [(5, 40), (9, 20), (16, 16), (5, 7),
                                 (3, 64), (12, 9)])
def test_k4_bf16_halos_and_tap_rows(h, w):
    """A block's row m reads, for tap (kh, kw), input voxel (h0 + y + kh -
    1, w0 + x + kw - 1) of its stage's plane, (y, x) its tile voxel, zero
    outside the volume; the rows cover the tile once, and row g + 8 of a
    warp reads at tap (kh, kw) what row g reads at (kh + 1, kw)."""
    tile = conv3mxu.bf16_tile(h, w)
    th, tw = tile
    assert th * tw == 256 and th % 8 == 0
    ry, rx = conv3mxu.bf16_row_voxels(tile)
    assert len(set(zip(ry.tolist(), rx.tolist()))) == 256
    lo = (torch.arange(256) % 16) < 8
    for kh in range(2):
        assert torch.equal(conv3mxu.bf16_tap_rows(tile, kh + 1, 1)[lo],
                           conv3mxu.bf16_tap_rows(tile, kh, 1)[~lo])
    x = torch.arange(1.0, 2 * 3 * h * w + 1).reshape(1, 2, h, w, 3)
    halos = conv3mxu.bf16_halos(x, tile)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))  # zeros around the volume
    ntw = -(-w // tw)
    for tile_i in range(halos.shape[2]):
        h0, w0 = (tile_i // ntw) * th, (tile_i % ntw) * tw
        for kh in range(3):
            for kw in range(3):
                rows = halos[:, :, tile_i][:, :, conv3mxu.bf16_tap_rows(
                    tile, kh, kw)]
                hh, ww = h0 + ry + kh, w0 + rx + kw  # in xp
                inside = (hh < h + 2) & (ww < w + 2)
                want = torch.zeros_like(rows)
                want[:, :, inside] = xp[:, :, hh[inside], ww[inside]]
                assert torch.equal(rows, want)


# K1-bf16's staging (``conv3p.conv3_planes_bf16_staged_ref``): raw bf16
# rows in the ring slot as the kernel's copies leave them (16-byte copies
# and 4-byte halo pairs where W % 8 == 0, single values otherwise; NaN
# where nothing is written), read through each thread's column indices
# (the clamped column under edge padding), widened, the pre-affine applied
# and the zero padding masked after it.
# The JAX kernel takes H % 8 == 0 and W <= 128: the ragged-H case is held
# to the plain conv alone.  Under zero padding with a pre-affine the Pallas
# kernel also pre-affines the zero planes past D (tests/test_torch_conv3p.py
# says so): there the first and last output planes are left out of the
# comparison with it.
@pytest.mark.parametrize("shape,act,residual,pad_mode,pre", [
    ((2, 1, 1, 3, 8, 32), "leaky", True, "edge", None),   # FeatureExtraction
    ((1, 1, 1, 3, 8, 80), "leaky", True, "edge", None),   # interior pairs
    ((1, 4, 8, 4, 8, 40), "none", False, "zero", True),   # pre + zero pad
    ((1, 3, 5, 3, 8, 13), "none", True, "edge", False),   # W % 8 != 0
    ((1, 3, 5, 4, 16, 13), "leaky", False, "zero", True),
    ((1, 2, 4, 3, 9, 40), "leaky", True, "zero", True),   # ragged H and W
])
def test_k1_bf16_staging_matches_jax(shape, act, residual, pad_mode, pre):
    b, cin, cout, d, h, w = shape
    rng = np.random.RandomState(6)
    x = _rb(rng, (b, cin, d, h, w))
    k = (rng.randn(3, 3, 3, cin, cout) * (27 * cin) ** -0.5).astype(
        np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    res = _rb(rng, (b, cout, d, h, w)) if residual else None
    ps = rng.randn(cin).astype(np.float32) if pre is not None else None
    pt = rng.randn(cin).astype(np.float32) if pre is not None else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    args = (t(x).bfloat16(), t(k), t(bias),
            None if res is None else t(res).bfloat16(), t(ps), t(pt))
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre)
    got = conv3p.conv3_planes_bf16_staged_ref(*args, **kw)
    assert not torch.isnan(got.float()).any()  # nothing unwritten is read
    _one_ulp(got, conv3p.conv3_planes_ref(*args, **kw).float())
    if h % 8 == 0:
        j = lambda a, t=None: None if a is None else jnp.asarray(a, t)
        want = jax_conv3_planes(j(x, BF16), j(k), j(bias), j(res, BF16),
                                j(ps), j(pt), interpret=True, **kw)
        planes = (slice(1, -1) if pad_mode == "zero" and pre is not None
                  else slice(None))
        _one_ulp(got[:, :, planes],
                 np.asarray(want.astype(jnp.float32))[:, :, planes])


@pytest.mark.parametrize("kind", ["random", "ties", "negative"])
def test_k3_bf16_plain_matches_jax_exactly(kind):
    rng = np.random.RandomState(4)
    y = _bf16_values(rng.randn(1, 16, 16, 16, 16))
    if kind == "ties":
        y = np.maximum(y, 0.0)
    elif kind == "negative":
        y = -np.abs(y) - 1.0
    want = phase_maxpool_pallas(space_to_depth_3d(jnp.asarray(y, BF16)),
                                interpret=True)
    assert want.dtype == BF16
    got = K.maxpool3d_k3s2p1_bf16(torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- (c)

def _whole_limits(run):
    f, b = run["jax"]["f32"], run["jax"]["bf16"]
    scale = _rms(f["hm"])
    return (_rms(b["hm"] - f["hm"]) / scale, _rms(b["joints"] - f["joints"]),
            scale)


def test_whole_bf16_forward_against_jax(run):
    """Heatmaps and joints of the port's bf16 forward against the JAX
    package's bf16 forward, and away from its f32 forward (see the module
    docstring)."""
    jhm, jj, scale = _whole_limits(run)
    f, b = run["jax"]["f32"], run["jax"]["bf16"]
    hm = run["hm"].float().numpy()
    assert jhm > 1e-3 and jj > 1e-3  # bf16 moves the JAX forward
    assert np.isfinite(hm).all()
    assert _rms(hm - b["hm"]) / scale <= WHOLE * jhm
    assert _rms(run["joints"] - b["joints"]) <= WHOLE * jj
    assert _rms(hm - f["hm"]) / scale >= AWAY * jhm
    assert _rms(run["joints"] - f["joints"]) >= AWAY * jj


def test_f32_path_posing_as_bf16_fails_the_check(run):
    """The port's f32 forward on the same weights sits far inside
    AWAY x the bf16-vs-f32 difference from the JAX f32 forward, so the
    check above would catch it."""
    jhm, _, scale = _whole_limits(run)
    model, lct = _port(Config().tiny(SIZE), run["tree"])
    _, hm = make_forward(model)(torch.from_numpy(run["meas"]), lct)
    assert _rms(hm.numpy() - run["jax"]["f32"]["hm"]) / scale < \
        0.01 * AWAY * jhm


def _fe_params(fe, p):
    def put(conv, d):
        conv.weight.copy_(torch.from_numpy(np.array(d["kernel"])).permute(
            4, 3, 0, 1, 2))
        conv.bias.copy_(torch.from_numpy(np.array(d["bias"])))

    with torch.no_grad():
        put(fe.conv1[1], p["conv_in"])
        for i, r in ((2, "res1"), (3, "res2")):
            put(fe.conv1[i].tmp[1], p[r]["conv1"])
            put(fe.conv1[i].tmp[4], p[r]["conv2"])
        fe.weights.copy_(torch.from_numpy(
            np.array(p["corner_kernel"])).permute(4, 3, 0, 1, 2))


def test_feature_extraction_matches_jax_pallas_route(monkeypatch):
    """FeatureExtraction at 32^3 against the JAX module on its TPU route
    (every conv the Pallas K1, here in interpret mode: the gate is forced
    as the JAX package's own tests force theirs): the same rounding
    points, so a tenth of the JAX module's bf16-vs-f32 RMS."""
    import hiddenpose_tpu.models.blocks as jax_blocks

    rng = np.random.RandomState(5)
    x = _bf16_values(rng.rand(2, 32, 32, 32, 1))
    monkeypatch.setattr(jax_blocks, "pallas_enabled", lambda: True)
    ys = {}
    for name, dt in (("f32", jnp.float32), ("bf16", BF16)):
        m = JaxFE(basedim=1, stride=1, dtype=dt)
        v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y = m.apply(v, jnp.asarray(x))
        assert y.dtype == dt
        ys[name] = np.asarray(y.astype(jnp.float32)).transpose(0, 4, 1, 2, 3)
    fe = FeatureExtraction(1, 1, dtype=torch.bfloat16)
    _fe_params(fe, v["params"])
    with torch.inference_mode():
        got = fe(torch.from_numpy(x.transpose(0, 4, 1, 2, 3)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    own = _rms(ys["bf16"] - ys["f32"])
    assert own > 0.0
    assert _rms(got - ys["bf16"]) <= MATCHED * own


def test_bottleneck_matches_jax_fused_route(monkeypatch):
    """A c64 Bottleneck at 16^3 against the JAX block on its fused route
    (conv2 + bn2 + ReLU in the Pallas K4 at compute_dtype bf16, interpret
    mode; the route forced as ``tests/test_conv3mxu.py`` forces it): the
    same rounding points, so a tenth of the JAX block's bf16-vs-f32 RMS."""
    import hiddenpose_tpu.ops.pallas.conv3mxu as jax_k4

    monkeypatch.setenv("HP_CONV3MXU_ROUTE", "full")
    monkeypatch.delenv("HP_CONV3MXU_DT", raising=False)
    rng = np.random.RandomState(6)
    c = 64
    x = rng.rand(2, 16, 16, 16, 4 * c).astype(np.float32)
    m32 = JaxBottleneck(planes=c, train=False)
    v = m32.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = {k: {"mean": jnp.asarray(rng.randn(*s["mean"].shape) * 0.1,
                                     jnp.float32),
                 "var": jnp.asarray(rng.rand(*s["var"].shape) + 0.5,
                                    jnp.float32)}
             for k, s in v["batch_stats"].items()}
    v = {"params": v["params"], "batch_stats": stats}
    want32 = np.asarray(m32.apply(v, jnp.asarray(x)))
    monkeypatch.setattr(jax_k4, "conv3mxu_enabled", lambda: True)
    want = JaxBottleneck(planes=c, train=False, dtype=BF16).apply(
        v, jnp.asarray(x))
    assert want.dtype == jnp.float32  # bn3 + residual: f32, as flax's BN
    want = np.asarray(want)

    blk = Bottleneck(4 * c, c, 1, False, dtype=torch.bfloat16).eval()
    p = v["params"]
    with torch.no_grad():
        for name in ("conv1", "conv2", "conv3"):
            getattr(blk, name).weight.copy_(torch.from_numpy(
                np.array(p[name]["kernel"])).permute(4, 3, 0, 1, 2))
        for name in ("bn1", "bn2", "bn3"):
            bn = getattr(blk, name)
            bn.weight.copy_(torch.from_numpy(np.array(p[name]["scale"])))
            bn.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
            bn.running_mean.copy_(torch.from_numpy(
                np.array(stats[name]["mean"])))
            bn.running_var.copy_(torch.from_numpy(
                np.array(stats[name]["var"])))
    n = K.conv3_mxu_bf16.launches
    with torch.inference_mode():
        got = blk(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert K.conv3_mxu_bf16.launches == n  # CPU: the plain version
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 4, 1).numpy()
    own = _rms(want - want32)
    assert own > 0.0
    assert _rms(got - want) <= MATCHED * own


def test_bf16_model_routes_and_refuses_training():
    """The bf16 model's convs are bf16 modules, its parameters float32;
    make_train_step builds its step at every precision the JAX package
    knows and refuses any other.  (Before bf16 training was ported it
    refused the model; ``tests/test_torch_train_precision.py`` holds the
    bf16 step against the JAX package's.)"""
    model, _ = build_nlospose(Config().tiny(SIZE).with_bf16().model,
                              device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert Config().with_bf16().model.compute_dtype == "bfloat16"
    assert t128_config().with_bf16().model.grid_dim == 128
    for precision in ("default", "high", "highest"):
        assert callable(make_train_step(model, matmul_precision=precision))
    with pytest.raises(ValueError):
        make_train_step(model, matmul_precision="bf16")


# ---------------------------------------------------------------- (d)

def test_default_server_is_bf16_and_matches_jax_default(run):
    """``InferenceServer()`` with no dtype on both sides (both bf16):
    requests cast to bf16 on the host, joints within (c)'s tolerance of
    the JAX server's, and away from the f32 forward."""
    tree = run["tree"]
    meas = [run["meas"][i] for i in range(2)] + [run["meas"][0] * 0.5]
    cfg = Config().tiny(SIZE)
    psrv = InferenceServer(cfg, state_dict_from_jax(tree), batch_size=2,
                           max_wait_ms=1.0, device="cpu")
    jsrv = JaxServer(JaxConfig().tiny(SIZE), tree, batch_size=2,
                     max_wait_ms=1.0)
    sent = []
    launch = psrv._forward

    def spy(x, lct):
        sent.append(x.dtype)
        return launch(x, lct)

    psrv._forward = spy
    try:
        assert psrv.cfg.model.compute_dtype == "bfloat16"
        assert psrv.model.compute_dtype == torch.bfloat16
        assert jsrv.cfg.model.compute_dtype == "bfloat16"
        got = [f.result(timeout=300)["joints"]
               for f in [psrv.submit(m) for m in meas]]
        want = [f.result(timeout=300)["joints"]
                for f in [jsrv.submit(m) for m in meas]]
    finally:
        psrv.close()
        jsrv.close()
    assert sent and all(d == torch.bfloat16 for d in sent)
    assert all(g.dtype == np.float32 and g.shape == (24, 3) for g in got)
    _, jj, _ = _whole_limits(run)
    got, want = np.stack(got[:2]), np.stack(want[:2])
    assert _rms(got - want) <= WHOLE * jj
    assert np.abs(want - want.mean()).max() > 0.5  # not all centred


def test_bf16_server_transfer_dtype():
    """Mirrors ``tests/test_serve.py::test_bf16_server_transfer_dtype``:
    a bf16 server ships bf16 requests and returns finite f32 joints; an
    f32 server ships f32."""
    srv = InferenceServer(Config().tiny(SIZE), batch_size=2,
                          dtype="bfloat16", max_wait_ms=1.0, rng_seed=7,
                          device="cpu")
    try:
        assert srv._transfer_dtype == torch.bfloat16
        out = srv.infer(np.random.RandomState(42).rand(
            1, SIZE, SIZE, SIZE).astype(np.float32))
        assert out["joints"].dtype == np.float32
        assert np.isfinite(out["joints"]).all()
    finally:
        srv.close()
    f32 = InferenceServer(Config().tiny(SIZE), batch_size=2,
                          dtype="float32", device="cpu")
    try:
        assert f32._transfer_dtype == torch.float32
        assert f32.model.compute_dtype == torch.float32
    finally:
        f32.close()


def test_bf16_server_batches_concurrent_requests():
    """A bf16 server answers concurrent submitters, each capture as it
    answers it alone (the batch does not leak into a result)."""
    srv = InferenceServer(Config().tiny(SIZE), batch_size=2,
                          max_wait_ms=20.0, rng_seed=3, device="cpu")
    caps = [np.random.RandomState(50 + i).rand(
        1, SIZE, SIZE, SIZE).astype(np.float32) for i in range(3)]
    results = {}

    def client(i):
        results[i] = srv.infer(caps[i])["joints"]

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        alone = [srv.infer(c)["joints"] for c in caps]
    finally:
        srv.close()
    for i in range(3):
        np.testing.assert_allclose(results[i], alone[i], rtol=0, atol=1e-5)


def test_upsample_rounds_per_axis():
    """The bf16 UNet's trilinear x2 is the JAX package's three per-axis
    passes (``resize_trilinear_planes``), each a contraction of the bf16
    volume with the interpolation weights rounded to bf16, summed in f32
    and rounded to bf16: equal to the JAX function, and not in general to
    the per-axis passes with exact weights nor to one rounding at the
    end."""
    from hiddenpose_tpu.models.unet3d import resize_trilinear_planes
    from hiddenpose_tpu_torch.models.unet3d import upsample2

    x = torch.from_numpy(np.random.RandomState(8).randn(
        1, 3, 3, 4, 5).astype(np.float32)).bfloat16()
    got = upsample2(x)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 6, 8, 10)
    want = resize_trilinear_planes(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), (6, 8, 10))
    assert want.dtype == jnp.bfloat16
    assert torch.equal(got.float(),
                       torch.from_numpy(np.asarray(want, np.float32)))
    y = x.float()
    for size in ((6, 4, 5), (6, 8, 5), (6, 8, 10)):
        y = F.interpolate(y, size=size, mode="trilinear",
                          align_corners=True).bfloat16().float()
    once = F.interpolate(x.float(), size=(6, 8, 10), mode="trilinear",
                         align_corners=True).bfloat16().float()
    assert not torch.equal(got.float(), y)
    assert not torch.equal(got.float(), once)


def test_upsample_serves_then_trains():
    """The bf16 upsample's weights, made once a shape, are ordinary tensors
    even when a server's inference-mode forward makes them first: a train
    step on the same shapes then differentiates through them."""
    from hiddenpose_tpu_torch.models.unet3d import upsample2

    x = torch.from_numpy(np.random.RandomState(9).randn(
        1, 2, 7, 5, 3).astype(np.float32)).bfloat16()
    with torch.inference_mode():
        want = upsample2(x)
    xt = x.clone().requires_grad_()
    got = upsample2(xt)
    got.float().sum().backward()
    assert torch.equal(got.detach(), want)
    assert xt.grad.dtype == torch.bfloat16 and torch.isfinite(
        xt.grad.float()).all()
