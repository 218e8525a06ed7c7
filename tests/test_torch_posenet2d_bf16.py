"""NlosPose's ``posenet2d`` backbone in bfloat16 against the JAX package.

The JAX ``ResPoseNet2D(dtype=bf16)``: every conv and deconv rounds its
input and kernel to bf16 and returns bf16, every BatchNorm (no dtype)
returns float32, so the ReLUs, the max-pool and the residual adds run in
f32; the final conv adds its bias in bf16.  ``visible_net`` runs in f32
on ``feature + refine`` (the UNet's bf16 refinement promoted by the f32
feature).  The JAX side is compiled without XLA's excess precision
(``_exact_jit``), which otherwise drops roundings the program writes.

Two bf16 forwards agree bit for bit only where every sum rounds the same
way; a sum within a rounding of a bf16 boundary rounds either way, and
the next layers carry that ulp on.  So each part of the 2D net (the stem,
a Bottleneck with and without its projection), fed the same input, is
held to a tenth of the JAX part's own bf16-vs-f32 distance (RMS of the
output and of the input's VJP; readings 1e-5 to 1e-2 of it), and must lie
at least half as far from f32 as the JAX part (it rounds where JAX
rounds).  The deconv head's sums run over 2048 and 256 channels, so more
of them lie near a boundary: it is held layer by layer, each layer fed
the JAX layer's input, its outputs equal at 99% of the elements and
within one bf16 ulp at the rest (the BatchNorms, f32, within 1e-5 of the
largest output).  The whole 2D net (eval, output
and VJP) and the whole NlosPose forward at tiny(64) carry the ulps of
every part, as far as the bf16-vs-f32 distance itself (readings 0.65 to
0.96 of it): they are held as ``tests/test_torch_bf16_serve.py`` holds
the 3D model, within 2.5 times the JAX package's bf16-vs-f32 distance and
at least a quarter of it away from f32 (an f32 path posing as bf16 sits
1e-6 away).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from hiddenpose_tpu.config import Config as JaxConfig
from hiddenpose_tpu.models import posenet2d as jax_posenet2d
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.models import posenet2d
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.utils.jax_bridge import posenet2d_to_jax, to_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

LAYERS = (1, 1, 1, 1)
PART, WHOLE, AWAY = 0.1, 2.5, 0.25
SIZE = 64


def _exact_jit(f, *args):
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _nchw(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).transpose(
        0, 3, 1, 2)


def _net(dtype):
    """The small 2D net (one block a stage, 3 joints x 4 depths) with the
    peaked weights of seed 1, in eval mode."""
    net = posenet2d.ResPoseNet2D(8, num_joints=3, depth_dim=4, layers=LAYERS,
                                 dtype=dtype)
    net.load_state_dict(peaked_state_dict(
        posenet2d.ResPoseNet2D(8, num_joints=3, depth_dim=4, layers=LAYERS),
        1))
    return net.eval()


def _tree(net):
    return {"params": posenet2d_to_jax(dict(net.named_parameters()),
                                       layers=LAYERS),
            "batch_stats": posenet2d_to_jax(dict(net.named_buffers()),
                                            "batch_stats", layers=LAYERS)}


class _JaxStem(nn.Module):
    dtype: object

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(64, (7, 7), strides=(2, 2), padding="SAME",
                    use_bias=False, dtype=self.dtype, name="conv1")(x)
        x = nn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5, name="bn1")(x)
        return nn.max_pool(nn.relu(x), (3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1)))


def _port_stem(net, x):
    bb = net.backbone
    return F.max_pool2d(F.relu(bb.bn1(bb.conv1(x))), 3, 2, 1)


# part: (the port part of a net, the JAX module of a dtype, the tree's
# scope, input shape)
PARTS = {
    "stem": (_port_stem, lambda dt: _JaxStem(dt), ("backbone",),
             (2, 8, 64, 64)),
    "bottleneck": (lambda net, x: net.backbone.layer1_0(x),
                   lambda dt: jax_posenet2d.Bottleneck2D(
                       planes=64, use_projection=True, dtype=dt),
                   ("backbone", "layer1_0"), (2, 64, 16, 16)),
    "bottleneck_stride2": (lambda net, x: net.backbone.layer2_0(x),
                           lambda dt: jax_posenet2d.Bottleneck2D(
                               planes=128, stride=2, use_projection=True,
                               dtype=dt),
                           ("backbone", "layer2_0"), (2, 256, 16, 16)),
    "net": (lambda net, x: net(x),
            lambda dt: jax_posenet2d.ResPoseNet2D(
                num_joints=3, depth_dim=4, layers=LAYERS, dtype=dt),
            (), (2, 8, 64, 64)),
}


def _scope(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_part(part, dtype, tree, x, r):
    """The JAX part's output and the VJP of its input (NCHW, f32)."""
    _, make, path, _ = PARTS[part]
    module = make(dtype)
    params = _scope(tree["params"], path)
    stats = _scope(tree["batch_stats"], path)
    if part == "stem":
        params = {k: params[k] for k in ("conv1", "bn1")}
        stats = {"bn1": stats["bn1"]}
    kw = {} if part == "stem" else {"train": False}
    rj = jnp.asarray(r.transpose(0, 2, 3, 1))

    def loss(a):
        y = module.apply({"params": params, "batch_stats": stats}, a, **kw)
        return jnp.sum(y.astype(jnp.float32) * rj), y

    (_, y), gx = _exact_jit(jax.value_and_grad(loss, has_aux=True),
                            jnp.asarray(x.transpose(0, 2, 3, 1)))
    return _nchw(y), _nchw(gx), y.dtype


def _port_part(part, net, x, r):
    xt = torch.from_numpy(x).requires_grad_()
    y = PARTS[part][0](net, xt)
    (y.float() * torch.from_numpy(r)).sum().backward()
    return y.detach().float().numpy(), xt.grad.numpy(), y.dtype


@pytest.mark.parametrize("part", list(PARTS))
def test_2d_part_in_bf16_matches_jax(part):
    """Each part's forward and input VJP in bf16 against the JAX part on
    the same input (see the module's docstring for the limits); the
    output's dtype is the JAX part's (f32 out of the stem and a block,
    bf16 out of the whole net)."""
    shape = PARTS[part][3]
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32) * (3.0 if part == "stem"
                                                else 1.0)
    f32, bf16 = _net(torch.float32), _net(torch.bfloat16)
    tree = _tree(f32)
    r_shape = _port_part(part, f32, x, np.zeros(1, np.float32))[0].shape
    r = rng.randn(*r_shape).astype(np.float32)
    jf = _jax_part(part, jnp.float32, tree, x, r)
    jb = _jax_part(part, jnp.bfloat16, tree, x, r)
    pb = _port_part(part, bf16, x, r)
    assert str(pb[2]).replace("torch.", "") == jb[2].name
    for i, what in ((0, "output"), (1, "input VJP")):
        ref = _rms(jb[i] - jf[i])
        assert ref > 1e-4 * _rms(jf[i]), what  # bf16 moves the JAX part
        limit = (PART if part != "net" else WHOLE) * ref
        assert _rms(pb[i] - jb[i]) <= limit, (what, _rms(pb[i] - jb[i]), ref)
        away = 0.5 if part != "net" else AWAY
        assert _rms(pb[i] - jf[i]) >= away * ref, what


def _within_an_ulp(got, want):
    """Share of equal elements, and whether every other lies within one
    bf16 ulp of the larger magnitude of the two."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float(np.mean(got == want)), bool(
        np.all(np.abs(got - want) <= ulp))


def test_2d_head_in_bf16_rounds_layer_by_layer():
    """The deconv head in bf16, each layer on the JAX layer's input: the
    three deconvs and the final conv (its bias added in bf16) equal the
    JAX layers' bf16 outputs at 99% of the elements at least and within
    one ulp elsewhere; the BatchNorms return f32 within 1e-5."""
    net = _net(torch.bfloat16)
    tree = _tree(_net(torch.float32))
    x = np.random.RandomState(3).randn(2, 2048, 2, 2).astype(np.float32)
    jm = jax_posenet2d.DeconvHead2D(num_joints=3, depth_dim=4,
                                    dtype=jnp.bfloat16)
    v = {"params": tree["params"]["head"],
         "batch_stats": tree["batch_stats"]["head"]}
    y, mutated = _exact_jit(lambda v, a: jm.apply(
        v, a, train=False, capture_intermediates=True,
        mutable=["intermediates"]), v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    seen = {k: _nchw(o["__call__"][0]) for k, o in
            mutated["intermediates"].items() if k != "__call__"}
    h, bf = net.head, torch.bfloat16
    inp = torch.from_numpy(x)
    with torch.no_grad():
        for i in range(1, 4):
            m = getattr(h, f"deconv{i}")
            d = F.conv_transpose2d(inp.to(bf), m.weight.to(bf), None,
                                   m.stride, m.padding)
            same, ulp = _within_an_ulp(d.float(), seen[f"deconv{i}"])
            assert same >= 0.99 and ulp, (i, same)
            out = getattr(h, f"bn{i}")(torch.tensor(seen[f"deconv{i}"])
                                       .to(bf))
            assert out.dtype == torch.float32
            want = seen[f"bn{i}"]
            assert np.abs(out.numpy() - want).max() <= 1e-5 * np.abs(
                want).max()
            inp = F.relu(torch.tensor(want))
        fin = (F.conv2d(inp.to(bf), h.final.weight.to(bf))
               + h.final.bias.to(bf)[:, None, None])
    same, ulp = _within_an_ulp(fin.float(), seen["final"])
    assert same >= 0.99 and ulp, same
    assert fin.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16


def _nlospose_cfgs(size):
    jc = dataclasses.replace(JaxConfig().tiny(size).model,
                             backbone="posenet2d")
    pc = dataclasses.replace(Config().tiny(size).model, backbone="posenet2d")
    return jc, pc


def test_posenet2d_bf16_builds_and_rounds_where_jax_does():
    """``build_nlospose`` takes the posenet2d backbone in bf16 (it raised
    before): heatmaps bf16 of the JAX shape, visible_net's input f32, the
    2D net's convs bf16 and its BatchNorms f32."""
    _, pc = _nlospose_cfgs(32)
    model, lct = build_nlospose(dataclasses.replace(
        pc, compute_dtype="bfloat16"), device="cpu")
    seen = {}
    net = model.pose_net
    hooks = [net.register_forward_pre_hook(
                 lambda m, i: seen.__setitem__("net_in", i[0].dtype)),
             net.backbone.conv1.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("conv1", o.dtype)),
             net.backbone.bn1.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("bn1", o.dtype)),
             net.head.register_forward_hook(
                 lambda m, i, o: seen.__setitem__("head", o.dtype))]
    meas = torch.rand(2, 1, 32, 32, 32, generator=torch.Generator()
                      .manual_seed(0))
    with torch.no_grad():
        hm, refine = model(meas, lct)
    for h in hooks:
        h.remove()
    assert hm.shape == (2, 24, 16, 8, 8) and hm.dtype == torch.bfloat16
    assert refine.dtype == torch.bfloat16
    assert seen == {"net_in": torch.float32, "conv1": torch.bfloat16,
                    "bn1": torch.float32, "head": torch.bfloat16}


def test_nlospose_posenet2d_bf16_forward_against_jax():
    """The serving forward of the posenet2d NlosPose in bf16 at tiny(64)
    (heatmaps (2, 24, 32, 16, 16)) against the JAX package's bf16 forward
    on the same weights and bf16-valued captures, by heatmap RMS over the
    f32 heatmaps' RMS and by the joints' RMS distance: within WHOLE x the
    JAX package's own bf16-vs-f32 distance, and the heatmaps at least
    AWAY x that from the JAX f32 forward."""
    jc, pc = _nlospose_cfgs(SIZE)
    with torch.device("meta"):
        template = NlosPose(pc)
    sd = peaked_state_dict(template, 1)
    tree = {"params": to_jax({n: sd[n] for n, _ in
                              template.named_parameters()}),
            "batch_stats": to_jax({n: sd[n] for n, _ in
                                   template.named_buffers()}, "batch_stats")}
    meas = np.asarray(jnp.asarray(np.random.RandomState(7).rand(
        2, 1, SIZE, SIZE, SIZE).astype(np.float32)).astype(
        jnp.bfloat16).astype(jnp.float32))
    from hiddenpose_tpu.ops.softargmax import softmax_integral

    jax_out = {}
    for name, dt in (("f32", "float32"), ("bf16", "bfloat16")):
        jm, jl = jax_build(dataclasses.replace(jc, compute_dtype=dt))
        hm = jax.jit(lambda v, m, jm=jm, jl=jl: jm.apply(
            v, m, jl, train=False)[0])(tree, jnp.asarray(meas))
        jax_out[name] = (np.asarray(hm.astype(jnp.float32)),
                         np.asarray(softmax_integral(hm, 24)))
    model, lct = build_nlospose(dataclasses.replace(
        pc, compute_dtype="bfloat16"), device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        hm, _ = model(torch.from_numpy(meas), lct)
    from hiddenpose_tpu_torch.ops.softargmax import softmax_integral as pj

    joints = pj(hm, 24).numpy()
    hm = hm.float().numpy()
    f, b = jax_out["f32"], jax_out["bf16"]
    assert hm.shape == b[0].shape == (2, 24, 32, 16, 16)
    scale = _rms(f[0])
    ref_hm, ref_j = _rms(b[0] - f[0]) / scale, _rms(b[1] - f[1])
    assert ref_hm > 1e-3 and ref_j > 1e-3
    assert np.isfinite(hm).all()
    assert _rms(hm - b[0]) / scale <= WHOLE * ref_hm
    assert _rms(joints - b[1]) <= WHOLE * ref_j
    # the joints are held from one side only: at the peaked weights a
    # joint sits on a voxel and takes the next one where a bf16 rounding
    # moves its peak, so the bf16 joints may equal the f32 ones
    assert _rms(hm - f[0]) / scale >= AWAY * ref_hm
