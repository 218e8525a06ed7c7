"""The port's NlosPose against the JAX package's, on identical weights.

Weights: the port's peaked random weights
(``hiddenpose_tpu_torch.utils.peaked``), carried to the JAX layout by the
JAX package's own importer (``utils/torch_import.convert_state_dict``) and
back to the port by ``hiddenpose_tpu_torch.utils.jax_bridge``.  They make
peaked heatmaps whose joints move off the volume centre (the reference
init makes nearly uniform heatmaps, which would hide errors in the
joints).

Tolerances: every op is f32 on both sides and the two differ only in
summation order and FFT library, measured at about 1e-6 relative; the
tests allow 1e-4 of the peak for heatmaps and refinement and 1e-3 voxel
for the joints.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import Config
from hiddenpose_tpu.models.blocks import FeatureExtraction as JaxFE
from hiddenpose_tpu.models.blocks import corner_mask_init
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.models.unet3d import UNet3d as JaxUNet
from hiddenpose_tpu.ops.softargmax import softmax_integral as jax_joints
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.train.step import make_forward
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict


@functools.lru_cache(maxsize=None)
def _jax_model(size):
    """(JAX model, LCT params, variable shapes) at tiny(size)."""
    model, lct = jax_build(Config().tiny(size).model)
    meas = jnp.zeros((1, 1, size, size, size), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), meas, lct, train=False))
    return model, lct, {"params": shapes["params"],
                        "batch_stats": shapes["batch_stats"]}


def peaked(size, seed=1):
    """The port's peaked weights at tiny(size), as a state_dict."""
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(Config().tiny(size).model)
    return peaked_state_dict(template, seed)


def jax_variables(size, seed=1):
    """(JAX model, LCT params, numpy {params, batch_stats}) at tiny(size),
    holding the weights of ``peaked(size, seed)``."""
    model, lct, _ = _jax_model(size)
    tree = convert_state_dict(
        {k: v.numpy() for k, v in peaked(size, seed).items()}, strict=True)
    return model, lct, tree


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(size, tree):
    model, lct = build_nlospose(Config().tiny(size).model, device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model, lct


def test_bridge_round_trip():
    """JAX tree -> bridge -> port -> state_dict -> convert_state_dict
    (strict: no leftover keys) gives back the JAX tree exactly, and the
    bridge gives back the state_dict the tree was made from."""
    sd = peaked(16, seed=2)
    _, _, tree = jax_variables(16, seed=2)
    bridged = state_dict_from_jax(tree)
    assert bridged.keys() == sd.keys()
    for k in sd:
        assert torch.equal(bridged[k], sd[k]), k
    model, _ = _port(16, tree)
    back = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, strict=True)
    want, got = _flat(tree), _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_init_has_the_jax_structure():
    """The port's own random init converts strictly into a tree of the
    JAX model's exact paths and shapes."""
    _, _, shapes = _jax_model(16)
    model, _ = build_nlospose(Config().tiny(16).model, device="cpu", seed=3)
    got = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, strict=True)
    flat_shapes = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.shape for k, v in _flat(got).items()} == flat_shapes
    corner = model.feature_extraction.weights.detach()
    np.testing.assert_array_equal(
        corner.permute(2, 3, 4, 1, 0).numpy(),
        np.asarray(corner_mask_init(None, (3, 3, 3, 1, 1))))


def test_port_init_is_seeded():
    cfg = Config().tiny(16).model
    a = build_nlospose(cfg, device="cpu", seed=5)[0].state_dict()
    b = build_nlospose(cfg, device="cpu", seed=5)[0].state_dict()
    c = build_nlospose(cfg, device="cpu", seed=6)[0].state_dict()
    w = "pose_net.layer1.0.conv2.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[w], c[w])


@pytest.mark.parametrize("size", [16, 32])
def test_eval_forward_matches_jax(size):
    jmodel, jlct, tree = jax_variables(size)
    meas = np.random.RandomState(size).rand(
        2, 1, size, size, size).astype(np.float32)
    jhm, jref = jax.jit(lambda v, m: jmodel.apply(v, m, jlct, train=False))(
        tree, jnp.asarray(meas))
    jhm, jref = np.asarray(jhm), np.asarray(jref)
    jj = np.asarray(jax_joints(jnp.asarray(jhm), 24))

    model, lct = _port(size, tree)
    with torch.inference_mode():
        hm, ref = model(torch.from_numpy(meas), lct)
    joints, hm2 = make_forward(model)(torch.from_numpy(meas), lct)
    assert hm.shape == jhm.shape == (2, 24) + (size // 2,) * 3
    assert ref.shape == jref.shape == meas.shape
    assert torch.equal(hm2, hm)
    assert np.abs(jj - jj.mean()).max() > 0.5  # joints are not all centred
    np.testing.assert_allclose(hm.numpy(), jhm, rtol=0,
                               atol=1e-4 * np.abs(jhm).max())
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0,
                               atol=1e-4 * np.abs(jref).max())
    np.testing.assert_allclose(joints.numpy(), jj, rtol=0, atol=1e-3)


def test_feature_extraction_matches_jax():
    _, _, tree = jax_variables(16, seed=2)
    model, _ = _port(16, tree)
    x = np.random.RandomState(0).rand(2, 1, 8, 16, 16).astype(np.float32)
    want = jax.jit(lambda p, v: JaxFE(basedim=1, stride=1).apply(
        {"params": p}, v, False))(
        tree["params"]["feature_extraction"],
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    with torch.inference_mode():
        got = model.feature_extraction(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 4, 1, 2, 3),
                               rtol=1e-5, atol=1e-5)


def test_unet_matches_jax():
    _, _, tree = jax_variables(16)
    model, _ = _port(16, tree)
    x = np.random.RandomState(1).rand(2, 1, 16, 16, 16).astype(np.float32)
    want = jax.jit(lambda p, v: JaxUNet(in_channels=1, n_channels=4).apply(
        {"params": p}, v, False))(
        tree["params"]["autoencoder"], jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    with torch.inference_mode():
        got = model.autoencoder(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 4, 1, 2, 3),
                               rtol=1e-4, atol=1e-5)


def test_unsupported_backbone_raises():
    """A backbone the port does not have raises; the ``posenet2d``
    backbone builds in float32 and, since it was ported in bfloat16 too
    (``tests/test_torch_posenet2d_bf16.py``), in bfloat16."""
    import dataclasses

    m = Config().tiny(16).model
    with pytest.raises(NotImplementedError):
        build_nlospose(dataclasses.replace(m, backbone="resnet18"),
                       device="cpu")
    for dtype in ("float32", "bfloat16"):
        model, _ = build_nlospose(dataclasses.replace(
            m, backbone="posenet2d", compute_dtype=dtype), device="cpu")
        assert type(model.pose_net).__name__ == "ResPoseNet2D"
        assert model.pose_net.head.compute_dtype == getattr(torch, dtype)


# ------------------------------------------------- the UNet's output conv

def _out_conv_case(seed, cin, cout, shape):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, cin, *shape).astype(np.float32)
    kernel = rng.randn(1, 1, 1, cin, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    ct = rng.randn(2, cout, *shape).astype(np.float32)
    return x, kernel, bias, ct


@pytest.mark.parametrize("cin,cout,shape", [(4, 1, (4, 5, 6)),
                                            (3, 2, (2, 3, 4))])
def test_out_conv_matches_the_jax_einsum_and_the_library_conv(cin, cout,
                                                              shape):
    """``OutConv`` (a channel contraction in plain tensor ops) against the
    JAX package's ``OutConv1x1`` on bridged weights, value and the
    gradients of input, weight and bias, and against the ``nn.Conv3d`` it
    holds its parameters in.  f32 sums of ``cin`` terms (forward, dx) or
    of every voxel (dw, db): 1e-6 of each result's max."""
    from hiddenpose_tpu.models.unet3d import OutConv1x1
    from hiddenpose_tpu_torch.models.unet3d import OutConv

    x, kernel, bias, ct = _out_conv_case(cin + cout, cin, cout, shape)
    ref = OutConv1x1(features=cout)
    params = {"params": {"kernel": jnp.asarray(kernel),
                         "bias": jnp.asarray(bias)}}
    y_w, pull = jax.vjp(lambda p, xp: ref.apply(p, xp), params,
                        jnp.asarray(x))
    dp_w, dx_w = pull(jnp.asarray(ct))

    out = OutConv(cin, cout)
    assert list(out.state_dict()) == ["conv.weight", "conv.bias"]
    assert out.conv.weight.shape == (cout, cin, 1, 1, 1)
    # the bridge's layout: (1, 1, 1, C_in, C_out) -> (C_out, C_in, 1, 1, 1)
    out.load_state_dict({
        "conv.weight": torch.from_numpy(kernel).permute(4, 3, 0, 1, 2),
        "conv.bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).requires_grad_()
    y = out(xt)
    y.backward(torch.from_numpy(ct))
    got = (y.detach(), xt.grad, out.conv.weight.grad, out.conv.bias.grad)

    want = (np.asarray(y_w), np.asarray(dx_w),
            np.asarray(dp_w["params"]["kernel"]).transpose(4, 3, 0, 1, 2),
            np.asarray(dp_w["params"]["bias"]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())

    xt.grad = None
    out.zero_grad()
    y2 = out.conv(xt)
    y2.backward(torch.from_numpy(ct))
    lib = (y2.detach(), xt.grad, out.conv.weight.grad, out.conv.bias.grad)
    for a, b in zip(got, lib):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_out_conv_backward_does_not_enter_the_conv_backward():
    """No ``ConvolutionBackward`` node hangs off ``OutConv``'s output."""
    from hiddenpose_tpu_torch.models.unet3d import OutConv

    y = OutConv(4, 1)(torch.randn(1, 4, 2, 2, 2, requires_grad=True))
    seen, todo = set(), [y.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    names = {type(f).__name__ for f in seen}
    assert not any("Convolution" in n for n in names), names


def test_unet_state_dict_keeps_the_output_conv_names():
    from hiddenpose_tpu_torch.models.unet3d import UNet3d

    keys = [k for k in UNet3d(1, 4).state_dict() if k.startswith("out.")]
    assert keys == ["out.conv.weight", "out.conv.bias"]
