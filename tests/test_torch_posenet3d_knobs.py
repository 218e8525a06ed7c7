"""PoseNet3D's other configurations: the port (``hiddenpose_tpu_torch/
models/posenet3d.py``) against the JAX package's ``PoseNet3D`` with
``block="basic"`` and the knobs ``widen_factor``, ``conv1_t_size``,
``conv1_t_stride`` and ``no_max_pool``, on the CPU (every kernel wrapper
runs its plain version; the JAX package its XLA path).

* A tiny basic-block net (ResNet-18's layout cut to one block a stage,
  c64 throughout so that layer1's two 3^3 convs at 16^3 are the router's:
  K4's plain version in the port, fused with bn1 + ReLU and bn2 in
  serving): the eval forward within 1e-4 of the largest heatmap.  In
  train mode, a c64 BasicBlock at 16^3 (both convs on K4's training
  route): the forward, the VJP of a fixed cotangent (input and every
  parameter) and the new statistics within 1e-4; a narrow net at 16^3
  (no conv the router's there): the forward and the new statistics
  within 1e-4 of their largest, the VJP against the JAX VJP in float64,
  within twice the JAX f32 VJP's own distance from it.
* One eval forward per knob (the narrow widths with a 2-channel input,
  which the JAX stem's gate admits): the heatmaps within 1e-4 of their
  largest; the strided
  stem on an odd and an even extent, where flax's SAME pads (3, 3) and
  (2, 3).
* The bf16 eval forward: the JAX package's CPU path rounds where the port
  does not (its stem and its unfused convs round the raw conv before the
  affine), so, as ``test_torch_bf16_serve.py`` holds the whole bf16
  NlosPose, within 2.5 times the JAX model's own bf16-vs-f32 RMS, and at
  least a quarter of it away from the f32 forward.
* The bridge's round trip of each configuration's tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.models.posenet3d import BasicBlock as JaxBasicBlock
from hiddenpose_tpu.models.posenet3d import PoseNet3D as JaxPoseNet3D
from hiddenpose_tpu_torch.models.posenet3d import (
    BasicBlock,
    PoseNet3D,
    same_pads,
)
from hiddenpose_tpu_torch.utils.jax_bridge import (
    layout_state_dict_from_jax,
    layout_to_jax,
    posenet3d_layout,
)
import torch_threads

BF16 = jnp.bfloat16
BASE = dict(block="basic", layers=(1, 1, 1, 1), num_joints=4)
WIDE = dict(BASE, inplanes=(64, 64, 64, 64))
NARROW = dict(BASE, inplanes=(16, 16, 32, 32))
WHOLE, AWAY = 2.5, 0.25


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _init_shapes(jm, x):
    """The JAX module's variable tree, shapes only (no op runs)."""
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))


def _random_variables(variables, seed):
    """A tree shaped like ``variables`` with random values of unit-scale
    activations: fan-in scaled kernels, random BN affines and
    statistics."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "var" in name:
            return jnp.asarray(0.5 + 0.5 * rng.rand(*shape), jnp.float32)
        if "mean" in name or "bias" in name:
            return jnp.asarray(0.1 * rng.randn(*shape), jnp.float32)
        if len(shape) == 1:
            return jnp.asarray(1 + 0.1 * rng.randn(*shape), jnp.float32)
        fan_in = np.prod(shape[:-1])
        if "deconv" in name:
            fan_in = shape[-2] * 8
        return jnp.asarray(rng.randn(*shape) / np.sqrt(fan_in), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def _pair(kw, x, seed=0, in_channels=1):
    """The JAX module and its random variables, and the port model with
    the same weights (eval mode)."""
    jm = JaxPoseNet3D(**kw)
    v = _random_variables(_init_shapes(jm, x), seed)
    port_kw = {k: v_ for k, v_ in kw.items() if k != "inplanes"}
    if "inplanes" in kw:
        port_kw["widths"] = kw["inplanes"]
    model = PoseNet3D(in_channels=in_channels, **port_kw).eval()
    layout = _layout(kw, x)
    model.load_state_dict(layout_state_dict_from_jax(v, layout))
    model.to(memory_format=torch.channels_last_3d)
    return jm, v, model, layout


def _layout(kw, x):
    s2d = (kw.get("conv1_t_size", 7) == 7
           and kw.get("conv1_t_stride", 1) == 1
           and not kw.get("no_max_pool", False)
           and x.shape[-1] <= 2 and all(n % 2 == 0 for n in x.shape[1:4]))
    return posenet3d_layout(layers=kw["layers"], block=kw["block"],
                            s2d_stem=s2d)


def _port_x(x):
    return torch.from_numpy(np.array(x.transpose(0, 4, 1, 2, 3)))


def _port_eval(model, x):
    with torch.inference_mode():
        return model(_port_x(x)).float().permute(0, 2, 3, 4, 1).numpy()


def _x(shape, seed=1):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    """The tiny basic-block net on bf16-valued captures: the JAX f32 and
    bf16 eval forwards, one compile each, and the port's f32 model."""
    x = np.asarray(jnp.asarray(_x((1, 32, 32, 32, 1)), BF16).astype(
        jnp.float32))
    _, v, model, _ = _pair(WIDE, x)
    hm = {}
    for name, dt in (("f32", jnp.float32), ("bf16", BF16)):
        jm = JaxPoseNet3D(**WIDE, dtype=dt)
        hm[name] = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)).astype(
            jnp.float32))
    return dict(x=x, hm=hm, model=model)


def test_basic_net_eval_forward_matches_jax(wide):
    want = wide["hm"]["f32"]
    got = _port_eval(wide["model"], wide["x"])
    assert got.shape == want.shape == (1, 16, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2))


def _jax_train_vjp(jm_of, v, x, r, dtype, **train):
    """y, new statistics, d(params), dx of sum(y * r) in train mode, the
    JAX module ``jm_of(dtype)`` computing in ``dtype`` (``train``: the
    call's train flag, where the module takes one)."""
    jm = jm_of(dtype)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)

    def loss(p, xin):
        y, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          xin, mutable=["batch_stats"], **train)
        return jnp.sum(y * r.astype(dtype)), (y, new["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"],
                                             jnp.asarray(x, dtype))
    to_np = jax.tree_util.Partial(np.asarray, dtype=np.float64)
    return [jax.tree_util.tree_map(to_np, t) for t in (y, stats, gp, gx)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _port_train_vjp(model, x, r):
    """y, dx of sum(y * r) and the model's parameter gradients, in train
    mode, NDHWC numpy."""
    model.train()
    xt = _port_x(x).requires_grad_()
    out = model(xt)
    (out * torch.from_numpy(r).permute(0, 4, 1, 2, 3)).sum().backward()
    return (out.detach().permute(0, 2, 3, 4, 1).numpy(),
            xt.grad.permute(0, 2, 3, 4, 1).numpy())


def _hold_train_vjp(jm_of, v, x, r, port, grads_of, stats_of, **train):
    """The port's train-mode forward, VJP and new statistics against the
    JAX module's.  BatchNorm on batch statistics over few voxels makes the
    net's VJP ill-conditioned at test sizes (the JAX f32 VJP lies up to
    3e-2 from its own float64 VJP, by relative L2), so the input's and every
    parameter's gradient is held within twice the JAX f32 VJP's largest
    distance from float64 of that float64 VJP; the forward and the new
    statistics within 1e-4 of each tensor's largest.  ``grads_of()`` /
    ``stats_of()`` give the port's gradients / statistics as JAX trees."""
    y, stats, gp32, gx32 = _jax_train_vjp(jm_of, v, x, r, jnp.float32,
                                          **train)
    with jax.enable_x64(True):
        _, _, gp64, gx64 = _jax_train_vjp(jm_of, v, x, r, jnp.float64,
                                          **train)
    got_y, got_dx = _port_train_vjp(port, x, r)
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-4 * np.abs(y).max())
    want, own = _leaves(gp64), _leaves(gp32)
    limit = 2 * max(max(_rel_l2(own[k], w) for k, w in want.items()),
                    _rel_l2(gx32, gx64))
    assert _rel_l2(got_dx, gx64) <= limit
    got = _leaves(grads_of())
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel_l2(got[k], w) <= limit, (k, _rel_l2(got[k], w), limit)
    new = _leaves(stats_of())
    for k, w in _leaves(stats).items():
        np.testing.assert_allclose(new[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("threads", [1, torch_threads.BEFORE],
                         ids=["one_thread", "process_threads"])
def test_basic_block_train_vjp_matches_jax(threads):
    """A stride-1 c64 BasicBlock at 16^3 in train mode, one capture: conv1
    and conv2 on K4's route at 'highest' (the plain versions here), batch
    statistics over 4096 voxels a channel.  Well conditioned (a 1e-6 move
    of its input moves the JAX VJP by 3e-6), so the output, the VJP and
    the new statistics are held within 1e-4 (readings about 4e-6), at one
    torch thread and at the process's own count: the port's CPU batch
    norm takes K4's channels-last output contiguous, whose sums do not
    lose accuracy at one thread as the channels-last kernel's did
    (``flax_batch_norm``)."""
    rng = np.random.RandomState(4)
    x = rng.rand(1, 16, 16, 16, 64).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)
    v = _random_variables(_init_shapes(JaxBasicBlock(planes=64), x), 5)
    y, stats, gp, gx = _jax_train_vjp(
        lambda dt: JaxBasicBlock(planes=64, train=True, dtype=dt), v, x, r,
        jnp.float32)
    layout = [e for e in posenet3d_layout(layers=(1,), block="basic")
              if e[0].startswith("layer1.0.")]
    layout = [(n[len("layer1.0."):], c, p[1:], k) for n, c, p, k in layout]
    blk = BasicBlock(64, 64)
    blk.load_state_dict(layout_state_dict_from_jax(v, layout))
    blk.to(memory_format=torch.channels_last_3d)
    with torch_threads.fixed(threads):
        got_y, got_dx = _port_train_vjp(blk, x, r)
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-4 * np.abs(y).max())
    assert _rel_l2(got_dx, gx) < 1e-4
    got = _leaves(layout_to_jax({n: p.grad for n, p in
                                 blk.named_parameters()}, layout))
    want = _leaves(gp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _rel_l2(got[k], w) < 1e-4, k
    new = _leaves(layout_to_jax(dict(blk.named_buffers()), layout,
                                "batch_stats"))
    for k, w in _leaves(stats).items():
        np.testing.assert_allclose(new[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_basic_net_train_forward_vjp_and_statistics_match_jax():
    """The whole net at 16^3 in train mode (its stem's matrix-product
    backward and the pool's VJP on the port's side)."""
    x = _x((2, 16, 16, 16, 1))
    _, v, model, layout = _pair(NARROW, x, seed=2)
    r = np.random.RandomState(3).randn(2, 8, 8, 8, 4).astype(np.float32)
    _hold_train_vjp(
        lambda dt: JaxPoseNet3D(**NARROW, dtype=dt), v, x, r, model,
        lambda: layout_to_jax({n: p.grad for n, p in
                               model.named_parameters()}, layout),
        lambda: layout_to_jax(dict(model.named_buffers()), layout,
                              "batch_stats"),
        train=True)


KNOBS = {
    # two input channels, which the JAX stem's gate admits
    "widen_factor_0.5_two_channels": (dict(BASE, inplanes=(32, 32, 64, 64),
                                           widen_factor=0.5),
                                      (1, 16, 16, 16, 2), 2),
    "t_stride_2_even": (dict(NARROW, conv1_t_stride=2), (1, 16, 16, 16, 1),
                        1),
    "t_stride_2_odd": (dict(NARROW, conv1_t_stride=2), (1, 15, 16, 16, 1),
                       1),
    "no_max_pool": (dict(NARROW, no_max_pool=True), (1, 8, 8, 8, 1), 1),
    "t_size_3": (dict(NARROW, conv1_t_size=3), (1, 16, 16, 16, 1), 1),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knob_eval_forward_matches_jax(name):
    kw, shape, cin = KNOBS[name]
    x = _x(shape)
    jm, v, model, _ = _pair(kw, x, in_channels=cin)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    got = _port_eval(model, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n,k,s,want", [(16, 7, 2, (2, 3)), (15, 7, 2, (3, 3)),
                                        (16, 3, 1, (1, 1)), (9, 4, 2, (1, 2))])
def test_same_pads_are_flax(n, k, s, want):
    assert same_pads(n, k, s) == want


def test_basic_net_bf16_eval_forward_against_jax(wide):
    hm = wide["hm"]
    model = PoseNet3D(dtype=torch.bfloat16, widths=WIDE["inplanes"],
                      **BASE).eval()
    model.load_state_dict(wide["model"].state_dict())
    got = _port_eval(model, wide["x"])
    own = _rms(hm["bf16"] - hm["f32"])
    assert own > 1e-4 * _rms(hm["f32"])  # bf16 moves the JAX forward
    assert _rms(got - hm["bf16"]) <= WHOLE * own
    assert _rms(got - hm["f32"]) >= AWAY * own


@pytest.mark.parametrize("kw,s2d", [(dict(WIDE), True),
                                    (dict(NARROW, conv1_t_stride=2), False),
                                    (dict(NARROW, block="bottleneck"),
                                     True)],
                         ids=["basic", "basic_library_stem", "bottleneck"])
def test_posenet3d_bridge_round_trip(kw, s2d):
    """Port state_dict -> JAX tree -> port state_dict, bit for bit; the
    tree has the JAX module's structure."""
    x = _x((1, 16, 16, 16, 1))
    v = _init_shapes(JaxPoseNet3D(**kw), x)
    layout = posenet3d_layout(layers=kw["layers"], block=kw["block"],
                              s2d_stem=s2d)
    port_kw = {k: v_ for k, v_ in kw.items() if k != "inplanes"}
    model = PoseNet3D(widths=kw.get("inplanes", (64, 128, 256, 512)),
                      **port_kw)
    sd = model.state_dict()
    tree = {c: layout_to_jax(sd, layout, c)
            for c in ("params", "batch_stats")}
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(v)):
        assert a.shape == b.shape
    back = layout_state_dict_from_jax(tree, layout)
    assert back.keys() == sd.keys()
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
