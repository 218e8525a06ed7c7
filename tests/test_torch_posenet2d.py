"""NlosPose's ``posenet2d`` backbone in the port against the JAX package.

The same inputs, made from a numpy seed, go through ``hiddenpose_tpu``'s
``visible_net``, ``ResPoseNet2D`` and ``NlosPose(backbone="posenet2d")``
and the port's (``hiddenpose_tpu_torch/models/posenet2d.py``,
``models/nlospose.py``); weights are the port's peaked recipe
(``utils/peaked.py``) carried to flax by ``utils/jax_bridge.py``, whose
tree must equal flax's own ``init`` tree.

Tolerances.  ``visible_net``: exact (the same element-wise f32 arithmetic,
and the lower depth index first among ties); its backward 1e-6 of the
largest gradient, on tied and untied volumes.  The 2D net alone: 1e-5 of
the largest output (summation order through 4-16 conv layers), 1e-4 in
training mode, where BatchNorm divides by batch statistics; new running
statistics 1e-4 of each tensor's max; parameter gradients 2e-2 relative
L2 (see the test).  The NlosPose forward (eval): 1e-5 of the largest
heatmap logit (reading 1.9e-6), the UNet's refine 1e-4 (1.8e-5).

**The train step runs at tiny(64), not tiny(32).**  The 2D trunk halves
the grid five times, so at tiny(32) layer4 is 1 x 1 and each of its
BatchNorms normalises the 2 values of a batch of 2: the two synthetic
captures' values lie close, and the training forward is chaotic there.
Readings at tiny(32), the 2D net in training mode on the model's own
``visible_net`` input: the port's float32 forward lies 0.70 of the
largest logit from its own float64 forward, the JAX package's 0.78, and
the two 0.60 apart, growing from 2.3e-4 at layer3 to 0.20 at layer4's
first block.

At tiny(64) (layer4 2 x 2, 8 values a channel) that input still holds
the JAX package to about 3e-3: ``visible_net`` scales its values by 1e5
with a mean 6.6 times their spread after the stem conv, and flax computes
the batch variance as E[x^2] - E[x]^2 in float32 with XLA's CPU sums, so
bn1 alone errs 2.7e-5 against float64 and each stage doubles it, to
3.0e-3 at the head; the port (two-pass variance, torch's sums) reads
5.8e-4 there (``test_2d_net_on_visible_net_input_*``).  One step of each
package from the same weights reads: loss 3.2e-3 relative (joint 3.2e-3,
voxel 6.8e-7), new BatchNorm statistics 2.7e-3 of a tensor's max,
gradients 0.38 relative L2 (FeatureExtraction 0.76, UNet 0.34, 2D net
0.31), where the JAX step's own gradients move 0.07 when the measurement
moves by 1e-6.  The step's limits are about twice those readings: they
hold the wiring (which loss, which statistics, which parameters, the
optimizer).  The numerics are held by the step's parts, each well
inside its own error: the chain from the measurement to ``visible_net``'s
input, FeatureExtraction's and the UNet's gradients within 3e-2 (readings
9.2e-3, 9.9e-3); ``visible_net``'s backward within 1e-6; and the 2D net's
part of the step (2D net, joint loss) in float64 on both sides within
1e-5 (2.8e-6).  That last test also finds the amplifier: the 2D net in
training mode, whose gradients move about 8e4 times any relative move of
its input, in float64 as in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import Config, TrainConfig as JaxTrainConfig
from hiddenpose_tpu.models import posenet2d as jax_posenet2d
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from hiddenpose_tpu.train.state import TrainState as JaxTrainState
from hiddenpose_tpu.train.step import make_train_step as jax_make_train_step
from hiddenpose_tpu_torch.config import Config as PortConfig, TrainConfig
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models import posenet2d
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.jax_bridge import (
    from_jax,
    posenet2d_state_dict_from_jax,
    posenet2d_to_jax,
    state_dict_from_jax,
    to_jax,
)
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

STEP_SIZE = 64
LAYERS = (1, 1, 1, 1)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _rel_l2(a, b, keys):
    num = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2)
                      for k in keys))
    den = np.sqrt(sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys))
    return num / den


# -- flax "SAME" padding and visible_net -----------------------------------


@pytest.mark.parametrize("n", [7, 8, 31, 32, 33])
@pytest.mark.parametrize("k,s", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_same_conv_matches_flax(n, k, s):
    """SameConv2d against flax's ``nn.Conv(padding="SAME")`` on an even
    and an odd extent: the stride-2 convs pad (2, 3) / (0, 1) on an even
    extent, where symmetric padding would shift every output."""
    from flax import linen as nn

    rng = np.random.RandomState(n * 10 + k)
    x = rng.randn(2, 3, n, n + 1).astype(np.float32)
    conv = nn.Conv(4, (k, k), strides=(s, s), padding="SAME", use_bias=False)
    params = conv.init(jax.random.PRNGKey(0),
                       jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(conv.apply(params, jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    port = posenet2d.SameConv2d(3, 4, k, s)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            params["params"]["kernel"]).transpose(3, 2, 0, 1)))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(
        want).max())


def _tied_volume(seed, shape=(2, 3, 16, 6, 7)):
    """Values on a grid of 5 levels, half of them negative: after the
    ReLU most depth columns hold several exact zeros and repeated
    levels, so the depth channel reads which tied index ranks first."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-5, 5, shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [4, 2])
def test_visible_net_matches_jax_on_ties(seed, k):
    x = _tied_volume(seed)
    got = posenet2d.visible_net(torch.from_numpy(x), k).numpy()
    want = np.asarray(jax_posenet2d.visible_net(jnp.asarray(x), k))
    c = x.shape[1] * k
    assert got.shape == want.shape == (2, 2 * c, 6, 7)
    np.testing.assert_array_equal(got[:, c:], want[:, c:])  # depth: exact
    np.testing.assert_array_equal(got[:, :c], want[:, :c])
    # the ties are real: some column ranks two equal values
    vals = got[:, :c].reshape(2, x.shape[1], k, 6, 7)
    assert (vals[:, :, 0] == vals[:, :, 1]).any()


def test_visible_net_takes_the_lower_index_among_ties():
    """One column, all equal after the ReLU: ranks 0..k-1 are depths
    0..k-1, flipped: (D - 1 - i) / (D - 1)."""
    x = torch.full((1, 1, 8, 1, 1), -1.0)
    x[0, 0, 5] = 2.0
    out = posenet2d.visible_net(x, 4)[0, :, 0, 0]
    assert out[:4].tolist() == [1e5, 0.0, 0.0, 0.0]
    torch.testing.assert_close(out[4:], torch.tensor([2.0, 7.0, 6.0, 5.0])
                               / 7.0)


def _untied_volume(seed, shape=(2, 3, 16, 6, 7)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("make", [_tied_volume, _untied_volume],
                         ids=["tied", "untied"])
def test_visible_net_vjp_matches_jax(make, seed):
    """The backward of ``visible_net`` (the ReLU, the per-channel min/max
    of ``normalize``, the gathers of the top k) against ``jax.vjp`` of
    the JAX package's, within 1e-6 of the largest gradient (readings
    4.5e-8 to 2.1e-7).  On the tied volume each channel's maximum is
    held by dozens of voxels, so the test also holds the port to the JAX
    package's rule for a tie at the maximum: its variadic min/max reduce
    is differentiated through a halving tree whose every meeting of equal
    values splits 0.5 / 0.5; ``amax``'s even split over all the ties reads
    0.13-0.26 here."""
    x = make(seed)
    k = 4
    rng = np.random.RandomState(seed + 100)
    r = rng.randn(x.shape[0], 2 * x.shape[1] * k,
                  *x.shape[3:]).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_posenet2d.visible_net(v, k),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(r))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (posenet2d.visible_net(xt, k) * torch.from_numpy(r)).sum().backward()
    got = xt.grad.numpy()
    if make is _tied_volume:  # the maxima really tie
        flat = x.reshape(*x.shape[:2], -1)
        assert ((flat == flat.max(-1, keepdims=True)).sum(-1) > 1).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 7, 12, 1000, 4097])
def test_normalize_vjp_matches_jax_at_ties(n):
    """``normalize``'s backward against ``jax.vjp`` of the JAX package's,
    on values from 3 levels, so that both the minimum and the maximum tie
    many times, on odd and even lengths (the halving tree pads an odd
    half): within 1e-6 of the largest gradient."""
    from hiddenpose_tpu.ops.normalize import normalize as jax_normalize
    from hiddenpose_tpu_torch.ops.normalize import normalize

    rng = np.random.RandomState(n)
    x = rng.randint(0, 3, (2, 3, n)).astype(np.float32)
    x[:, :, 0] = 2.0  # every channel ties at its max when n > 2
    x[:, :, -1] = 0.0
    r = rng.randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_normalize, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(r))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (normalize(xt) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# -- ResPoseNet2D alone ------------------------------------------------------


def _net_pair(block, seed=1, joints=3, depth=4):
    port = posenet2d.ResPoseNet2D(8, num_joints=joints, depth_dim=depth,
                                  layers=LAYERS, block=block)
    sd = peaked_state_dict(port, seed)
    port.load_state_dict(sd)
    tree = {"params": posenet2d_to_jax(dict(port.named_parameters()),
                                       layers=LAYERS, block=block),
            "batch_stats": posenet2d_to_jax(dict(port.named_buffers()),
                                            "batch_stats", layers=LAYERS,
                                            block=block)}
    back = posenet2d_state_dict_from_jax(tree, layers=LAYERS, block=block)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[n], sd[n]) for n in sd)
    jmodel = jax_posenet2d.ResPoseNet2D(num_joints=joints, depth_dim=depth,
                                        layers=LAYERS, block=block)
    return port, jmodel, tree


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
@pytest.mark.parametrize("hw", [(64, 64), (33, 47)], ids=["even", "odd"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resposenet2d_matches_jax(block, hw, train):
    """Forward, new running statistics and (in training) the gradients
    of a random cotangent, at an even and an odd extent.  With oneDNN's
    CPU kernels on, the port's float32 gradients of the basic-block net at
    64 x 64 lie 5.3e-3 (relative L2) from both the JAX package's and the
    port's own float64 gradients, against 7e-6 with them off: the test
    runs them off, a CPU library's rounding (the GPU runs cuDNN).  The
    gradients are then held to 2e-2 relative L2: they read 4e-6 to 2e-5,
    but in the odd-extent bottleneck case 8.6e-3, where the two packages'
    float32 gradients agree within 1e-5 with oneDNN on and both lie 8.6e-3
    from float64: a near-tie (a max-pool window or a ReLU input within a
    rounding of its switch) that the rounding decides."""
    with torch.backends.mkldnn.flags(enabled=False):
        _resposenet2d_case(block, hw, train)


def _resposenet2d_case(block, hw, train):
    port, jmodel, tree = _net_pair(block)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, *hw).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    init = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), xj))
    assert _shapes(init) == _shapes(tree)

    want, mutated = jax.jit(lambda v, a: jmodel.apply(
        v, a, train=train, mutable=["batch_stats"]))(tree, xj)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    port.train(train)
    xt = torch.from_numpy(x).requires_grad_(train)
    got = port(xt)
    assert got.shape == want.shape
    tol = 1e-4 if train else 1e-5
    assert _rel(got.detach().numpy(), want) < tol
    if not train:
        return
    stats = _flat(posenet2d_to_jax(dict(port.named_buffers()), "batch_stats",
                                   layers=LAYERS, block=block))
    for k, v in _flat(mutated["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)

    r = rng.randn(*want.shape).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p, "batch_stats": tree["batch_stats"]},
                           xj, train=True, mutable=["batch_stats"])[0]
        return jnp.sum(out * jnp.asarray(r.transpose(0, 2, 3, 1)))

    gj = _flat(jax.jit(jax.grad(loss))(tree["params"]))
    (got * torch.from_numpy(r)).sum().backward()
    gp = _flat(posenet2d_to_jax({n: p.grad for n, p in
                                 port.named_parameters()}, layers=LAYERS,
                                block=block))
    assert gp.keys() == gj.keys()
    assert _rel_l2(gp, gj, gj) < 2e-2


# -- the posenet2d NlosPose ---------------------------------------------------


def _model_cfgs(size):
    jc = dataclasses.replace(Config().tiny(size).model, backbone="posenet2d")
    pc = dataclasses.replace(PortConfig().tiny(size).model,
                             backbone="posenet2d")
    return jc, pc


def _batch(size):
    _, m = _model_cfgs(size)
    return make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                      m.heatmap_size[0], m.bin_len)


@functools.lru_cache(maxsize=None)
def _weights(size, seed=1):
    """The port's peaked state_dict and the JAX variables it maps to."""
    _, pc = _model_cfgs(size)
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(pc)
    sd = peaked_state_dict(template, seed)
    named = {n: sd[n] for n, _ in template.named_parameters()}
    bufs = {n: sd[n] for n, _ in template.named_buffers()}
    return sd, {"params": to_jax(named),
                "batch_stats": to_jax(bufs, "batch_stats")}


def test_nlospose_posenet2d_tree_matches_flax_init():
    """The bridge's table: the same tree as flax's own init, name by name
    and shape by shape, and the round trip."""
    jc, _ = _model_cfgs(32)
    sd, tree = _weights(32)
    jmodel, jlct = jax_build(jc)
    init = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, 1, 32, 32, 32)), jlct))
    assert _shapes(init) == _shapes(tree)
    back = state_dict_from_jax(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[n], sd[n]) for n in sd)
    assert from_jax(tree["params"]).keys() == {
        n for n in sd if not n.endswith(("running_mean", "running_var",
                                         "num_batches_tracked"))}


def test_nlospose_posenet2d_forward_matches_jax():
    """The serving forward at tiny(32): heatmaps (B, J, 16, 8, 8), the
    JAX package's shape (not 16^3), within 1e-5 of the largest logit, and
    the soft-argmax joints, which must spread over the volume first."""
    jc, pc = _model_cfgs(32)
    sd, tree = _weights(32)
    meas = _batch(32)["meas"]
    jmodel, jlct = jax_build(jc)
    want_hm, want_ref = jax.jit(lambda v, m: jmodel.apply(v, m, jlct))(
        tree, jnp.asarray(meas))
    want_hm, want_ref = np.asarray(want_hm), np.asarray(want_ref)
    model, lct = build_nlospose(pc, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        hm, ref = model(torch.from_numpy(meas), lct)
    assert hm.shape == want_hm.shape == (2, 24, 16, 8, 8)
    assert _rel(ref.numpy(), want_ref) < 1e-4
    assert _rel(hm.numpy(), want_hm) < 1e-5
    joints = softmax_integral(hm, 24).reshape(2, 24, 3)
    want_j = softmax_integral(torch.from_numpy(want_hm), 24).reshape(2, 24, 3)
    assert float(joints.std(dim=1).min()) > 0.5  # the joints spread
    assert float((joints - want_j).abs().max()) < 1e-3


@pytest.fixture(scope="module")
def step_pair():
    """One ``make_train_step`` step of each package at tiny(64), from the
    same weights and batch."""
    jc, pc = _model_cfgs(STEP_SIZE)
    sd, tree = _weights(STEP_SIZE)
    batch = _batch(STEP_SIZE)
    jmodel, jlct = jax_build(jc)
    state = JaxTrainState.create(tree["params"], tree["batch_stats"],
                                 jax_make_optimizer(JaxTrainConfig()))
    step = jax_make_train_step(jmodel, donate=False,
                               matmul_precision="highest")
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jlct)
    adam = new.opt_state[0]
    jax_out = dict(metrics={k: float(v) for k, v in metrics.items()},
                   grads={k: v / np.float32(0.1)
                          for k, v in _flat(adam.mu).items()},
                   params=_flat(new.params), stats=_flat(new.batch_stats))

    model, lct = build_nlospose(pc, device="cpu")
    model.load_state_dict(sd)
    pstate = TrainState.create(model, TrainConfig())
    metrics = make_train_step(model)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, lct)
    named = dict(model.named_parameters())
    port_out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=_flat(to_jax({n: p.grad for n, p in named.items()})),
        params=_flat(to_jax(named)),
        stats=_flat(to_jax(dict(model.named_buffers()), "batch_stats")))
    return dict(jax=jax_out, port=port_out)


def _port_visible_input(size, meas):
    """The port's training forward at ``size`` from the peaked weights,
    with the volume that reaches ``visible_net`` (``feature + refine``)
    kept: (model, volume), the graph recorded."""
    import hiddenpose_tpu_torch.models.nlospose as port_nlospose

    _, pc = _model_cfgs(size)
    sd, _ = _weights(size)
    model, lct = build_nlospose(pc, device="cpu")
    model.load_state_dict(sd)
    seen = {}

    def spy(x, k=4):
        seen["volume"] = x
        return posenet2d.visible_net(x, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_nlospose, "visible_net", spy)
        model.train()(torch.from_numpy(meas), lct)
    return model, seen["volume"]


def test_2d_net_on_visible_net_input_port_is_nearer_float64():
    """Which side errs in the step below: at tiny(64) the 2D net in
    training mode on the model's own ``visible_net`` input, the port's
    float32 forward and the JAX package's against the port's float64
    forward of the same net and weights (no kernel runs there).  Readings:
    port 5.8e-4 of the largest logit, JAX 3.0e-3."""
    sd, tree = _weights(STEP_SIZE)
    _, volume = _port_visible_input(STEP_SIZE, _batch(STEP_SIZE)["meas"])
    with torch.no_grad():
        flat = posenet2d.visible_net(volume)
    net_sd = {n[len("pose_net."):]: v for n, v in sd.items()
              if n.startswith("pose_net.")}
    f32 = posenet2d.ResPoseNet2D(8, 24, STEP_SIZE // 2)
    f64 = posenet2d.ResPoseNet2D(8, 24, STEP_SIZE // 2).double()
    for net in (f32, f64):
        net.load_state_dict(net_sd)
        net.train()
    with torch.no_grad():
        got, want = f32(flat).numpy(), f64(flat.double()).numpy()
    jnet = jax_posenet2d.ResPoseNet2D(num_joints=24,
                                      depth_dim=STEP_SIZE // 2)
    jax_out = jax.jit(lambda v, a: jnet.apply(
        v, a, train=True, mutable=["batch_stats"])[0])(
        {"params": tree["params"]["pose_net"],
         "batch_stats": tree["batch_stats"]["pose_net"]},
        jnp.asarray(flat.numpy().transpose(0, 2, 3, 1)))
    jax_out = np.asarray(jax_out).transpose(0, 3, 1, 2)
    port_err, jax_err = _rel(got, want), _rel(jax_out, want)
    assert port_err < 2e-3
    assert jax_err < 1e-2
    assert port_err < jax_err


@pytest.fixture(scope="module")
def chain_pair():
    """The posenet2d NlosPose from the measurement to ``visible_net``'s
    input (FeatureExtraction, the LCT, ``normalize_feature``, the UNet,
    ``feature + refine``) in training mode at tiny(64), and the gradients
    of ``sum(volume * r)`` for one random ``r``: ``jax.vjp`` of the JAX
    package's modules, called in the order of its ``NlosPose.__call__``
    (``hiddenpose_tpu/models/nlospose.py:106-136``), against the port's
    autograd."""
    from hiddenpose_tpu.ops.lct import lct_apply as jax_lct_apply
    from hiddenpose_tpu.ops.normalize import normalize_feature_last

    def chain(m, meas, lct):
        b = meas.shape[0]
        x = m.feature_extraction(jnp.transpose(meas, (0, 2, 3, 4, 1)), True)
        ch = x.shape[-1]
        flat = jnp.transpose(x, (0, 4, 1, 2, 3)).reshape(b * ch,
                                                         *x.shape[1:4])
        vol = jax_lct_apply(flat, lct, batch_chunk=m.cfg.lct_batch_chunk)
        vol = vol.reshape(b, ch, *vol.shape[1:]).transpose(0, 2, 3, 4, 1)
        feature = normalize_feature_last(vol)
        refine = m.autoencoder(feature, True)
        return jnp.transpose(feature + refine, (0, 4, 1, 2, 3))

    jc, _ = _model_cfgs(STEP_SIZE)
    _, tree = _weights(STEP_SIZE)
    meas = _batch(STEP_SIZE)["meas"]
    jmodel, jlct = jax_build(jc)

    def run(params, m):
        return jmodel.apply({"params": params,
                             "batch_stats": tree["batch_stats"]}, m, jlct,
                            method=chain)

    meas_j = jnp.asarray(meas)
    shape = jax.eval_shape(run, tree["params"], meas_j).shape
    r = np.random.RandomState(5).randn(*shape).astype(np.float32)

    def volume_and_grads(params, m):
        volume, vjp = jax.vjp(run, params, m)
        return volume, vjp(jnp.asarray(r))[0]

    volume, grads = jax.jit(volume_and_grads)(tree["params"], meas_j)
    want = _flat(grads)

    model, got_volume = _port_visible_input(STEP_SIZE, meas)
    (got_volume * torch.from_numpy(r)).sum().backward()
    named = dict(model.named_parameters())
    reached = {n for n, p in named.items() if p.grad is not None}
    got = _flat(to_jax({n: p.grad if p.grad is not None
                        else torch.zeros_like(p) for n, p in named.items()}))
    return dict(volume=(got_volume.detach().numpy(), np.asarray(volume)),
                grads=(got, want), reached=reached)


def test_chain_to_visible_net_matches_jax(chain_pair):
    """The volume within 1e-4 of its largest value (reading 1.8e-5) and
    the gradients of FeatureExtraction and of the UNet each within 3e-2
    relative L2 (readings 9.2e-3 and 9.9e-3).  Both packages' float32
    gradients lie about this far from the truth: at tiny(32), against
    the JAX package's chain at float64 (``jax.enable_x64``,
    ``compute_dtype="float64"``; its LCT stays float32), the port reads
    3.8e-3 and 6.3e-3, the JAX package 3.9e-3 and 2.8e-3: the min/max
    normalisation's gradient gathers the whole volume's cotangent onto
    its two extreme voxels.  The 2D net, whose gradients are chaotic in
    training mode, is held on its own below; no pose_net gradient reaches
    this chain."""
    got_v, want_v = chain_pair["volume"]
    assert got_v.shape == want_v.shape
    assert _rel(got_v, want_v) < 1e-4
    got, want = chain_pair["grads"]
    for module in ("feature_extraction", "autoencoder"):
        keys = [k for k in want if k.startswith(f"['{module}']")]
        assert keys, module
        assert _rel_l2(got, want, keys) < 3e-2, module
    assert not any(n.startswith("pose_net.") for n in chain_pair["reached"])


@pytest.fixture(scope="module")
def net_step_pair():
    """The 2D net's part of the step in float64 on both sides: from the
    model's own ``visible_net`` output at tiny(64), ``ResPoseNet2D`` in
    training mode, heatmaps reshaped (B, J, 32, 16, 16) and the step's
    joint loss; the gradients of the loss in the parameters and the
    input, and the new batch statistics.  The JAX side runs under
    ``jax.enable_x64`` with ``dtype=float64``, the port's net after
    ``.double()``."""
    from hiddenpose_tpu.losses import l2_joint_location_loss as jax_joint_loss
    from hiddenpose_tpu_torch.losses import l2_joint_location_loss

    _, tree = _weights(STEP_SIZE)
    sd, _ = _weights(STEP_SIZE)
    batch = _batch(STEP_SIZE)
    _, volume = _port_visible_input(STEP_SIZE, batch["meas"])
    with torch.no_grad():
        flat = posenet2d.visible_net(volume).double()
    joints, vis = batch["joints"], batch["joints_vis"]
    depth = STEP_SIZE // 2

    net = posenet2d.ResPoseNet2D(8, 24, depth).double()
    net.load_state_dict({n[len("pose_net."):]: v for n, v in sd.items()
                         if n.startswith("pose_net.")})
    x = flat.clone().requires_grad_(True)
    hm = net.train()(x)
    b, _, h, w = hm.shape
    loss = l2_joint_location_loss(hm.reshape(b, 24, depth, h, w),
                                  torch.from_numpy(joints).double(),
                                  torch.from_numpy(vis).double())
    loss.backward()
    port = dict(
        loss=float(loss.detach()), input=x.grad.numpy(),
        grads=_flat(posenet2d_to_jax({n: p.grad for n, p in
                                      net.named_parameters()})),
        stats=_flat(posenet2d_to_jax(dict(net.named_buffers()),
                                     "batch_stats")))

    with jax.enable_x64(True):
        f64 = functools.partial(jnp.asarray, dtype=jnp.float64)
        jnet = jax_posenet2d.ResPoseNet2D(num_joints=24, depth_dim=depth,
                                          dtype=jnp.float64)
        stats = jax.tree_util.tree_map(f64, tree["batch_stats"]["pose_net"])

        def loss_fn(params, xj):
            out, mutated = jnet.apply(
                {"params": params, "batch_stats": stats}, xj, train=True,
                mutable=["batch_stats"])
            hm = jnp.transpose(out, (0, 3, 1, 2)).reshape(b, 24, depth, h, w)
            return (jax_joint_loss(hm, f64(joints), f64(vis)),
                    mutated["batch_stats"])

        (value, new_stats), (gp, gx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(f64, tree["params"]["pose_net"]),
            f64(flat.numpy().transpose(0, 2, 3, 1)))
        jx = dict(loss=float(value),
                  input=np.asarray(gx).transpose(0, 3, 1, 2),
                  grads=_flat(gp), stats=_flat(new_stats))
    return dict(port=port, jax=jx)


def test_2d_net_step_matches_jax_in_float64(net_step_pair):
    """In float64 the two packages' 2D-net steps agree: the loss within
    1e-6 relative (reading 2.8e-7), the parameter and input gradients
    within 1e-5 relative L2 (2.8e-6 and 2.7e-6), the new statistics
    within 2e-7 of each tensor's max (5.4e-8).  What is left is float32
    on both sides: each package's soft-argmax takes its softmax in
    float32, and the bridge hands the port's gradients and statistics
    over as float32.

    The step's float32 readings below are far wider because this net in
    training mode is the amplifier: in float64, with no top-k index or
    min/max voxel moving, a 1e-6 relative move of its input moves its
    heatmaps 2.8e-3 of their largest value and its parameter gradients
    0.08-0.13 relative L2; a 1e-12 move moves them 7.7e-8, so the gain
    (about 8e4) is the function's, not a rounding's."""
    port, jx = net_step_pair["port"], net_step_pair["jax"]
    assert np.isfinite(port["loss"])
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=1e-6)
    assert port["grads"].keys() == jx["grads"].keys()
    assert _rel_l2(port["grads"], jx["grads"], jx["grads"]) < 1e-5
    assert _rel_l2({"x": port["input"]}, {"x": jx["input"]}, ["x"]) < 1e-5
    assert port["stats"].keys() == jx["stats"].keys()
    for k, v in jx["stats"].items():
        np.testing.assert_allclose(port["stats"][k], v, rtol=0,
                                   atol=2e-7 * np.abs(v).max(), err_msg=k)


def test_step_losses_match(step_pair):
    """Readings: loss and joint loss 3.2e-3 relative, voxel loss 6.8e-7
    (the UNet's output does not pass the 2D net)."""
    got, want = step_pair["port"]["metrics"], step_pair["jax"]["metrics"]
    assert got.keys() == want.keys() == {"loss", "joint_loss", "voxel_loss"}
    for k in want:
        assert np.isfinite(got[k])
        tol = 1e-4 if k == "voxel_loss" else 1e-2
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


def test_step_batch_statistics_match(step_pair):
    """Reading 2.7e-3 of a tensor's max (the 2D net's; FeatureExtraction
    and the UNet have none)."""
    got, want = step_pair["port"]["stats"], step_pair["jax"]["stats"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-2 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_step_gradients_match(step_pair):
    """Readings: 0.38 relative L2 over all; FeatureExtraction 0.76, UNet
    0.34, the 2D net 0.31."""
    got, want = step_pair["port"]["grads"], step_pair["jax"]["grads"]
    assert got.keys() == want.keys()
    assert _rel_l2(got, want, want) < 0.8
    for module, tol in (("feature_extraction", 1.5), ("autoencoder", 0.7),
                        ("pose_net", 0.7)):
        keys = [k for k in want if k.startswith(f"['{module}']")]
        assert _rel_l2(got, want, keys) < tol, module


def test_step_new_params_match_where_gradients_agree(step_pair):
    """As ``test_torch_train_step.py``: where the two gradients agree
    within 25% and |g| >= 1e-5 the new parameters agree within 1e-6; and
    at least 90% of the large gradient elements have one sign (reading
0.966; 0.5 is chance)."""
    port, jx = step_pair["port"], step_pair["jax"]
    agree = total = 0
    for k, gj in jx["grads"].items():
        gp = port["grads"][k]
        close = (np.abs(gp - gj) <= 0.25 * np.abs(gj)) & (np.abs(gj) >= 1e-5)
        np.testing.assert_allclose(port["params"][k][close],
                                   jx["params"][k][close], rtol=0, atol=1e-6,
                                   err_msg=k)
        big = np.abs(gj) > 1e-2 * np.abs(gj).max()
        agree += int(((np.sign(gp) == np.sign(gj)) & big).sum())
        total += int(big.sum())
    assert agree >= 0.9 * total
