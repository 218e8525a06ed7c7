"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch and the port only (no jax), so on a GPU host it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and deliberately ragged (extents that are not multiples
of the kernels' tiles) so every masking branch runs.  Tolerance: both
sides are float32 with TF32 off; they differ only in summation order, so
errors are a few ulps of the output scale (1e-4 absolute and relative for
unit-scale outputs).  The pools' gradients route values: K8 is exact, and
K7 sums as the autograd of its plain chain does (powers-of-two weights,
two-term sums), so it is held exact too.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _t(rng, shape, dev, scale=1.0):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("residual,pre", [(False, None), (True, True),
                                          (False, False)])
def test_conv3_planes(dev, pad_mode, act, residual, pre):
    rng = np.random.RandomState(0)
    b, cin, cout, d, h, w = 2, 3, 5, 9, 13, 37
    x = _t(rng, (b, cin, d, h, w), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 0.2)
    bias = _t(rng, (cout,), dev, 0.1)
    res = _t(rng, (b, cout, d, h, w), dev) if residual else None
    ps = _t(rng, (cin,), dev) if pre is not None else None
    pt = _t(rng, (cin,), dev) if pre is not None else None
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre)
    n = K.conv3_planes.launches
    got = K.conv3_planes(x, k, bias, res, ps, pt, **kw)
    assert K.conv3_planes.launches == n + 1
    _close(got, K.conv3_planes_ref(x, k, bias, res, ps, pt, **kw))


@pytest.mark.parametrize("cin,cout", [(64, 16), (12, 4), (1, 1), (8, 20)])
def test_conv3_planes_channels(dev, cin, cout):
    rng = np.random.RandomState(1)
    x = _t(rng, (1, cin, 6, 10, 20), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    _close(K.conv3_planes(x, k, act="relu"),
           K.conv3_planes_ref(x, k, act="relu"))


@pytest.mark.parametrize("shape", [(1, 12, 20, 36), (2, 16, 16, 16)])
@pytest.mark.parametrize("relu", [True, False])
def test_stem_conv(dev, shape, relu):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(*shape, 1).astype(np.float32)).to(dev)
    k = _t(rng, (7, 7, 7, 1, 64), dev, 0.05)
    scale = torch.from_numpy(
        (rng.rand(64) + 0.5).astype(np.float32)).to(dev)
    shift = _t(rng, (64,), dev, 0.1)
    _close(K.stem_conv_raw(x, k, scale, shift, relu=relu),
           K.stem_conv_raw_ref(x, k, scale, shift, relu=relu))


@pytest.mark.parametrize("shape", [(1, 9, 10, 11, 64), (2, 16, 16, 16, 8)])
def test_maxpool_ties(dev, shape):
    """Post-ReLU data: many exact zeros, so windows tie; exact equality."""
    rng = np.random.RandomState(3)
    y = torch.clamp_min(_t(rng, shape, dev), 0.0)
    got = K.maxpool3d_k3s2p1(y)
    torch.cuda.synchronize()
    assert torch.equal(got, K.maxpool3d_k3s2p1_ref(y))


def test_maxpool_padding_never_wins(dev):
    """All-negative input: a zero-padded pool would return 0 at borders."""
    y = -1.0 - torch.rand((1, 5, 6, 7, 4), device=dev)
    got = K.maxpool3d_k3s2p1(y)
    torch.cuda.synchronize()
    assert (got < 0).all()
    assert torch.equal(got, K.maxpool3d_k3s2p1_ref(y))


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 64, 64), (2, 3, 5, 7, 128, 64),
                                   (1, 3, 4, 6, 256, 128)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3_mxu(dev, shape, epilogue):
    rng = np.random.RandomState(4)
    b, d, h, w, cin, cout = shape
    x = _t(rng, (b, d, h, w, cin), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    sc = _t(rng, (cout,), dev) if epilogue else None
    sh = _t(rng, (cout,), dev) if epilogue else None
    _close(K.conv3_mxu(x, k, sc, sh, relu=epilogue),
           K.conv3_mxu_ref(x, k, sc, sh, relu=epilogue))


def test_wrappers_reject_bad_input(dev):
    x = torch.zeros((1, 4, 4, 4, 64), device=dev)
    k = torch.zeros((3, 3, 3, 64, 64), device=dev)
    with pytest.raises(ValueError):
        K.conv3_mxu(x.transpose(1, 2), k)         # not contiguous
    with pytest.raises(TypeError):
        K.conv3_mxu(x.double(), k.double())       # not float32
    with pytest.raises(ValueError):
        K.conv3_mxu(x, k.cpu())                   # mixed devices


def _counted(wrapper, fn):
    n = wrapper.launches
    out = fn()
    assert wrapper.launches == n + 1
    return out


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 9, 13, 37), (1, 1, 1, 3, 3, 3),
                                   (1, 2, 3, 3, 4, 5), (1, 16, 8, 4, 8, 8),
                                   (2, 4, 4, 1, 2, 1)])
def test_conv3_planes_adjoint(dev, shape, pad_mode):
    rng = np.random.RandomState(5)
    b, cin, cout, d, h, w = shape
    dz = _t(rng, (b, cout, d, h, w), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 0.2)
    got = _counted(K.conv3_planes_adjoint, lambda: K.conv3_planes_adjoint(
        dz, k, pad_mode=pad_mode))
    _close(got, K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad_mode))


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(2, 1, 1, 9, 13, 37), (1, 8, 4, 6, 10, 20),
                                   (1, 2, 3, 3, 4, 5), (2, 32, 32, 4, 4, 4),
                                   (1, 64, 16, 2, 2, 2)])
@pytest.mark.parametrize("has_bias", [True, False])
def test_conv3_planes_wgrad(dev, shape, pad_mode, has_bias):
    rng = np.random.RandomState(6)
    b, cin, cout, d, h, w = shape
    x = _t(rng, (b, cin, d, h, w), dev)
    dz = _t(rng, (b, cout, d, h, w), dev)
    dk, db = _counted(K.conv3_planes_wgrad, lambda: K.conv3_planes_wgrad(
        x, dz, pad_mode=pad_mode, has_bias=has_bias))
    wk, wb = K.conv3_planes_wgrad_ref(x, dz, pad_mode=pad_mode,
                                      has_bias=has_bias)
    torch.cuda.synchronize()
    scale = wk.abs().max().item()
    torch.testing.assert_close(dk, wk, rtol=1e-4, atol=1e-5 * scale)
    if has_bias:
        torch.testing.assert_close(db, wb, rtol=1e-4,
                                   atol=1e-5 * wb.abs().max().item())
    else:
        assert db is None
    # a fixed summation order: the same call gives the same bits
    assert torch.equal(K.conv3_planes_wgrad(x, dz, pad_mode=pad_mode,
                                            has_bias=has_bias)[0], dk)


@pytest.mark.parametrize("shape", [(1, 9, 10, 11, 64), (2, 16, 16, 16, 8),
                                   (1, 1, 2, 3, 4)])
def test_maxpool_vjp_ties(dev, shape):
    rng = np.random.RandomState(7)
    y = torch.clamp_min(torch.round(_t(rng, shape, dev) * 4) / 4, 0.0)
    b, d, h, w, c = shape
    g = _t(rng, (b, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
           dev)
    got = _counted(K.maxpool3d_k3s2p1_vjp,
                   lambda: K.maxpool3d_k3s2p1_vjp(y, g))
    want = K.maxpool3d_k3s2p1_vjp_ref(y, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["random", "ties", "all_ties"])
@pytest.mark.parametrize("shape", [(2, 4, 8, 10, 12), (1, 3, 5, 7, 9)])
def test_max_pool2_bwd(dev, shape, kind):
    rng = np.random.RandomState(8)
    x = _t(rng, shape, dev)
    if kind == "ties":
        x = torch.round(x)
    elif kind == "all_ties":
        x = torch.zeros_like(x)
    dy = _t(rng, (*shape[:2], *(s // 2 for s in shape[2:])), dev)
    got = _counted(K.max_pool2_bwd, lambda: K.max_pool2_bwd(x, dy))
    want = K.max_pool2_bwd_ref(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,n", [(64, 9), (128, 6), (256, 4)])
def test_conv3_mxu_dx(dev, c, n):
    rng = np.random.RandomState(9)
    dz = _t(rng, (2, n, n + 1, n + 2, c), dev)
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    got = _counted(K.conv3_mxu_dx, lambda: K.conv3_mxu_dx(dz, k))
    _close(got, K.conv3_mxu_dx_ref(dz, k))


def _grads(fn, inputs, g):
    out = fn(*inputs)
    assert out.grad_fn is not None  # the kernel's output stays in the graph
    grads = torch.autograd.grad(out, [t for t in inputs if t is not None], g)
    return out.detach(), grads


def test_functions_keep_the_graph_on_the_gpu(dev):
    """Repair: on a CUDA tensor each Function's output has a grad_fn and
    its backward launches the backward kernels; the gradients equal the
    plain versions' autograd."""
    rng = np.random.RandomState(10)
    x = _t(rng, (2, 3, 5, 9, 13), dev).requires_grad_()
    k = _t(rng, (3, 3, 3, 3, 4), dev, 0.2).requires_grad_()
    bias = _t(rng, (4,), dev).requires_grad_()
    res = _t(rng, (2, 4, 5, 9, 13), dev).requires_grad_()
    g = _t(rng, (2, 4, 5, 9, 13), dev)
    n_adj, n_wg = K.conv3_planes_adjoint.launches, K.conv3_planes_wgrad.launches
    for act in ("none", "relu", "leaky"):
        kw = dict(act=act, pad_mode="edge")
        out, got = _grads(lambda *a: K.conv3_planes_diff(*a, **kw),
                          [x, k, bias, res], g)
        want_out, want = _grads(lambda *a: K.conv3_planes_ref(*a, **kw),
                                [x, k, bias, res], g)
        _close(out, want_out)
        for a, w in zip(got, want):
            _close(a, w)
    assert K.conv3_planes_adjoint.launches == n_adj + 3
    assert K.conv3_planes_wgrad.launches == n_wg + 3

    xm = _t(rng, (1, 4, 5, 6, 64), dev).requires_grad_()
    km = _t(rng, (3, 3, 3, 64, 64), dev, 0.05).requires_grad_()
    gm = _t(rng, (1, 4, 5, 6, 64), dev)
    out, got = _grads(K.conv3_mxu_diff, [xm, km], gm)
    want_out, want = _grads(K.conv3_mxu_ref, [xm, km], gm)
    _close(out, want_out)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-3)

    y = torch.clamp_min(_t(rng, (2, 6, 7, 8, 8), dev), 0.0).requires_grad_()
    gy = _t(rng, (2, 3, 4, 4, 8), dev)
    out, got = _grads(K.maxpool3d_k3s2p1_diff, [y], gy)
    want_out, want = _grads(K.maxpool3d_k3s2p1_ref, [y], gy)
    assert torch.equal(out, want_out) and torch.equal(got[0], want[0])

    xp = torch.round(_t(rng, (2, 3, 4, 6, 8), dev)).requires_grad_()
    gp = _t(rng, (2, 3, 2, 3, 4), dev)
    out, got = _grads(K.max_pool2_diff, [xp], gp)
    want_out, want = _grads(lambda v: F.max_pool3d(v, 2), [xp], gp)
    assert torch.equal(out, want_out) and torch.equal(got[0], want[0])


def test_train_step_on_the_gpu_reaches_every_weight(dev):
    """One tiny train step on the GPU: the loss is finite, every kernel of
    the train path launched, and every parameter got a gradient (with the
    kernels' outputs cut off from autograd, the FeatureExtraction, UNet and
    K4 weights would get none)."""
    from hiddenpose_tpu_torch.config import TrainConfig, default_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    m = default_config().tiny(32).model
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(peaked_state_dict(model, 1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    state = TrainState.create(model, TrainConfig())
    K.reset_launch_counts()
    metrics = make_train_step(model)(state, batch, lct)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert torch.isfinite(metrics["loss"])
    assert all(counts[k] > 0 for k in K.TRAINING), counts
    assert counts["stem_conv_raw"] == 0
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing
