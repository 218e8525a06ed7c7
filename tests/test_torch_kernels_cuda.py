"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch and the port only (no jax), so on a GPU host it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and deliberately ragged (extents that are not multiples
of the kernels' tiles) so every masking branch runs.  Tolerance: both
sides are float32 with TF32 off; they differ only in summation order, so
errors are a few ulps of the output scale (1e-4 absolute and relative for
unit-scale outputs).  K4 and K4-dx multiply in three TF32 passes on the
tensor cores: they are also held against a float64 conv, where they may
err at most twice as much as the plain f32 version.  The pools' gradients route values: K8 is exact, and
K7 sums as the autograd of its plain chain does (powers-of-two weights,
two-term sums), so it is held exact too.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops import kernels as K
from hiddenpose_tpu_torch.ops.kernels import conv3mxu, conv3p

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


def _stem_inputs(rng, shape, dev):
    x = torch.from_numpy(rng.rand(*shape, 1).astype(np.float32)).to(dev)
    k = _t(rng, (7, 7, 7, 1, 64), dev, 0.05)
    scale = torch.from_numpy(
        (rng.rand(64) + 0.5).astype(np.float32)).to(dev)
    shift = _t(rng, (64,), dev, 0.1)
    return x, k, scale, shift


# extents that the kernel's 8 x 16 tiles and 32-plane work units do not
# divide, down to volumes smaller than one tile
@pytest.mark.parametrize("shape", [(1, 12, 20, 36), (2, 16, 16, 16),
                                   (1, 5, 6, 7), (1, 9, 17, 33),
                                   (2, 40, 9, 23), (1, 1, 1, 1)])
@pytest.mark.parametrize("relu", [True, False])
def test_stem_conv(dev, shape, relu):
    rng = np.random.RandomState(2)
    x, k, scale, shift = _stem_inputs(rng, shape, dev)
    n = K.stem_conv_raw.launches
    got = K.stem_conv_raw(x, k, scale, shift, relu=relu)
    assert K.stem_conv_raw.launches == n + 1
    _close(got, K.stem_conv_raw_ref(x, k, scale, shift, relu=relu))


def test_stem_conv_against_float64_and_repeats(dev):
    """Three TF32 passes, f32 sums a kd at a time: at most twice the plain
    f32 conv's error against float64 (or one f32 ulp of the output's max),
    two calls bit for bit, and the weight operand bit for bit the plain
    version's."""
    from hiddenpose_tpu_torch.ops.kernels import stem_conv

    rng = np.random.RandomState(12)
    x, k, scale, shift = _stem_inputs(rng, (2, 24, 20, 40), dev)
    k = k / 0.05 * 343 ** -0.5
    got = K.stem_conv_raw(x, k, scale, shift, relu=False)
    again = K.stem_conv_raw(x, k, scale, shift, relu=False)
    want = K.stem_conv_raw_ref(x, k, scale, shift, relu=False)
    want64 = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                      k.double().permute(4, 3, 0, 1, 2), padding=3)
    want64 = want64.permute(0, 2, 3, 4, 1) * scale.double() + shift.double()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.double() - want64).abs().max().item()
    err_plain = (want.double() - want64).abs().max().item()
    assert err <= max(2 * err_plain,
                      2.0 ** -23 * want64.abs().max().item()), (err, err_plain)
    assert torch.equal(stem_conv.prepare_weights(k),
                       stem_conv.prepare_weights_ref(k.cpu()).to(dev))


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


# K1 / K5's tile walk (b, cin, cout, d, h, w): each tile width (W <= 8,
# <= 16, wider), each channel block (C_out 1, 2-4 and 12, 5-8 and 16),
# D = 1, H below a tile's rows, W off a multiple of 4 (the 4-byte copy
# path) and on one with a ragged last tile, B = 1 and 2, input channels
# in several staged groups (64 channels) and split over thread groups
# (wide channels on small volumes).
TILE_SHAPES = [
    (1, 3, 5, 1, 9, 20), (2, 4, 4, 6, 5, 40), (1, 2, 3, 5, 9, 13),
    (1, 1, 1, 7, 12, 36), (2, 1, 4, 4, 40, 44), (1, 20, 12, 9, 17, 33),
    (1, 32, 16, 8, 8, 8), (2, 16, 32, 4, 16, 16), (1, 64, 8, 6, 16, 48),
    (1, 8, 1, 3, 7, 6), (1, 5, 7, 2, 3, 70), (2, 4, 16, 1, 1, 1),
]


def _tile_case(rng, shape, dev):
    b, cin, cout, d, h, w = shape
    return (_t(rng, (b, cin, d, h, w), dev),
            _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin)),
            _t(rng, (cout,), dev, 0.1), _t(rng, (b, cout, d, h, w), dev))


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_conv3_planes_tile_walk(dev, shape, pad_mode):
    """K1 over every branch of the tile walk, with residual and leaky, and
    a second call bit for bit."""
    x, k, bias, res = _tile_case(np.random.RandomState(20), shape, dev)
    kw = dict(act="leaky", pad_mode=pad_mode)
    got = K.conv3_planes(x, k, bias, res, **kw)
    _close(got, K.conv3_planes_ref(x, k, bias, res, **kw))
    assert torch.equal(got, K.conv3_planes(x, k, bias, res, **kw))


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_conv3_planes_adjoint_tile_walk(dev, shape, pad_mode):
    """K5 likewise; under edge padding every tile of these small volumes
    touches a face, and the first and last plane fold along D."""
    _, k, _, dz = _tile_case(np.random.RandomState(21), shape, dev)
    got = K.conv3_planes_adjoint(dz, k, pad_mode=pad_mode)
    _close(got, K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad_mode))
    assert torch.equal(got, K.conv3_planes_adjoint(dz, k, pad_mode=pad_mode))


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("cout", [1, 4, 8])
def test_conv3_planes_adjoint_interior_tiles(dev, cout, pad_mode):
    """A plane of 3 x 3 tiles of K5: the middle one takes the compile-time
    taps under edge padding too, the other eight the face path."""
    rng = np.random.RandomState(22)
    dz = _t(rng, (1, cout, 5, 48, 96), dev)
    k = _t(rng, (3, 3, 3, 2, cout), dev, 0.2)
    plan = conv3p.tile_plan(1, cout, 2, 5, 48, 96)
    assert not conv3p.tile_is_face(plan, plan.th, plan.tw, 48, 96)
    _close(K.conv3_planes_adjoint(dz, k, pad_mode=pad_mode),
           K.conv3_planes_adjoint_ref(dz, k, pad_mode=pad_mode))


@pytest.mark.parametrize("name,value", [
    ("TILE_BLOCKS", 1 << 20),       # one plane and one thread row a block
    ("TILE_BLOCKS_LONG", 1),        # all of D in one block
    ("TILE_MAX_THREADS", 32),      # one warp a block: at most 2 splits
    ("TILE_SM_THREADS", 1 << 20),   # as many splits as fit
    ("TILE_SLOT_BYTES", 2048),      # few channels a staged unit
])
@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
def test_conv3_planes_under_other_plans(dev, monkeypatch, name, value,
                                        pad_mode):
    """The kernel takes whatever plan the constants give: D chunks of 1
    and of all of D, splits from 1 to 8, channel groups of 1."""
    monkeypatch.setattr(conv3p, name, value)
    conv3p.tile_plan.cache_clear()
    try:
        rng = np.random.RandomState(23)
        for shape in [(2, 3, 5, 9, 13, 37), (1, 16, 8, 12, 16, 16)]:
            x, k, bias, res = _tile_case(rng, shape, dev)
            kw = dict(act="relu", pad_mode=pad_mode)
            _close(K.conv3_planes(x, k, bias, res, **kw),
                   K.conv3_planes_ref(x, k, bias, res, **kw))
            _close(K.conv3_planes_adjoint(res, k, pad_mode=pad_mode),
                   K.conv3_planes_adjoint_ref(res, k, pad_mode=pad_mode))
    finally:
        conv3p.tile_plan.cache_clear()


def test_conv3_planes_pre_affine_whole_volume(dev):
    """The pre-affine (+ ReLU) precedes the zero padding: the border
    voxels see 0, not pre(0), in every tile of a ragged volume."""
    rng = np.random.RandomState(24)
    x, k, bias, res = _tile_case(rng, (1, 3, 5, 9, 17, 33), dev)
    ps, pt = _t(rng, (3,), dev), _t(rng, (3,), dev) + 1.0
    kw = dict(act="none", pad_mode="zero", pre_relu=True)
    _close(K.conv3_planes(x, k, bias, res, ps, pt, **kw),
           K.conv3_planes_ref(x, k, bias, res, ps, pt, **kw))


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


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("shape", [
    (2, 3, 5, 5, 6, 7),      # ragged, C_out not a multiple of the 4-wide
    (1, 5, 6, 4, 9, 17),     # register tile, C_in not one of the groups
    (2, 1, 1, 9, 10, 40),    # W % 4 == 0 with a ragged last tile
    (1, 2, 1, 5, 9, 33),     # rows that are not 16-byte aligned
    (2, 4, 4, 8, 16, 64),    # two tiles along W, 16-byte copies
    (1, 16, 8, 16, 16, 16), (2, 32, 32, 8, 8, 8)])
def test_conv3_planes_wgrad_tiles_and_channel_groups(dev, shape, pad_mode):
    """K6's tile widths (32, 16, 8), channel groups, both copy widths and
    the ragged last tile with edge padding (the halo column past W - 1):
    within 1e-5 of the max of the plain version, within twice its error
    against float64, and two calls bit for bit."""
    rng = np.random.RandomState(sum(shape))
    b, cin, cout, d, h, w = shape
    x = _t(rng, (b, cin, d, h, w), dev)
    dz = _t(rng, (b, cout, d, h, w), dev)
    got = K.conv3_planes_wgrad(x, dz, pad_mode=pad_mode)
    again = K.conv3_planes_wgrad(x, dz, pad_mode=pad_mode)
    want = K.conv3_planes_wgrad_ref(x, dz, pad_mode=pad_mode)
    # dk in float64, one product per tap
    xp = F.pad(x.double(), (1,) * 6,
               mode="replicate" if pad_mode == "edge" else "constant")
    dk64 = torch.stack([torch.einsum(
        "bin,bon->io", xp[:, :, i:i + d, j:j + h, k:k + w].flatten(2),
        dz.double().flatten(2))
        for i in range(3) for j in range(3) for k in range(3)])
    dk64 = dk64.view(3, 3, 3, cin, cout)
    torch.cuda.synchronize()
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        assert (g_ - w_).abs().max().item() <= 1e-5 * w_.abs().max().item()
    assert (got[0] - dk64).abs().max().item() <= max(
        2 * (want[0] - dk64).abs().max().item(),
        2.0 ** -23 * dk64.abs().max().item())


@pytest.mark.parametrize("shape", [
    (2, 5, 6, 7, 4),        # ragged, one float4 of channels: half a group
    (1, 7, 20, 18, 64),     # tiles that do not divide H and W
    (1, 33, 16, 16, 12),    # an odd depth, three float4s: a ragged group
    (2, 40, 36, 34, 8)])    # several runs of depth windows
def test_maxpool_vjp_tiles_halos_and_depth_runs(dev, shape):
    """K7's tiles (16 x 16 input columns, two float4s of channels, runs of
    depth windows) on extents no tile divides, post-ReLU ties: exact, and
    two calls bit for bit."""
    rng = np.random.RandomState(sum(shape))
    y = torch.clamp_min(torch.round(_t(rng, shape, dev) * 2) / 2, 0.0)
    b, d, h, w, c = shape
    g = _t(rng, (b, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
           dev)
    got = K.maxpool3d_k3s2p1_vjp(y, g)
    again = K.maxpool3d_k3s2p1_vjp(y, g)
    want = K.maxpool3d_k3s2p1_vjp_ref(y, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert float(want.abs().sum()) > 0


def test_maxpool_vjp_negative_input_and_all_ties(dev):
    """All-negative input (padding must never win a window) and a constant
    input (every window a three-way tie on each axis)."""
    for y in (-1.0 - torch.rand((1, 5, 6, 7, 8), device=dev),
              torch.ones((1, 6, 5, 9, 4), device=dev)):
        g = torch.randn((1, *((n - 1) // 2 + 1 for n in y.shape[1:4]),
                         y.shape[4]), device=dev)
        got = K.maxpool3d_k3s2p1_vjp(y, g)
        torch.cuda.synchronize()
        assert torch.equal(got, K.maxpool3d_k3s2p1_vjp_ref(y, g))


def test_stem_conv_diff_on_the_gpu(dev):
    """The stem conv's matrix-product backward against the library's conv
    backward on the GPU, NCDHW and channels-last cotangents, and two calls
    bit for bit under deterministic algorithms."""
    from hiddenpose_tpu_torch.ops.stem_vjp import stem_conv_diff

    rng = np.random.RandomState(11)
    x = _t(rng, (2, 1, 9, 12, 16), dev).requires_grad_()
    w = _t(rng, (16, 1, 7, 7, 7), dev, 0.05).requires_grad_()
    g = _t(rng, (2, 16, 9, 12, 16), dev)
    want = torch.autograd.grad(F.conv3d(x, w, padding=3), (x, w), g)
    for ct in (g, g.contiguous(memory_format=torch.channels_last_3d)):
        got = torch.autograd.grad(stem_conv_diff(x, w), (x, w), ct)
        again = torch.autograd.grad(stem_conv_diff(x, w), (x, w), ct)
        torch.cuda.synchronize()
        for a, a2, b in zip(got, again, want):
            assert torch.equal(a, a2)
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("kind", ["random", "ties", "all_ties", "nan"])
@pytest.mark.parametrize("shape", [(2, 4, 8, 10, 12), (1, 3, 5, 7, 9),
                                   (2, 2, 7, 8, 10), (1, 2, 8, 9, 10),
                                   (1, 2, 8, 10, 11), (3, 1, 3, 2, 3)])
def test_max_pool2_bwd(dev, shape, kind):
    """Exact against the library's backward: odd extents on each axis (the
    uncovered voxels get 0), ties (the first maximum takes dy), NaNs (a
    later NaN wins)."""
    rng = np.random.RandomState(8)
    x = _t(rng, shape, dev)
    if kind == "ties":
        x = torch.round(x)
    elif kind == "all_ties":
        x = torch.zeros_like(x)
    elif kind == "nan":
        x = torch.where(torch.from_numpy(rng.rand(*shape) < 0.1).to(dev),
                        float("nan"), torch.round(x))
    dy = _t(rng, (*shape[:2], *(s // 2 for s in shape[2:])), dev)
    got = _counted(K.max_pool2_bwd, lambda: K.max_pool2_bwd(x, dy))
    want = K.max_pool2_bwd_ref(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_max_pool2_bwd_at_128(dev):
    """The UNet's largest pool, (2, 4, 128^3), post-ReLU ties: exact, and
    two calls bit for bit."""
    rng = np.random.RandomState(13)
    x = torch.relu(_t(rng, (2, 4, 128, 128, 128), dev))
    dy = _t(rng, (2, 4, 64, 64, 64), dev)
    got = K.max_pool2_bwd(x, dy)
    again = K.max_pool2_bwd(x, dy)
    want = K.max_pool2_bwd_ref(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("c,n", [(64, 9), (128, 6), (256, 4)])
def test_conv3_mxu_dx(dev, c, n):
    rng = np.random.RandomState(9)
    dz = _t(rng, (2, n, n + 1, n + 2, c), dev)
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    got = _counted(K.conv3_mxu_dx, lambda: K.conv3_mxu_dx(dz, k))
    _close(got, K.conv3_mxu_dx_ref(dz, k))


def _conv64(x, k):
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                 k.double().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1)


# the three shapes of the t128 batch-2 path, batch 1 of the first, and the
# ragged volumes no tile divides: (B, D, H, W, C)
K4_CASES = [(2, 64, 64, 64, 64), (2, 32, 32, 32, 128), (2, 16, 16, 16, 256),
            (1, 64, 64, 64, 64), (1, 5, 6, 7, 64), (1, 5, 6, 7, 128)]


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("shape", K4_CASES)
def test_conv3_mxu_3xtf32_against_both_references(dev, shape, epilogue):
    """K4 (three TF32 passes) against its plain f32 version, against the
    plain PyTorch emulation of its arithmetic, and against float64, where
    it may err at most twice as much as the plain f32 version (one TF32
    pass would err about 100 times as much)."""
    rng = np.random.RandomState(11)
    c = shape[4]
    x = _t(rng, shape, dev)
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    sc = _t(rng, (c,), dev).abs() + 0.5 if epilogue else None
    sh = _t(rng, (c,), dev, 0.1) if epilogue else None
    got = _counted(K.conv3_mxu,
                   lambda: K.conv3_mxu(x, k, sc, sh, relu=epilogue))
    torch.cuda.synchronize()
    want = K.conv3_mxu_ref(x, k, sc, sh, relu=epilogue)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * top
    emu = conv3mxu.conv3_mxu_3xtf32_ref(x, k, sc, sh, relu=epilogue)
    assert (got - emu).abs().max().item() <= 1e-5 * top
    want64 = _conv64(x, k)
    if epilogue:
        want64 = torch.clamp_min(want64 * sc.double() + sh.double(), 0.0)
    err, err_plain = ((t.double() - want64).abs().max().item()
                      for t in (got, want))
    assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("shape", K4_CASES)
def test_conv3_mxu_dx_3xtf32_against_both_references(dev, shape):
    rng = np.random.RandomState(12)
    c = shape[4]
    dz = _t(rng, shape, dev)
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    got = _counted(K.conv3_mxu_dx, lambda: K.conv3_mxu_dx(dz, k))
    torch.cuda.synchronize()
    want = K.conv3_mxu_dx_ref(dz, k)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * top
    kt = conv3mxu.flip_swap(k)
    emu = conv3mxu.conv3_mxu_3xtf32_ref(dz, kt)
    assert (got - emu).abs().max().item() <= 1e-5 * top
    want64 = _conv64(dz, kt)
    err, err_plain = ((t.double() - want64).abs().max().item()
                      for t in (got, want))
    assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("cin,cout", [(64, 128), (16, 64), (256, 256)])
def test_conv3_mxu_rectangular_channels(dev, cin, cout):
    """C_in != C_out, and C_in of one 16-deep k-slice a tap: forward, and
    dx through the transposed weight preparation."""
    rng = np.random.RandomState(13)
    x = _t(rng, (1, 4, 5, 9, cin), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    want = K.conv3_mxu_ref(x, k)
    got = K.conv3_mxu(x, k)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    if conv3mxu.conv3mxu_supported(cout, cin):
        dz = _t(rng, (1, 4, 5, 9, cout), dev)
        want = K.conv3_mxu_dx_ref(dz, k)
        got = K.conv3_mxu_dx(dz, k)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (256, 256)])
def test_weight_preparation_kernel_is_the_plain_version(dev, cin, cout,
                                                        transposed):
    rng = np.random.RandomState(14)
    k = _t(rng, (3, 3, 3, cin, cout), dev)
    got = conv3mxu.prepare_weights(k, transposed)
    torch.cuda.synchronize()
    assert torch.equal(got, conv3mxu.prepare_weights_ref(k, transposed))


@pytest.mark.parametrize("c", [64, 128])
def test_conv3_mxu_function_gradients(dev, c):
    """``Conv3Mxu``: dx through the kernel, dk through the library, both
    against plain autograd of the plain conv."""
    rng = np.random.RandomState(15)
    x = _t(rng, (2, 5, 6, 7, c), dev).requires_grad_()
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c)).requires_grad_()
    g = _t(rng, (2, 5, 6, 7, c), dev)
    n_fwd, n_dx = K.conv3_mxu.launches, K.conv3_mxu_dx.launches
    out, got = _grads(K.conv3_mxu_diff, [x, k], g)
    assert (K.conv3_mxu.launches, K.conv3_mxu_dx.launches) == (n_fwd + 1,
                                                               n_dx + 1)
    want_out, want = _grads(K.conv3_mxu_ref, [x, k], g)
    for a, w in [(out, want_out), *zip(got, want)]:
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()


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


# -- K9: the fused grouped attention --------------------------------------

# the ragged shapes of tests/test_attn_vmem.py, the TimeSformer's grouping
# (many groups, Lk = f + 1), and head dims through every template variant
ATTEND_SHAPES = [(3, 64, 80, 32), (2, 256, 131, 32), (1, 128, 1048, 32),
                 (2, 24, 640, 64), (512, 16, 17, 64), (2, 33, 70, 8),
                 (2, 33, 70, 16), (2, 33, 70, 24), (1, 50, 90, 128),
                 (1, 50, 90, 256), (1, 7, 5, 4)]


def _qkv(rng, shape, dev, q_scale=None):
    b, lq, lk, dh = shape
    q = _t(rng, (b, lq, dh), dev, dh ** -0.5 if q_scale is None else q_scale)
    return q, _t(rng, (b, lk, dh), dev), _t(rng, (b, lk, dh), dev)


@pytest.mark.parametrize("shape", ATTEND_SHAPES)
def test_attend_f32(dev, shape):
    """Three TF32 passes on the tensor cores (head dim 32) or f32 FMA in the
    kernel, f32 bmm (TF32 off) in the plain version: they differ in
    summation order and in the online softmax's rescaling."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(np.random.RandomState(11), shape, dev)
    got = _counted(K.attend, lambda: K.attend(q, k, v))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, K.attend_ref(q, k, v), rtol=1e-5,
                               atol=2e-6)


def test_attend_extreme_logits(dev):
    q, k, v = _qkv(np.random.RandomState(12), (1, 8, 136, 8), dev, 50.0)
    got = K.attend(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, K.attend_ref(q, k, v), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("qk_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 200, 32), (2, 24, 640, 64)])
def test_attend_bf16_v(dev, shape, qk_dtype):
    q, k, v = _qkv(np.random.RandomState(13), shape, dev)
    q, k, v = q.to(qk_dtype), k.to(qk_dtype), v.bfloat16()
    got = K.attend(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # both round the output to bf16: one ulp, at most 2^-7 of the value;
    # near zero the differently rounded probabilities weigh more (~2e-4)
    torch.testing.assert_close(got.float(), K.attend_ref(q, k, v).float(),
                               rtol=2.0 ** -7, atol=1e-3)


# The three dtype pairs at ragged Lq and Lk, head dims on the tensor-core
# form (32) and on the SIMT form, and few rows against long ragged keys,
# which the kernel splits over the keys.
ATTEND_PAIRS = [(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16)]
ATTEND_RAGGED = [(2, 77, 203, 8), (2, 77, 203, 32), (3, 130, 333, 32),
                 (2, 77, 203, 64), (1, 77, 203, 128),
                 (2, 1, 4099, 32), (2, 24, 9001, 32), (1, 130, 5003, 32),
                 (2, 24, 9001, 64)]


@pytest.mark.parametrize("dtypes", ATTEND_PAIRS)
@pytest.mark.parametrize("shape", ATTEND_RAGGED)
def test_attend_ragged_all_dtype_pairs_repeat_bit_for_bit(dev, shape, dtypes):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(np.random.RandomState(18), shape, dev)
    q, k, v = q.to(dtypes[0]), k.to(dtypes[0]), v.to(dtypes[1])
    got = K.attend(q, k, v)
    again = K.attend(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtypes[1] and torch.equal(got, again)
    want = K.attend_ref(q, k, v)
    if dtypes[1] == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    else:
        # one bf16 ulp of the output, and near zero the two versions'
        # probabilities, each rounded to bf16 on its own (2^-9 relative):
        # a few sigma of sqrt(Lk) such terms, about 1e-3 at 200 keys
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=2e-3)


@pytest.mark.parametrize("qk_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 130, 333, 32), (2, 24, 9001, 32)])
def test_attend_bf16_v_rounds_in_its_online_order(dev, shape, qk_dtype):
    """With a bf16 v the tensor-core form (head dim 32) rounds the
    unnormalised probability against its running max; ``attend_online_ref``
    on the kernel's chunks (``attend_chunk``; the second shape is split
    over the keys) rounds at the same points: the outputs are equal at 99%
    of the elements at least, the rest within one bf16 ulp (float32
    rounding, the sums' order and ex2.approx, flips a few)."""
    from hiddenpose_tpu_torch.ops.kernels import attn

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(np.random.RandomState(20), shape, dev)
    q, k, v = q.to(qk_dtype), k.to(qk_dtype), v.bfloat16()
    b, lq, lk, dh = shape
    got = K.attend(q, k, v)
    want = attn.attend_online_ref(q, k, v, attn.attend_chunk(b, lq, lk, dh))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    equal = (got == want).float().mean().item()
    assert equal >= 0.99, equal


@pytest.mark.parametrize("shape", [(2, 130, 333, 32), (2, 24, 9001, 32),
                                   (2, 77, 203, 64)])
def test_attend_f32_against_float64(dev, shape):
    """The kernel errs against a float64 attention at most twice as much
    as the plain f32 version (one TF32 pass would read a hundred times)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(np.random.RandomState(19), shape, dev)
    want = torch.softmax(q.double() @ k.double().transpose(1, 2), -1) \
        @ v.double()
    err = (K.attend(q, k, v).double() - want).abs().max().item()
    plain = (K.attend_ref(q, k, v).double() - want).abs().max().item()
    assert err <= 2 * plain, (err, plain)


def test_attend_function_keeps_the_graph(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(
        np.random.RandomState(14), (2, 16, 40, 16), dev))
    g = _t(np.random.RandomState(15), (2, 16, 16), dev)
    n = K.attend.launches
    out, got = _grads(K.attend_diff, [q, k, v], g)
    assert K.attend.launches == n + 1
    want_out, want = _grads(K.attend_ref, [q, k, v], g)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=2e-6)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="attend_diff"):
        K.attend(q, k, v)


def test_sformer_on_the_gpu_runs_the_kernel(dev):
    """A tiny Sformer on the GPU: the grouped attention launches K9 once a
    layer (the joint read too at this size), kernels and plain agree."""
    from hiddenpose_tpu_torch.models.sformer import NlosPoseSformer
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = NlosPoseSformer(dim=32, num_frames=2, num_joints=4, image_size=16,
                            patch_size=4, depth=2, heads=2, dim_head=8,
                            out_dim=32).eval()
    model.load_state_dict(peaked_transformer_state_dict(model, 1))
    model.to(dev)
    video = torch.rand((2, 2, 1, 16, 16), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    n = K.attend.launches
    with torch.no_grad():
        got = model(video)
        assert K.attend.launches == n + 4
        model.set_use_kernels(False)
        want = model(video)
        assert K.attend.launches == n + 4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _time_attention_models():
    from hiddenpose_tpu_torch.models.sformer import NlosPoseSformer
    from hiddenpose_tpu_torch.models.timesformer import TimeSformer

    sformer = dict(dim=32, num_frames=3, num_joints=4, image_size=16,
                   patch_size=4, depth=2, heads=2, dim_head=8, out_dim=32)
    timesformer = dict(dim=32, num_frames=3, num_classes=72, image_size=16,
                       patch_size=4, channels=1, depth=2, heads=2, dim_head=8)
    # (id, class, kwargs, K9 launches a forward: per layer the grouped
    # attention and, at this size, the summary tokens' read, for each of
    # the time and the space attention)
    return [
        ("sformer-time", NlosPoseSformer,
         dict(sformer, use_time_attn=True), 8),
        ("sformer-time-pos_emb", NlosPoseSformer,
         dict(sformer, use_time_attn=True, rotary_emb=False), 8),
        ("timesformer", TimeSformer, timesformer, 8),
        ("timesformer-shift-pos_emb", TimeSformer,
         dict(timesformer, shift_tokens=True, rotary_emb=False), 8),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _time_attention_models(),
                         ids=lambda c: c[0])
def test_time_attention_models_on_the_gpu(dev, case, dtype, monkeypatch):
    """The ``over='time'`` grouping (transposed, non-contiguous views into
    K9) and the ``pos_emb`` variant, whose patch q and k stay bf16 in the
    bfloat16 mode: tiny models on the GPU, kernels against plain.  In
    bfloat16 the plain model's attention rounds in K9's order on K9's
    chunks (``attend_kernel_order``)."""
    import hiddenpose_tpu_torch.models.sformer as sformer
    from hiddenpose_tpu_torch.ops.kernels.attn import attend_kernel_order
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    _, cls, kw, launches = case
    model = cls(**kw, dtype=dtype).eval()
    model.load_state_dict(peaked_transformer_state_dict(model, 1))
    model.to(dev)
    video = torch.rand((2, 3, 1, 16, 16), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    n = K.attend.launches
    with torch.no_grad():
        got = model(video)
        assert K.attend.launches == n + launches
        model.set_use_kernels(False)
        if dtype == "bfloat16":
            monkeypatch.setattr(sformer, "attend_ref", attend_kernel_order)
        want = model(video)
        assert K.attend.launches == n + launches
    assert torch.isfinite(got.float()).all()
    # f32: summation order only.  bf16: against the plain models in K9's
    # order, over 64 seeded videos a model (scripts/
    # torch_time_attention_spread.py; NVIDIA H100 80GB HBM3) most outputs
    # are equal and the farthest reads 7.54e-3 of the scale, 1.25 bf16 ulps
    # of it: the limit is twice that.  (Against ``attend_ref``, which
    # rounds p against the row's final max, one video read 3.23e-2.)
    tol = 1e-4 if dtype == "float32" else 1.5e-2
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)


def test_simdr_step_on_the_gpu_kernels_vs_plain(dev):
    """One SimDR step (``train/alt_steps.py::make_simdr_step``) of a small
    Sformer on the GPU: K9 through ``AttendFused`` (2 launches a layer: the
    joint read and the grouped attention), against the same step with the
    plain attention, from the same weights.  Loss 1e-5 relative, gradients
    1e-4 relative L2 (f32 both sides, summation order only)."""
    from hiddenpose_tpu_torch.config import TrainConfig
    from hiddenpose_tpu_torch.models.sformer import NlosPoseSformer
    from hiddenpose_tpu_torch.train.alt_steps import make_simdr_step
    from hiddenpose_tpu_torch.train.optim import make_optimizer
    from hiddenpose_tpu_torch.utils.peaked import (
        peaked_transformer_state_dict,
    )

    model = NlosPoseSformer(dim=32, num_frames=2, num_joints=4, image_size=16,
                            patch_size=4, depth=2, heads=2, dim_head=8,
                            out_dim=64)
    weights = peaked_transformer_state_dict(model, 1)
    model.to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"video": torch.rand((2, 2, 1, 16, 16), device=dev, generator=g),
             "target_bins": torch.randint(0, 16, (2, 4, 3), device=dev,
                                          generator=g),
             "target_weight": torch.ones(2, 4, device=dev)}
    step = make_simdr_step(model)
    out = {}
    for flag in (True, False):
        model.load_state_dict(weights)
        model.set_use_kernels(flag)
        opt = make_optimizer(TrainConfig(), model.parameters())[0]
        n = K.attend.launches
        loss = step(opt, batch)["loss"].item()
        out[flag] = (loss, K.attend.launches - n,
                     {k: p.grad.clone() for k, p in model.named_parameters()})
    assert out[True][1] == 4 and out[False][1] == 0
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    num = sum(float((out[True][2][k] - v).double().pow(2).sum())
              for k, v in out[False][2].items())
    den = sum(float(v.double().pow(2).sum()) for v in out[False][2].values())
    assert (num / den) ** 0.5 < 1e-4


def test_posenet2d_forward_on_the_gpu_kernels_vs_plain(dev):
    """The ``posenet2d`` NlosPose at tiny(32) on the GPU, eval: K1 in
    FeatureExtraction and the UNet, then ``visible_net`` and the 2D net
    (library ops), against the same forward with the plain versions:
    heatmaps within 1e-4 of their largest value."""
    import dataclasses

    from hiddenpose_tpu_torch.config import Config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    m = dataclasses.replace(Config().tiny(32).model, backbone="posenet2d")
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(peaked_state_dict(model, 1))
    meas = torch.from_numpy(make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len)["meas"]).to(dev)
    K.reset_launch_counts()
    with torch.no_grad():
        got, _ = model(meas, lct)
        assert K.launch_counts()["conv3_planes"] > 0
        model.set_use_kernels(False)
        want, _ = model(meas, lct)
    assert got.shape == (2, 24, 16, 8, 8)
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_visible_net_on_the_gpu_matches_the_cpu_on_ties(dev, seed):
    """``visible_net`` on a volume of few levels (many exact ties after
    the ReLU): ``top_k_first`` ranks ties on the GPU as on the CPU (the
    lower depth first), so the output, the depth channel included, is
    equal bit for bit.  (A stable descending ``torch.sort`` failed this
    on the H100: the CUDA sort does not keep ties in order.)"""
    from hiddenpose_tpu_torch.models.posenet2d import visible_net

    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randint(-5, 5, (2, 3, 64, 9, 11)) * 0.25)
                         .astype(np.float32))
    want = visible_net(x)
    got = visible_net(x.to(dev)).cpu()
    assert torch.equal(got, want)


# -- the stem probes ------------------------------------------------------


def test_probes(dev):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_diag_stem_paired.py"
    spec = importlib.util.spec_from_file_location("torch_diag", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = {p: K.KERNELS[p][0].launches for p in K.PROBES}
    results = mod.run_probes(dev)
    assert [r["ok"] for r in results] == [True] * 4, results
    after = {p: K.KERNELS[p][0].launches for p in K.PROBES}
    assert [after[p] - before[p] for p in K.PROBES] == [1, 1, 2]


@pytest.mark.parametrize("shape", [(70, 36), (33, 2), (512, 128)])
def test_probe_slice_transpose_ragged(dev, shape):
    x = _t(np.random.RandomState(16), shape, dev)
    lo, hi = K.probe_slice_transpose(x)
    wlo, whi = K.probe_slice_transpose_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)


@pytest.mark.parametrize("mkn", [(70, 50, 64), (5, 3, 2), (128, 96, 130)])
def test_probe_dot_ragged(dev, mkn):
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = mkn
    rng = np.random.RandomState(17)
    a, b = _t(rng, (m, k), dev), _t(rng, (k, n), dev)
    got = K.probe_dot_f32(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, K.probe_dot_f32_ref(a, b), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, K.probe_dot_f32(a, b))  # fixed summation order


@pytest.mark.parametrize("mkn", [(33, 1000, 17), (512, 1024, 128),
                                 (512, 1024, 64)])
def test_probe_dot_long_k(dev, mkn):
    """The probe script's shapes and a ragged one with as long a K: within
    1e-5 of the largest output (the script's own limit), and two calls
    agree bit for bit (the partial tiles are summed in a fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = mkn
    rng = np.random.RandomState(20)
    a, b = _t(rng, (m, k), dev), _t(rng, (k, n), dev)
    got = K.probe_dot_f32(a, b)
    want = K.probe_dot_f32_ref(a, b)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(got, K.probe_dot_f32(a, b))


# ------------------------------------------------ the bf16 serving kernels
# K1-bf16 (conv3_planes_bf16), K2-bf16 (stem_conv_raw_bf16), K3-bf16
# (maxpool3d_k3s2p1_bf16) and K4-bf16 (conv3_mxu_bf16) of the bfloat16
# model.  Against the plain version (the bf16 operands widened, the f32 op,
# one rounding) each output may differ by at most one bf16 ulp of the
# plain one, plus 2^-16 of the largest output for sums that cancel near
# zero; K3 is exact.  Two calls agree bit for bit.  K2 and K4 are also held
# in their f32-output form against a float64 conv of the same bf16 values,
# where they may err at most twice as much as the library's f32 conv (TF32
# off) of the widened operands: a bf16 store would hide a fault of the sums.

BF16_ATOL = 2.0 ** -16


def _b(rng, shape, dev, scale=1.0):
    return _t(rng, shape, dev, scale).to(torch.bfloat16)


def _one_ulp(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    atol = BF16_ATOL * want.float().abs().max().item()
    assert K.bf16_ulp_excess(got, want, atol) <= 0.0


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("act", ["none", "leaky"])
@pytest.mark.parametrize("residual,pre", [(False, None), (True, True)])
@pytest.mark.parametrize("shape", [(2, 3, 5, 9, 13, 37),   # W % 8 != 0
                                   (2, 4, 8, 7, 12, 32),   # 16-byte rows
                                   (1, 1, 1, 16, 16, 16),
                                   # a ragged second tile along W, and
                                   # interior halo pairs on both sides
                                   (1, 2, 3, 5, 9, 40),
                                   (2, 1, 1, 4, 20, 80)])
def test_conv3_planes_bf16(dev, shape, pad_mode, act, residual, pre):
    rng = np.random.RandomState(21)
    b, cin, cout, d, h, w = shape
    x = _b(rng, (b, cin, d, h, w), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    bias = _t(rng, (cout,), dev, 0.1)
    res = _b(rng, (b, cout, d, h, w), dev) if residual else None
    ps = _t(rng, (cin,), dev) if pre is not None else None
    pt = _t(rng, (cin,), dev) if pre is not None else None
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre)
    got = _counted(K.conv3_planes_bf16,
                   lambda: K.conv3_planes_bf16(x, k, bias, res, ps, pt, **kw))
    _one_ulp(got, K.conv3_planes_ref(x, k, bias, res, ps, pt, **kw))
    assert torch.equal(got, K.conv3_planes_bf16(x, k, bias, res, ps, pt,
                                                **kw))


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 4), (16, 16), (32, 32)])
def test_conv3_planes_bf16_channels(dev, cin, cout):
    """The UNet's widths, on the tile plans they take at small volumes
    (channel groups and split sums included)."""
    rng = np.random.RandomState(22)
    x = _b(rng, (2, cin, 8, 16, 16), dev)
    k = _t(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    bias = _t(rng, (cout,), dev, 0.1)
    got = K.conv3_planes_bf16(x, k, bias, act="relu")
    _one_ulp(got, K.conv3_planes_ref(x, k, bias, act="relu"))


@pytest.mark.parametrize("shape", [(1, 12, 20, 36), (2, 16, 16, 16),
                                   (1, 5, 6, 7), (1, 9, 17, 33),
                                   (2, 40, 9, 23), (1, 1, 1, 1)])
@pytest.mark.parametrize("relu", [True, False])
def test_stem_conv_bf16(dev, shape, relu):
    rng = np.random.RandomState(23)
    x, k, scale, shift = _stem_inputs(rng, shape, dev)
    x, k = x.to(torch.bfloat16), k.to(torch.bfloat16)
    got = _counted(K.stem_conv_raw_bf16,
                   lambda: K.stem_conv_raw_bf16(x, k, scale, shift, relu))
    _one_ulp(got, K.stem_conv_raw_ref(x, k, scale, shift, relu))
    assert torch.equal(got, K.stem_conv_raw_bf16(x, k, scale, shift, relu))


def test_stem_conv_bf16_against_float64(dev):
    """The f32-output form, one bf16 pass with f32 sums, two partials a
    plane:
    at most twice the library f32 conv's error against float64; the
    weight operand bit for bit the plain version's."""
    from hiddenpose_tpu_torch.ops.kernels import stem_conv

    rng = np.random.RandomState(24)
    x, k, scale, shift = _stem_inputs(rng, (2, 24, 20, 40), dev)
    x = x.to(torch.bfloat16)
    k = (k / 0.05 * 343 ** -0.5).to(torch.bfloat16)
    got = K.stem_conv_raw_bf16(x, k, scale, shift, False,
                               out_dtype=torch.float32)
    want = K.stem_conv_raw_ref(x.float(), k, scale, shift, relu=False)
    want64 = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                      k.double().permute(4, 3, 0, 1, 2), padding=3)
    want64 = want64.permute(0, 2, 3, 4, 1) * scale.double() + shift.double()
    err, err_plain = ((t.double() - want64).abs().max().item()
                      for t in (got, want))
    assert err <= 2 * err_plain, (err, err_plain)
    assert torch.equal(stem_conv.prepare_weights_bf16(k),
                       stem_conv.prepare_weights_bf16_ref(k))


@pytest.mark.parametrize("shape", [(1, 12, 20, 36), (1, 5, 6, 7),
                                   (2, 9, 17, 33), (1, 70, 16, 16)])
def test_stem_conv_bf16_matches_its_tiled_ref(dev, shape):
    """The f32-output form against the kernel's bookkeeping in plain
    PyTorch (``stem_conv_bf16_tiled_ref``: its expanded plane slots, the
    mirrored ring, both descriptors, the two partials a plane) on ragged
    tiles and across two work units along D: the f32 sums' order alone
    (the tensor core truncates inside a partial where the CPU rounds, so
    the two agree to 1e-5 of the largest output, not bit for bit)."""
    from hiddenpose_tpu_torch.ops.kernels import stem_conv

    rng = np.random.RandomState(30)
    x, k, scale, shift = _stem_inputs(rng, shape, dev)
    x = x.to(torch.bfloat16)
    k = (k / 0.05 * 343 ** -0.5).to(torch.bfloat16)
    got = K.stem_conv_raw_bf16(x, k, scale, shift, False,
                               out_dtype=torch.float32)
    want = stem_conv.stem_conv_bf16_tiled_ref(
        x.cpu(), k.cpu(), scale.cpu(), shift.cpu(), relu=False,
        out_dtype=torch.float32)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# Each of the kernel's tiles (conv3mxu.bf16_tile): 16 x 16 (W 9-16, the
# c256 @16^3 plan), 32 x 8 (W <= 8), 8 x 32 (W > 16, here also with ragged
# tiles in H and W); a persistent block walks several tiles where the call
# has more tiles than the card has multiprocessors.
K4_BF16_CASES = [(2, 16, 16, 16, 64), (1, 8, 8, 8, 128), (2, 6, 6, 6, 256),
                 (1, 5, 6, 7, 64), (1, 5, 6, 7, 128), (1, 3, 4, 5, 64),
                 (1, 3, 6, 40, 64), (1, 2, 5, 64, 128), (1, 3, 9, 20, 128),
                 (2, 4, 16, 16, 256), (2, 36, 16, 16, 128)]


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("shape", K4_BF16_CASES)
def test_conv3_mxu_bf16(dev, shape, epilogue):
    """Against the plain version within one bf16 ulp, twice bit for bit,
    and in its f32-output form against float64 (at most twice the
    library f32 conv's error)."""
    rng = np.random.RandomState(25)
    c = shape[4]
    x = _b(rng, shape, dev)
    k = _b(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    sc = _t(rng, (c,), dev).abs() + 0.5 if epilogue else None
    sh = _t(rng, (c,), dev, 0.1) if epilogue else None
    got = _counted(K.conv3_mxu_bf16,
                   lambda: K.conv3_mxu_bf16(x, k, sc, sh, relu=epilogue))
    _one_ulp(got, K.conv3_mxu_ref(x, k, sc, sh, relu=epilogue))
    assert torch.equal(got, K.conv3_mxu_bf16(x, k, sc, sh, relu=epilogue))
    f32 = K.conv3_mxu_bf16(x, k, sc, sh, relu=epilogue,
                           out_dtype=torch.float32)
    want = K.conv3_mxu_ref(x.float(), k.float(), sc, sh, relu=epilogue)
    want64 = _conv64(x, k)
    if epilogue:
        want64 = torch.clamp_min(want64 * sc.double() + sh.double(), 0.0)
    err, err_plain = ((t.double() - want64).abs().max().item()
                      for t in (f32, want))
    assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 128), (96, 64),
                                      (256, 128)])
def test_conv3_mxu_bf16_rectangular_channels(dev, cin, cout):
    """C_in != C_out, and C_in of one 32-channel unit a tap (the one-unit
    stages) or an odd number of units."""
    rng = np.random.RandomState(28)
    x = _b(rng, (1, 4, 5, 9, cin), dev)
    k = _b(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cin))
    _one_ulp(K.conv3_mxu_bf16(x, k), K.conv3_mxu_ref(x, k))


@pytest.mark.parametrize("shape", [(1, 3, 6, 40, 64), (1, 3, 9, 20, 128),
                                   (1, 4, 16, 16, 256), (1, 3, 5, 7, 32)])
def test_conv3_mxu_bf16_matches_its_tiled_ref(dev, shape):
    """The f32-output form against the kernel's bookkeeping in plain
    PyTorch (``conv3_mxu_bf16_tiled_ref``: its halos, tap rows, weight
    layout and partials), on each tile: the f32 sums' order alone."""
    rng = np.random.RandomState(29)
    c = shape[4]
    x = _b(rng, shape, dev)
    k = _b(rng, (3, 3, 3, c, 64), dev, 1.0 / np.sqrt(27 * c))
    got = K.conv3_mxu_bf16(x, k, out_dtype=torch.float32)
    want = conv3mxu.conv3_mxu_bf16_tiled_ref(x.cpu(), k.cpu(),
                                             out_dtype=torch.float32)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("cin,cout", [(64, 64), (32, 128), (256, 256)])
def test_conv3_mxu_bf16_weight_preparation(dev, cin, cout):
    rng = np.random.RandomState(26)
    k = _b(rng, (3, 3, 3, cin, cout), dev)
    got = conv3mxu.prepare_weights_bf16(k)
    torch.cuda.synchronize()
    assert torch.equal(got, conv3mxu.prepare_weights_bf16_ref(k))


@pytest.mark.parametrize("kind", ["random", "ties", "negative"])
@pytest.mark.parametrize("shape", [(1, 9, 10, 11, 64), (2, 16, 16, 16, 8)])
def test_maxpool_bf16(dev, shape, kind):
    rng = np.random.RandomState(27)
    y = _b(rng, shape, dev)
    if kind == "ties":
        y = torch.clamp_min(y, 0.0)
    elif kind == "negative":
        y = -y.abs() - 1.0
    got = _counted(K.maxpool3d_k3s2p1_bf16,
                   lambda: K.maxpool3d_k3s2p1_bf16(y))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, K.maxpool3d_k3s2p1_ref(y))
    assert torch.equal(got, K.maxpool3d_k3s2p1_bf16(y))


def test_bf16_wrappers_raise_rather_than_fall_back(dev):
    """A wrong dtype or layout raises on the GPU: no quiet upcast to the
    f32 kernel, no quiet plain version."""
    xb = torch.zeros((1, 4, 4, 4, 64), device=dev, dtype=torch.bfloat16)
    kb = torch.zeros((3, 3, 3, 64, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        K.conv3_mxu_bf16(xb.float(), kb)              # f32 input
    with pytest.raises(TypeError):
        K.conv3_mxu(xb, kb)                           # bf16 into the f32 K4
    with pytest.raises(ValueError):
        K.conv3_mxu_bf16(xb.transpose(1, 2), kb)      # not contiguous
    with pytest.raises(ValueError):
        K.conv3_mxu_bf16(xb[..., :48].contiguous(),   # C_in % 32 != 0
                         kb[:, :, :, :48].contiguous())
    xs = torch.zeros((1, 8, 8, 8, 1), device=dev, dtype=torch.bfloat16)
    ks = torch.zeros((7, 7, 7, 1, 64), device=dev, dtype=torch.bfloat16)
    s = torch.ones(64, device=dev)
    with pytest.raises(TypeError):
        K.stem_conv_raw_bf16(xs.float(), ks, s, s)
    with pytest.raises(TypeError):
        K.stem_conv_raw(xs, ks, s, s)
    xp = torch.zeros((1, 4, 6, 6, 6), device=dev, dtype=torch.bfloat16)
    kp = torch.zeros((3, 3, 3, 4, 4), device=dev)
    with pytest.raises(TypeError):
        K.conv3_planes_bf16(xp, kp, residual=xp.float())  # f32 residual
    with pytest.raises(TypeError):
        K.conv3_planes(xp, kp)
    with pytest.raises(ValueError):
        K.maxpool3d_k3s2p1_bf16(xb[..., :12].contiguous())  # C % 8 != 0
    with pytest.raises(TypeError):
        K.maxpool3d_k3s2p1(xb)


# ------------------------------- the train step at the default precision
# K4-dx-bf16 (conv3_mxu_dx_bf16): the bf16 kernel on the flipped, swapped
# taps, the Bottleneck dx of a train step at 'default'.  Its bf16-output
# form (the bf16 model's) within one bf16 ulp of the plain version, twice
# bit for bit; its f32-output form (the f32 model's, on f32 dz) against
# float64 at most twice the library f32 conv's error (TF32 off) on the
# same bf16-rounded operands, or four f32 ulps of the largest output
# (2^-21 of it), where that is more: the tensor core truncates inside each
# 288-product partial, which at these short sums costs the kernel a couple
# of ulps where cuDNN's round-to-nearest f32 sums may err by one, and their
# ratio is then chance (read on the card at (1, 2, 5, 64, 128): the kernel
# 1.19e-06, 2.3 ulps of the largest output, cuDNN 5.8e-07 in one call and
# over 5.9e-07 in another; at the path's shapes phase 10 reads the kernel
# at 0.14-0.27 of cuDNN's error).

@pytest.mark.parametrize("shape", K4_BF16_CASES)
def test_conv3_mxu_dx_bf16(dev, shape):
    rng = np.random.RandomState(30)
    c = shape[4]
    dz = _t(rng, shape, dev)
    k = _t(rng, (3, 3, 3, c, c), dev, 1.0 / np.sqrt(27 * c))
    dzb, kb = dz.to(torch.bfloat16), k.to(torch.bfloat16)
    got = _counted(K.conv3_mxu_dx_bf16, lambda: K.conv3_mxu_dx_bf16(
        dzb, kb, out_dtype=torch.bfloat16))
    _one_ulp(got, K.conv3_mxu_dx_bf16_ref(dzb, kb, out_dtype=torch.bfloat16))
    assert torch.equal(got, K.conv3_mxu_dx_bf16(dzb, kb,
                                                out_dtype=torch.bfloat16))
    f32 = K.conv3_mxu_dx_bf16(dz, k)
    want = K.conv3_mxu_dx_bf16_ref(dz, k)
    want64 = _conv64(dzb, conv3mxu.flip_swap(kb))
    torch.cuda.synchronize()
    assert f32.dtype == torch.float32
    err, err_plain = ((t.double() - want64).abs().max().item()
                      for t in (f32, want))
    ulps = 4 * 2.0 ** -23 * want64.abs().max().item()
    assert err <= max(2 * err_plain, ulps), (err, err_plain, ulps)


@pytest.mark.parametrize("cin,cout", [(64, 32), (128, 64), (64, 96),
                                      (128, 256)])
def test_conv3_mxu_dx_bf16_rectangular_channels(dev, cin, cout):
    """dx of a conv C_in -> C_out runs the kernel C_out -> C_in: C_out of
    one or an odd number of 32-channel units, C_in of several 64-wide
    output blocks; the weight preparation's flip and swap bit for bit."""
    rng = np.random.RandomState(31)
    dz = _b(rng, (1, 4, 5, 9, cout), dev)
    k = _b(rng, (3, 3, 3, cin, cout), dev, 1.0 / np.sqrt(27 * cout))
    _one_ulp(K.conv3_mxu_dx_bf16(dz, k, out_dtype=torch.bfloat16),
             K.conv3_mxu_dx_bf16_ref(dz, k, out_dtype=torch.bfloat16))
    assert torch.equal(conv3mxu.prepare_weights_bf16(k, transposed=True),
                       conv3mxu.prepare_weights_bf16_ref(k, transposed=True))


def test_conv3_mxu_bwd_route_matches_plain_autograd(dev):
    """Conv3MxuBwd (the 'bwd' route) on the GPU against its plain form:
    the same library forward and dk call, dx the kernel against its plain
    version (f32 out, the same exact products summed in another order):
    each within 1e-5 of its max."""
    rng = np.random.RandomState(32)
    x = _t(rng, (2, 6, 8, 16, 64), dev).requires_grad_()
    k = _t(rng, (3, 3, 3, 64, 64), dev, 0.05).requires_grad_()
    g = _t(rng, (2, 6, 8, 16, 64), dev)
    out, got = _grads(lambda a, b: K.conv3_mxu_bwd_diff(a, b), [x, k], g)
    want_out, want = _grads(
        lambda a, b: K.conv3_mxu_bwd_diff(a, b, plain=True), [x, k], g)
    for a, b in ((out, want_out), (got[0], want[0]), (got[1], want[1])):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def _tiny_train(dev, bf16, precision, flags=None):
    """One tiny train step at ``precision``; ``flags`` (cuDNN's and
    cuBLAS's allow_tf32), if given, are set after the model is built (which
    turns both off) and just before the step."""
    from hiddenpose_tpu_torch.config import TrainConfig, default_config
    from hiddenpose_tpu_torch.data.synthetic import make_batch
    from hiddenpose_tpu_torch.models.nlospose import build_nlospose
    from hiddenpose_tpu_torch.train.state import TrainState
    from hiddenpose_tpu_torch.train.step import make_train_step
    from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict

    cfg = default_config().tiny(32)
    m = (cfg.with_bf16() if bf16 else cfg).model
    model, lct = build_nlospose(m, device=dev)
    model.load_state_dict(peaked_state_dict(model, 1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
        m.bin_len).items()}
    state = TrainState.create(model, TrainConfig())
    if flags is not None:
        torch.backends.cudnn.allow_tf32 = flags[0]
        torch.backends.cuda.matmul.allow_tf32 = flags[1]
    K.reset_launch_counts()
    metrics = make_train_step(model, matmul_precision=precision)(
        state, batch, lct)
    torch.cuda.synchronize()
    return model, metrics, K.launch_counts()


@pytest.mark.parametrize("cudnn,matmul", [(False, False), (True, True),
                                          (True, False)])
def test_default_step_restores_the_tf32_flags(dev, cudnn, matmul):
    """A step at 'default' takes TF32 for its duration only: the flags of
    cuDNN and cuBLAS read after it as before it, whatever they were; it
    launches K4-dx-bf16 and no K4."""
    try:
        model, metrics, counts = _tiny_train(dev, False, "default",
                                             flags=(cudnn, matmul))
        assert torch.backends.cudnn.allow_tf32 == cudnn
        assert torch.backends.cuda.matmul.allow_tf32 == matmul
        assert conv3mxu.current_precision() == "highest"
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.isfinite(metrics["loss"])
    assert all(counts[k] > 0 for k in K.TRAINING_DEFAULT), counts
    assert counts["conv3_mxu"] == counts["conv3_mxu_dx"] == 0


def test_bf16_train_step_on_the_gpu_reaches_every_weight(dev):
    """One tiny bf16 step at 'default': the loss is finite, every kernel of
    the bf16 train path launched (of the f32 forward kernels only K1: the
    FeatureExtraction's and the UNet's first convs, whose inputs are f32,
    each once a forward and once more in the backward's recompute with
    ``cfg.stage_remat``, the default), and every float32 parameter got a
    float32 gradient."""
    model, metrics, counts = _tiny_train(dev, True, "default")
    assert torch.isfinite(metrics["loss"])
    assert all(counts[k] > 0 for k in K.TRAINING_BF16), counts
    assert counts["conv3_planes"] == 2 * (1 + model.cfg.stage_remat)
    assert counts["maxpool3d_k3s2p1"] == 0
    assert counts["conv3_mxu"] == counts["conv3_mxu_bf16"] == 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        assert p.grad.dtype == torch.float32, n


class _WorkerProbeSource:
    """A tiny synthetic source whose ids say, from the process that built
    each sample, whether CUDA is initialised there and whether the kernel
    library is loaded."""

    def __init__(self, cfg, length):
        from hiddenpose_tpu_torch.data.dataset import SyntheticSource

        self.inner = SyntheticSource(cfg, length=length)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, index):
        from hiddenpose_tpu_torch.ops.kernels import _build

        item = dict(self.inner[index])
        item["person_id"] += (f"|cuda={torch.cuda.is_initialized()}"
                              f"|lib={_build._lib is not None}")
        return item


def test_pipeline_workers_and_prefetch_after_cuda_is_up(dev):
    """With CUDA initialised and the kernel library loaded in this process,
    two loader worker processes and pinned memory feed
    ``device_prefetch`` the same batches, on the GPU, as loading in this
    process does; the workers never initialise CUDA or load the
    library."""
    from hiddenpose_tpu_torch.config import Config
    from hiddenpose_tpu_torch.data.dataset import DataPipeline
    from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch

    K.conv3_planes(torch.zeros(1, 1, 4, 4, 4, device=dev),
                   torch.zeros(3, 3, 3, 1, 1, device=dev))
    src = _WorkerProbeSource(Config().tiny(16), length=5)
    runs = []
    for workers in (0, 2):
        with DataPipeline(src, batch_size=2, num_workers=workers,
                          drop_last=False, pin_memory=True) as pipe:
            pipe.set_epoch(1)
            if workers:
                ids = [i for b in pipe for i in b["person_id"]]
                assert len(ids) == 5
                assert all(i.endswith("|cuda=False|lib=False")
                           for i in ids), ids
            runs.append(list(device_prefetch(iter(pipe), dev)))
    assert len(runs[0]) == len(runs[1]) == 3
    for a, b in zip(*runs):
        assert a.keys() == b.keys() == {"meas", "vol", "joints",
                                        "joints_vis"}
        for k in a:
            assert a[k].is_cuda and b[k].is_cuda
            assert torch.equal(a[k], b[k]), k
