"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch and the port only (no jax), so on a GPU host it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and deliberately ragged (extents that are not multiples
of the kernels' tiles) so every masking branch runs.  Tolerance: both
sides are float32 with TF32 off; they differ only in summation order, so
errors are a few ulps of the output scale (1e-4 absolute and relative for
unit-scale outputs).
"""

import numpy as np
import pytest
import torch

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
