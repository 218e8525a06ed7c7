"""The train-mode stem conv's matrix-product backward
(``hiddenpose_tpu_torch/ops/stem_vjp.py``) on the CPU, against the JAX
package's ``conv_s2d_stem_diff`` and against plain autograd.

The reference differentiates the conv in its space-to-depth form; the
composite ``space_to_depth_3d -> conv_s2d_stem_diff(., make_s2d_kernel(k))
-> depth_to_space_3d`` is the same function of the raw volume and the
(k, k, k, 1, C_out) kernel as the port's conv, so ``jax.vjp`` of it gives
the dx and dk the port must match.  Tolerance 1e-5 of each gradient's max:
both sides sum the same f32 products, in another order (343 taps a voxel
for dx, every voxel for dk; at these sizes a few thousand terms).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hiddenpose_tpu.ops.space_to_depth import (
    conv_s2d_stem_diff,
    depth_to_space_3d,
    make_s2d_kernel,
    space_to_depth_3d,
)
from hiddenpose_tpu_torch.models.posenet3d import PoseNet3D
from hiddenpose_tpu_torch.ops.stem_vjp import (
    stem_conv_diff,
    stem_conv_dk,
    stem_conv_dx,
)
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

TOL = 1e-5


def _inputs(seed, shape, cout, k):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)                 # (B, D, H, W)
    kern = ((rng.rand(k, k, k, 1, cout) - 0.5) * 0.2).astype(np.float32)
    ct = rng.randn(shape[0], *shape[1:], cout).astype(np.float32)
    return x, kern, ct


def _jax_composite_vjp(x, kern, ct):
    """y, dx, dk of the reference's composite; NDHWC and DHWIO."""
    def f(x, k):
        y2 = conv_s2d_stem_diff(space_to_depth_3d(x), make_s2d_kernel(k))
        return depth_to_space_3d(y2)
    y, pull = jax.vjp(f, jnp.asarray(x[..., None]), jnp.asarray(kern))
    dx, dk = pull(jnp.asarray(ct))
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


def _torch_vjp(x, kern, ct, fn=stem_conv_diff, need_x=True):
    xt = torch.from_numpy(x)[:, None].requires_grad_(need_x)
    w = torch.from_numpy(kern).permute(4, 3, 0, 1, 2).contiguous()
    w.requires_grad_()
    y = fn(xt, w)
    y.backward(torch.from_numpy(ct).permute(0, 4, 1, 2, 3))
    dx = None if xt.grad is None else xt.grad[:, 0, ..., None].numpy()
    return (y.detach().permute(0, 2, 3, 4, 1).numpy(), dx,
            w.grad.permute(2, 3, 4, 1, 0).numpy())


@pytest.mark.parametrize("shape,cout,k", [
    ((2, 8, 8, 8), 8, 7), ((1, 4, 6, 8), 16, 7), ((1, 8, 8, 8), 4, 5),
    ((2, 4, 4, 4), 8, 3)])
def test_stem_conv_diff_matches_the_jax_vjp(shape, cout, k):
    x, kern, ct = _inputs(sum(shape) + k, shape, cout, k)
    y_w, dx_w, dk_w = _jax_composite_vjp(x, kern, ct)
    y, dx, dk = _torch_vjp(x, kern, ct)
    for got, want in ((y, y_w), (dx, dx_w), (dk, dk_w)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (1, 8, 8, 8), (1, 3, 9, 4),
                                   (2, 1, 2, 3)])
@pytest.mark.parametrize("k", [7, 3])
def test_stem_conv_diff_matches_autograd_in_float64(shape, k):
    """Odd and even extents, extents smaller than the kernel: against the
    autograd of ``F.conv3d`` in float64, to 1e-12 of the max."""
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(shape[0], 1, *shape[1:]))
    w = torch.from_numpy(rng.randn(6, 1, k, k, k))
    g = torch.from_numpy(rng.randn(shape[0], 6, *shape[1:]))
    x.requires_grad_(), w.requires_grad_()
    got = torch.autograd.grad(stem_conv_diff(x, w), (x, w), g)
    want = torch.autograd.grad(F.conv3d(x, w, padding=k // 2), (x, w), g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_channels_last_cotangent_gives_the_same_gradients():
    """The cotangent may arrive NCDHW or channels-last; both are read as
    views and give the same result."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 1, 4, 5, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 1, 7, 7, 7).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 8, 4, 5, 6).astype(np.float32))
    gl = g.contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(stem_conv_dk(x, g, 7), stem_conv_dk(x, gl, 7))
    assert torch.equal(stem_conv_dx(w, g), stem_conv_dx(w, gl))


def test_input_without_gradient_skips_dx(monkeypatch):
    from hiddenpose_tpu_torch.ops import stem_vjp

    def boom(*_):
        raise AssertionError("dx computed for an input that needs none")
    monkeypatch.setattr(stem_vjp, "stem_conv_dx", boom)
    x, kern, ct = _inputs(3, (1, 4, 4, 4), 4, 7)
    _, dx, dk = _torch_vjp(x, kern, ct, need_x=False)
    assert dx is None
    _, _, dk_w = _torch_vjp(
        x, kern, ct, fn=lambda a, b: F.conv3d(a, b, padding=3), need_x=False)
    np.testing.assert_allclose(dk, dk_w, rtol=0,
                               atol=TOL * np.abs(dk_w).max())


def test_two_calls_are_bit_identical():
    x, kern, ct = _inputs(4, (2, 6, 6, 6), 8, 7)
    a, b = _torch_vjp(x, kern, ct), _torch_vjp(x, kern, ct)
    assert all(np.array_equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("bad", ["channels", "even_kernel", "rank"])
def test_stem_conv_diff_rejects_what_it_does_not_take(bad):
    x = torch.zeros(1, 2 if bad == "channels" else 1, 4, 4, 4)
    w = torch.zeros(4, 2 if bad == "channels" else 1,
                    *((4, 4, 4) if bad == "even_kernel" else (3, 3, 3)))
    if bad == "rank":
        x = x[0]
    with pytest.raises(ValueError):
        stem_conv_diff(x, w)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_train_mode_stem_routes_through_stem_conv_diff(use_kernels,
                                                       monkeypatch):
    """``PoseNet3D.stem`` in train mode calls ``stem_conv_diff`` with the
    kernels on and the library conv's autograd with them off; the
    gradients of ``conv1.weight`` and of the input agree."""
    from hiddenpose_tpu_torch.models import posenet3d

    calls = []
    real = posenet3d.stem_conv_diff
    monkeypatch.setattr(posenet3d, "stem_conv_diff",
                        lambda x, w: calls.append(1) or real(x, w))
    torch.manual_seed(0)
    net = PoseNet3D(layers=(1, 1, 1, 1), widths=(8, 8, 8, 8), num_joints=2)
    net.train()
    net.use_kernels = use_kernels
    x = torch.rand(2, 1, 8, 8, 8, requires_grad=True)
    out = net.stem(x)
    assert len(calls) == (1 if use_kernels else 0)
    out.square().sum().backward()
    got = (x.grad.clone(), net.conv1.weight.grad.clone())

    x.grad = None
    net.zero_grad()
    net.use_kernels = not use_kernels
    net.stem(x).square().sum().backward()
    for a, b in zip(got, (x.grad, net.conv1.weight.grad)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert set(n for n, _ in net.named_parameters() if n.startswith(
        "conv1")) == {"conv1.weight"}
    assert net.conv1.weight.shape == (8, 1, 7, 7, 7)
