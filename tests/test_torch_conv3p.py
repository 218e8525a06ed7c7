"""K1 (``hiddenpose_tpu_torch/ops/kernels/conv3p.py``) against the JAX
package's Pallas stencil kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain version (pad + ``F.conv3d`` +
epilogue); the CUDA kernel itself is compared with that plain version on
the GPU by ``tests/test_torch_kernels_cuda.py``.  Inputs are made with
numpy from fixed seeds and handed to both.  Tolerance: both sides are f32
with f32 accumulation and differ only in summation order; 1e-5 absolute
and relative for unit-scale data.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes as jax_conv3_planes
from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes_xla
from hiddenpose_tpu_torch.ops.kernels import conv3_planes, conv3_planes_ref

SHAPE = (2, 8, 8, 16)  # (B, D, H, W), as the JAX kernel's own tests use

CASES = [
    # (cin, cout, pad_mode, act, residual, pre_relu)
    (1, 1, "edge", "none", False, None),
    (1, 1, "edge", "leaky", True, None),
    (1, 1, "zero", "none", True, None),
    (2, 3, "zero", "relu", False, None),
    (3, 2, "edge", "relu", True, True),
    (4, 4, "zero", "leaky", False, False),
    (4, 8, "zero", "leaky", True, True),
    (8, 4, "edge", "none", False, False),
]


def _inputs(cin, cout, residual, pre_relu, seed=0):
    rng = np.random.RandomState(seed)
    b, d, h, w = SHAPE
    arrs = {
        "x": rng.randn(b, cin, d, h, w),
        "kernel": rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin),
        "bias": rng.randn(cout) * 0.1,
        "residual": rng.randn(b, cout, d, h, w) if residual else None,
        "pre_scale": rng.rand(cin) + 0.5 if pre_relu is not None else None,
        "pre_shift": rng.randn(cin) * 0.1 if pre_relu is not None else None,
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in arrs.items()}


@pytest.mark.parametrize("cin,cout,pad_mode,act,residual,pre_relu", CASES)
def test_conv3_planes_matches_jax(cin, cout, pad_mode, act, residual,
                                  pre_relu):
    """Against the Pallas kernel (interpret mode) and the JAX package's
    reference semantics ``conv3_planes_xla``.

    One known difference: with zero padding AND a pre-affine the Pallas
    kernel applies the affine to the zero-filled depth-halo planes too, so
    its first and last output planes see pre(0) where
    ``conv3_planes_xla`` (and its own docstring: pad the pre-affined
    input with zeros) see 0.  The port follows the documented semantics,
    so for those cases the Pallas comparison covers the interior planes
    and ``conv3_planes_xla`` the whole volume."""
    a = _inputs(cin, cout, residual, pre_relu)
    kw = dict(act=act, pad_mode=pad_mode, pre_relu=pre_relu)
    jargs = [None if v is None else jnp.asarray(v) for v in a.values()]
    got = conv3_planes(
        *[None if v is None else torch.from_numpy(v) for v in a.values()],
        **kw).numpy()
    pallas = np.asarray(jax_conv3_planes(*jargs, interpret=True, **kw))
    planes = (slice(1, -1) if pad_mode == "zero" and pre_relu is not None
              else slice(None))
    np.testing.assert_allclose(got[:, :, planes], pallas[:, :, planes],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(conv3_planes_xla(*jargs, **kw)),
                               rtol=1e-5, atol=1e-5)


def test_leaky_slope_applies_after_residual():
    """act(conv + residual): a residual that flips the sign of the sum must
    flip which side of the leaky slope the output lands on."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.zeros((3, 3, 3, 1, 1))
    bias = torch.tensor([1.0])
    res = torch.full((1, 1, 3, 3, 3), -3.0)
    got = conv3_planes(x, k, bias, res, act="leaky")
    torch.testing.assert_close(got, torch.full_like(res, -0.4))


def test_pre_affine_precedes_zero_padding():
    """Zero padding pads pre(x), so a pre-shift never leaks into the
    border taps: an all-ones kernel over a constant input whose affine
    image is 1 counts exactly the in-volume taps."""
    x = torch.zeros((1, 1, 3, 3, 3))
    k = torch.ones((3, 3, 3, 1, 1))
    got = conv3_planes(x, k, pre_scale=torch.tensor([1.0]),
                       pre_shift=torch.tensor([1.0]), pre_relu=False)
    assert got[0, 0, 1, 1, 1] == 27.0   # centre: every tap inside
    assert got[0, 0, 0, 0, 0] == 8.0    # corner: 2 x 2 x 2 taps inside


def test_wrapper_validates_input():
    x = torch.zeros((1, 2, 4, 4, 4))
    k = torch.zeros((3, 3, 3, 2, 2))
    with pytest.raises(ValueError):
        conv3_planes(x, k[..., :1, :])                  # C_in mismatch
    with pytest.raises(ValueError):
        conv3_planes(x.transpose(3, 4), k)              # not contiguous
    with pytest.raises(TypeError):
        conv3_planes(x.double(), k.double())            # not float32
    with pytest.raises(ValueError):
        conv3_planes(x, k, act="gelu")
    with pytest.raises(ValueError):
        conv3_planes(x, k, residual=torch.zeros((1, 2, 4, 4, 5)))


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor runs the plain version: any other device launches
    the kernel (CUDA) or raises, here on the meta device."""
    x = torch.zeros((1, 1, 4, 4, 4), device="meta")
    k = torch.zeros((3, 3, 3, 1, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3_planes(x, k)


def test_plain_version_is_what_the_cpu_wrapper_runs():
    a = _inputs(2, 3, True, True, seed=3)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    n = conv3_planes.launches
    got = conv3_planes(*t.values(), act="relu", pre_relu=True)
    assert conv3_planes.launches == n  # a CPU call launches no kernel
    assert torch.equal(
        got, conv3_planes_ref(*t.values(), act="relu", pre_relu=True))
