"""K4 (``hiddenpose_tpu_torch/ops/kernels/conv3mxu.py``) against the JAX
package's Pallas tap-pack conv, run in interpret mode in f32 on the CPU.

Shapes are the scaled-down Bottleneck conv2 analogues of
``tests/test_conv3mxu.py``.  On the CPU the port's wrapper runs its plain
version; the CUDA kernel is compared with that on the GPU by
``tests/test_torch_kernels_cuda.py``.  Tolerance: both sides are f32 sums
of 27 * C_in products in different orders, so 2e-5 relative and 2e-4
absolute (the JAX kernel's own tolerance against XLA).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hiddenpose_tpu.ops.pallas.conv3mxu import conv3_mxu as jax_conv3_mxu
from hiddenpose_tpu_torch.ops.kernels import conv3_mxu
from hiddenpose_tpu_torch.ops.kernels.conv3mxu import conv3mxu_supported

SHAPES = [
    # (b, d, h, w, cin, cout), as tests/test_conv3mxu.py::SHAPES
    (1, 4, 8, 16, 64, 64),
    (2, 2, 4, 8, 128, 64),
    (1, 2, 8, 32, 64, 128),
    (1, 3, 4, 16, 256, 64),
]


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv3_mxu_matches_jax(shape, epilogue):
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, d, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32) if epilogue else None
    shift = (rng.randn(cout) * 0.1).astype(np.float32) if epilogue else None
    j = [None if a is None else jnp.asarray(a) for a in (x, k, scale, shift)]
    want = jax_conv3_mxu(*j, relu=epilogue, interpret=True,
                         compute_dtype="f32")
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, k, scale, shift)]
    got = conv3_mxu(*t, relu=epilogue)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


def test_supported_channels():
    # the model's stride-1 Bottleneck widths
    assert all(conv3mxu_supported(c, c) for c in (64, 128, 256))
    assert not conv3mxu_supported(8, 64)
    assert not conv3mxu_supported(64, 32)


def test_wrapper_validates_input():
    x = torch.zeros((1, 2, 2, 2, 64))
    k = torch.zeros((3, 3, 3, 64, 64))
    with pytest.raises(ValueError):
        conv3_mxu(x, k, scale=torch.ones(64))          # shift missing
    with pytest.raises(ValueError):
        conv3_mxu(x, torch.zeros((3, 3, 3, 64, 48)))   # C_out % 64
    with pytest.raises(ValueError):
        conv3_mxu(x, k, torch.ones(32), torch.ones(32))
