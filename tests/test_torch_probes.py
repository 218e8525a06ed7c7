"""The plain versions of the four stem probes
(``hiddenpose_tpu_torch/ops/kernels/probes.py``) against the numpy
expressions that ``scripts/tpu_diag_stem_paired.py`` compares its Pallas
kernels with, on the probe's own inputs.  On a CPU tensor each wrapper runs
its plain version; the CUDA kernels are held against these on the GPU
(``tests/test_torch_kernels_cuda.py``, ``scripts/torch_diag_stem_paired.py``).
The gathers are exact; the product is held to 1e-5 of its largest value,
the TPU script's own limit."""

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.ops.kernels import KERNELS, PROBES, probes

CIN, TD, TH = 8, 4, 4
NC = TD // 2 * TH


def test_im2col_plain_version_is_the_tpu_script_loop():
    x = np.random.RandomState(0).rand(CIN, TD + 4, TH + 4, 128).astype(
        np.float32)
    want = np.zeros((80, NC, 128), np.float32)
    for ah in range(2):
        for aw in range(5):
            off = (ah * 5 + aw) * CIN
            for dd in range(TD):
                d2, lsb = dd // 2, dd % 2
                want[off:off + CIN, d2 * TH:(d2 + 1) * TH,
                     lsb * 64:(lsb + 1) * 64] = \
                    x[:, ah + dd, ah:ah + TH, aw:aw + 64]
    got = probes.probe_im2col(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the closed form the CUDA kernel gathers by
    r, col, lane = 3 * CIN + 5, 6, 70  # ah 0, aw 3, cin 5; d2 1, h 2; lsb 1
    assert got[r, col, lane] == x[5, 0 + 2 * 1 + 1, 0 + 2, 3 + 6]
    with pytest.raises(ValueError):
        probes.probe_im2col(torch.zeros(8, 8, 8, 64))


@pytest.mark.parametrize("shape", [(512, 128), (70, 36)])
def test_slice_transpose_plain_version(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    lo, hi = probes.probe_slice_transpose(torch.from_numpy(x))
    half = shape[1] // 2
    np.testing.assert_array_equal(lo.numpy(), x[:, :half].T)
    np.testing.assert_array_equal(hi.numpy(), x[:, half:].T)
    assert lo.is_contiguous() and hi.is_contiguous()
    with pytest.raises(ValueError):
        probes.probe_slice_transpose(torch.zeros(4, 5))


@pytest.mark.parametrize("n", [128, 64])
def test_dot_plain_version(n):
    rng = np.random.RandomState(2)
    a = (rng.randn(512, 1024) * 0.1).astype(np.float32)
    b = rng.rand(1024, 128).astype(np.float32)[:, :n].copy()
    got = probes.probe_dot_f32(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5
    with pytest.raises(ValueError):
        probes.probe_dot_f32(torch.zeros(4, 5), torch.zeros(4, 5))


def test_probes_are_registered_and_refuse_other_devices():
    assert set(PROBES) <= set(KERNELS)
    for name in PROBES:
        assert KERNELS[name][2] == "hiddenpose_tpu_torch/csrc/diag_probes.cu"
        assert KERNELS[name][3].startswith("scripts/tpu_diag_stem_paired.py:")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.probe_slice_transpose(torch.zeros(4, 4, device="meta"))
    x = torch.zeros(4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        probes.probe_slice_transpose(x)
