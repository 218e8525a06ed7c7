"""NumPy golden-reference LCT for numerical testing.

The port's own copy of ``hiddenpose_tpu/ops/lct_reference.py``: an
independent implementation of the reconstruction math that follows the
reference's literal construction (a dense M^2 x M resampling matrix
halved log2(M) times, full complex ``np.fft.fftn`` filtering, a meshgrid
PSF).  ``ops/lct.py`` (closed-form resampling, one-sided rFFT) is held
against it in ``tests/test_torch_lct.py``.  Only for small grids: the
dense intermediate is M^2 x M.
"""

from __future__ import annotations

import numpy as np


def resampling_operator_dense(M: int) -> tuple[np.ndarray, np.ndarray]:
    assert 2 ** int(np.log2(M)) == M
    x = np.arange(1, M * M + 1, dtype=np.float64)
    col = (np.ceil(np.sqrt(x)) - 1).astype(np.int64)
    mtx = np.zeros((M * M, M), dtype=np.float64)
    mtx[np.arange(M * M), col] = 1.0
    mtx = mtx / np.sqrt(x)[:, None]
    for _ in range(int(np.log2(M))):
        mtx = 0.5 * (mtx[0::2, :] + mtx[1::2, :])
    return mtx.astype(np.float32), mtx.T.astype(np.float32).copy()


def define_psf_meshgrid(N: int, M: int, slope: float) -> np.ndarray:
    x = np.arange(2 * N, dtype=np.float32) / (2 * N - 1) * 2 - 1
    z = np.arange(2 * M, dtype=np.float32) / (2 * M - 1) * 2
    gy, gx, gz = np.meshgrid(x, x, z)  # the reference's meshgrid order
    a = (4 * slope) ** 2 * (gx ** 2 + gy ** 2) - gz
    b = np.abs(a)
    c = b.min(axis=2, keepdims=True)
    d = (np.abs(b - c) < 1e-8).astype(np.float32)
    e = d / np.sqrt(d.sum())
    f = np.roll(np.roll(e, N, axis=0), N, axis=1)
    return np.transpose(f, (2, 0, 1))


def lct_numpy(meas_thw: np.ndarray, bin_len: float, wall_size: float = 2.0,
              snr: float = 1e-1, material: str = "diffuse",
              mode: str = "lct") -> np.ndarray:
    """Single-volume LCT, (T, H, W) -> (T, H, W) float32."""
    T, H, W = meas_thw.shape
    assert H == W
    c = 3e8
    width = wall_size / 2.0
    trange = T * c * (bin_len / c)
    slope = width / trange

    gridz = np.arange(T, dtype=np.float32) / (T - 1)
    power = 4 if material == "diffuse" else 2
    data = meas_thw.astype(np.float32) * (gridz ** power)[:, None, None]

    mtx, mtxi = resampling_operator_dense(T)
    data = (mtx @ data.reshape(T, -1)).reshape(T, H, W)

    pad = np.zeros((2 * T, 2 * H, 2 * W), dtype=np.float32)
    pad[:T, :H, :W] = data

    fpsf = np.fft.fftn(define_psf_meshgrid(H, T, slope))
    if mode == "lct":
        invpsf = np.conjugate(fpsf) / (1.0 / snr + np.abs(fpsf) ** 2)
    else:
        invpsf = np.conjugate(fpsf)

    vol = np.real(np.fft.ifftn(np.fft.fftn(pad) * invpsf))[:T, :H, :W]
    vol = (mtxi @ vol.reshape(T, -1)).reshape(T, H, W)
    return vol.astype(np.float32)
