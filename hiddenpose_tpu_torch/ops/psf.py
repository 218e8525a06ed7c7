"""Host-side precompute for the Light-Cone Transform (LCT).

Produces the constant operators the LCT needs: the light-cone point-spread
function, the temporal resampling matrices, and the Laplacian-of-Gaussian
sharpening kernel used by back-projection mode.

Semantics match the reference precompute (`/root/reference/utils/helper.py:13-125`,
duplicated at `models/feature_propagation.py:111-171`) but the construction is
re-derived:

* ``resampling_operator`` builds the M x M matrix directly in closed form
  instead of materialising the M^2 x M sparse matrix and halving it log2(M)
  times: the K=log2(M) row-pair averagings exactly group rows into contiguous
  blocks of M, so entry (r, c) is the block average of 1/sqrt(i) over the rows
  i in (rM, (r+1)M] whose quantised sqrt bucket is c.
* ``define_psf`` computes the same argmin-over-z light-cone indicator without
  the 3-way meshgrid transpose dance.

All functions run once on the host in NumPy; the results are uploaded to the
device as part of :class:`hiddenpose_tpu.ops.lct.LCTParams`.
"""

from __future__ import annotations

import numpy as np


def resampling_operator(temporal_grid: int) -> tuple[np.ndarray, np.ndarray]:
    """Temporal resampling matrices (mtx, mtxi), each (M, M) float32.

    Matches `utils/helper.py:35-69`: mtx is the log2(M)-times row-halved
    version of diag(1/sqrt(i)) @ onehot(ceil(sqrt(i))-1), mtxi = mtx.T.
    """
    M = int(temporal_grid)
    assert 2 ** int(np.log2(M)) == M, "temporal grid must be a power of 2"

    i = np.arange(1, M * M + 1, dtype=np.float64)
    # Which output column each fine-grid row lands in: ceil(sqrt(i)) - 1.
    col = np.ceil(np.sqrt(i)).astype(np.int64) - 1
    # Each of the K halvings averages adjacent row pairs with weight 1/2;
    # after K = log2(M) rounds, row blocks of size 2^K = M collapse with
    # uniform weight 1/M.
    row = (np.arange(M * M) // M).astype(np.int64)
    weight = (1.0 / np.sqrt(i)) / M

    mtx = np.zeros((M, M), dtype=np.float64)
    np.add.at(mtx, (row, col), weight)
    mtx = mtx.astype(np.float32)
    return mtx, mtx.T.copy()


def define_psf(spatial_grid: int, temporal_grid: int, slope: float) -> np.ndarray:
    """Light-cone PSF, shape (2M, 2N, 2N) float32, fftshifted in x/y.

    Matches `utils/helper.py:72-125`: an indicator of the z-bin (per (x, y))
    minimising |(4*slope)^2 (x^2+y^2) - z| over z in [0, 2), normalised to
    unit L2 mass and rolled by N in both spatial axes so the cone apex sits
    at the spatial origin of the FFT grid.
    """
    N = int(spatial_grid)
    M = int(temporal_grid)

    x = np.arange(2 * N, dtype=np.float32) / (2 * N - 1) * 2 - 1  # [-1, 1]
    z = np.arange(2 * M, dtype=np.float32) / (2 * M - 1) * 2       # [0, 2]

    # radius^2 term on the (y, x) plane; broadcast against the z axis.
    r2 = x[None, :, None] ** 2 + x[None, None, :] ** 2               # (1,2N,2N)
    cone = (4.0 * slope) ** 2 * r2 - z[:, None, None]                # (2M,2N,2N)
    dist = np.abs(cone)

    hit = np.abs(dist - dist.min(axis=0, keepdims=True)) < 1e-8
    psf = hit.astype(np.float32)
    psf /= np.sqrt(psf.sum())

    psf = np.roll(psf, shift=N, axis=1)
    psf = np.roll(psf, shift=N, axis=2)
    return psf


def filter_laplacian(hsize: int = 5, std1: float = 1.0) -> np.ndarray:
    """Laplacian-of-Gaussian sharpening kernel, (hsize,)*3 float32.

    Matches `utils/helper.py:13-32`; used only by the 'bp' reconstruction
    mode (`models/feature_propagation.py:103-107,246-253`).
    """
    lim = (hsize - 1) // 2
    std2 = std1 ** 2
    d = np.arange(-lim, lim + 1, dtype=np.float32)
    # meshgrid(y, x, z) with equal axes is symmetric; use broadcasting.
    r2 = d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2
    w = np.exp(-r2 / (2 * std2))
    w /= w.sum()
    w1 = w * (r2 - 3 * std2) / (std2 ** 2)
    return (w1 - w1.mean()).astype(np.float32)


def wiener_inverse_psf(
    spatial_grid: int,
    temporal_grid: int,
    slope: float,
    snr: float = 1e-1,
    mode: str = "lct",
    onesided: bool = True,
) -> np.ndarray:
    """Frequency-domain inverse filter, complex64.

    'lct' mode is the Wiener deconvolution filter conj(F)/(1/snr + |F|^2)
    (`models/feature_propagation.py:91-94`); 'bp' is plain conj(F).

    With ``onesided=True`` only the non-negative frequencies of the last axis
    are kept, shape (2M, 2N, N+1): the PSF is real so its spectrum is
    conjugate-symmetric and the LCT can run on a one-sided rFFT, halving FFT
    work and memory versus the reference's full complex `torch.rfft(...,
    onesided=False)` (`models/feature_propagation.py:228`).
    """
    psf = define_psf(spatial_grid, temporal_grid, slope)
    fpsf = np.fft.fftn(psf)
    if mode == "lct":
        inv = np.conjugate(fpsf) / (1.0 / snr + np.abs(fpsf) ** 2)
    elif mode == "bp":
        inv = np.conjugate(fpsf)
    else:
        raise ValueError(f"unknown LCT mode {mode!r}")
    if onesided:
        inv = inv[:, :, : spatial_grid + 1]
    return inv.astype(np.complex64)
