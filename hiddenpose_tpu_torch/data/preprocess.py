"""Measurement preprocessing (host side, numpy and scipy).

Port of ``hiddenpose_tpu/data/preprocess.py``:

* hdr decode + grayscale + max-normalise: the native decoder
  (``data/native_loader.py``), where the JAX package calls cv2;
* stacked-frame unpacking and pair-average rebinning;
* noise injection: a 1D Gaussian temporal blur + Poisson shot noise, the
  blur with cv2's own kernel (below) and no cv2;
* joint coordinate mapping to heatmap-voxel units;
* real-capture loading and the fk-capture re-binning path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.io import loadmat
from scipy.ndimage import correlate1d

from hiddenpose_tpu_torch.data.native_loader import decode_hdr_gray
from hiddenpose_tpu_torch.data.synthetic import map_joints_to_heatmap

__all__ = [
    "decode_hdr_gray", "gaussian_kernel", "blur_replicate", "add_noise",
    "unpack_frames", "rebin_pairs", "downsample_volume",
    "preprocess_measurement", "map_joints_to_heatmap", "load_realdata",
    "load_fk_measurement", "load_vol_mat",
]


def gaussian_kernel(sigma: float) -> np.ndarray:
    """The kernel ``cv2.GaussianBlur(ksize=(0, 0), sigmaX=sigma)`` takes on
    a float image: round(8 sigma + 1) | 1 taps (87 at the reference's
    10.61; scipy's ``gaussian_filter1d`` would take 85), exp(-x^2 /
    (2 sigma^2)) normalised to sum 1, in float64."""
    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur_replicate(flat: np.ndarray, sigma: float) -> np.ndarray:
    """cv2's Gaussian blur of a 1D float32 array (which cv2 reads as an
    N x 1 image) with BORDER_REPLICATE: the kernel along N, the edge
    values repeated; summed in float64, returned as float32."""
    k = gaussian_kernel(sigma)
    return correlate1d(np.asarray(flat, np.float64), k,
                       mode="nearest").astype(np.float32)


def add_noise(gray: np.ndarray, sigma: float = 10.61,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Temporal jitter + shot noise on the raw stacked-frame image: flatten,
    1D Gaussian blur (sigma = 25-bin FWHM / 2.355, replicate border),
    Poisson sample; the caller re-normalises by max."""
    flat = np.ascontiguousarray(gray.reshape(-1).astype(np.float32))
    lam = np.clip(blur_replicate(flat, sigma), 0.0, None)
    rng = rng or np.random
    return rng.poisson(lam).astype(np.float32).reshape(gray.shape)


def unpack_frames(gray: np.ndarray, t: int = 600,
                  crop: int = 512) -> np.ndarray:
    """(t*h, w) stacked frames -> (crop, h, w)."""
    th, w = gray.shape
    h = th // t
    return gray.reshape(t, h, w)[:crop]


def rebin_pairs(x: np.ndarray, axis: int) -> np.ndarray:
    """Average adjacent pairs along an axis ((a[::2] + a[1::2]) / 2)."""
    sl0 = [slice(None)] * x.ndim
    sl1 = [slice(None)] * x.ndim
    sl0[axis] = slice(0, None, 2)
    sl1[axis] = slice(1, None, 2)
    return (x[tuple(sl0)] + x[tuple(sl1)]) / 2


def downsample_volume(x: np.ndarray, count: int) -> np.ndarray:
    """Halve all three axes ``count`` times."""
    for _ in range(count):
        for axis in range(x.ndim):
            x = rebin_pairs(x, axis)
    return x


def preprocess_measurement(gray: np.ndarray, downsample_cnt: int = 1,
                           t: int = 600, crop: int = 512) -> np.ndarray:
    """Full meas path: unpack -> temporal pair-avg (512 -> 256) -> /2 on
    all axes per downsample_cnt.  Default yields (128, 128, 128)."""
    meas = unpack_frames(gray, t=t, crop=crop)
    meas = rebin_pairs(meas, axis=0)
    return downsample_volume(meas, downsample_cnt)


def load_realdata(path: str, downsample_cnt: int = 1) -> np.ndarray:
    """Measured capture: .mat['data_new'] (h, w, t) -> (t, w, h), temporal
    pair-avg, then /2 on all axes per count."""
    meas = np.transpose(loadmat(path)["data_new"],
                        (2, 1, 0)).astype(np.float32)
    meas = rebin_pairs(meas, axis=0)
    return downsample_volume(meas, downsample_cnt)


def load_fk_measurement(path: str, rebin_count: int = 2,
                        time_crop: Tuple[int, int] = (64, 192)
                        ) -> np.ndarray:
    """fk-dataset capture: .mat['meas'] (h, w, t); temporal pair-avg x
    rebin_count, time crop, -> (t, h, w)."""
    meas = loadmat(path)["meas"].astype(np.float32)
    for _ in range(rebin_count):
        meas = rebin_pairs(meas, axis=2)
    meas = meas[:, :, time_crop[0]:time_crop[1]]
    return np.transpose(meas, (2, 0, 1))


def load_vol_mat(path: str) -> np.ndarray:
    return loadmat(path)["vol"].astype(np.float32)
