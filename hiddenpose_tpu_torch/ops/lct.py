"""Batched Light-Cone-Transform reconstruction in PyTorch.

Port of ``hiddenpose_tpu/ops/lct.py`` (``make_lct_params`` and
``lct_apply``): radiometric falloff, M x M temporal resampling, 2x zero
pad, one-sided rFFT, Wiener multiply, inverse rFFT, crop, inverse
resampling, and for the 'bp' mode the LoG sharpening with the first slice
zeroed.  The inverse filter is one complex64 tensor; the JAX package
stores it as split real/imaginary planes only to work around its TPU
runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.ops import psf as psf_ops

C_LIGHT = 3e8


@dataclasses.dataclass(frozen=True)
class LCTParams:
    """Device constants of one LCT configuration (T = M, H = W = N).

    gridz (M,), mtx (M, M), mtxi (M, M), invpsf (2M, 2N, N+1) complex64,
    lapw (5, 5, 5) in 'bp' mode else None."""

    gridz: torch.Tensor
    mtx: torch.Tensor
    mtxi: torch.Tensor
    invpsf: torch.Tensor
    lapw: Optional[torch.Tensor]
    time_size: int
    image_size: int
    material: str
    mode: str


def make_lct_params(image_size: int, time_size: int, bin_len: float,
                    wall_size: float = 2.0, mode: str = "lct",
                    material: str = "diffuse", snr: float = 1e-1,
                    device="cuda") -> LCTParams:
    """Precompute the LCT constants on the host and move them to ``device``
    (the GPU by default; raises without one unless ``device="cpu"``).

    slope = (wall_size / 2) / (T * bin_len), as in the JAX package."""
    device = resolve_device(device)
    if 2 ** int(np.log2(time_size)) != time_size:
        raise ValueError(f"time_size must be a power of 2, got {time_size}")
    if mode not in ("lct", "bp"):
        raise ValueError(f"mode must be 'lct' or 'bp', got {mode!r}")
    if material not in ("diffuse", "specular"):
        raise ValueError(f"material must be 'diffuse' or 'specular', "
                         f"got {material!r}")

    width = wall_size / 2.0
    bin_resolution = bin_len / C_LIGHT
    trange = time_size * C_LIGHT * bin_resolution
    slope = width / trange

    gridz = np.arange(time_size, dtype=np.float32) / (time_size - 1)
    mtx, mtxi = psf_ops.resampling_operator(time_size)
    invpsf = psf_ops.wiener_inverse_psf(
        image_size, time_size, slope, snr=snr, mode=mode, onesided=True)
    lapw = psf_ops.filter_laplacian() if mode == "bp" else None

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LCTParams(
        gridz=dev(gridz), mtx=dev(mtx), mtxi=dev(mtxi), invpsf=dev(invpsf),
        lapw=None if lapw is None else dev(lapw),
        time_size=int(time_size), image_size=int(image_size),
        material=material, mode=mode,
    )


def embed_time_window(x: torch.Tensor, time_begin: int, time_end: int,
                      time_size: int) -> torch.Tensor:
    """Place a (B, t, H, W) measurement into the [0, time_size) window."""
    b, t, h, w = x.shape
    if time_end - time_begin != t or time_begin < 0 or time_end > time_size:
        raise ValueError(f"window [{time_begin}, {time_end}) does not fit "
                         f"{t} bins into {time_size}")
    if t == time_size:
        return x
    out = x.new_zeros((b, time_size, h, w))
    out[:, time_begin:time_end] = x
    return out


def _resample(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, M) @ (B, M, H, W) over the time axis, one matmul."""
    b, t, h, w = x.shape
    return torch.matmul(mat, x.reshape(b, t, h * w)).reshape(b, t, h, w)


def lct_apply(meas: torch.Tensor, params: LCTParams, time_begin: int = 0,
              time_end: Optional[int] = None,
              batch_chunk: int = 0) -> torch.Tensor:
    """(B, T', H, W) measurements -> (B, T, H, W) float32 volumes.

    ``batch_chunk`` > 0 (dividing B) runs the FFT section one chunk at a
    time, so the 2x-padded buffers are live for one chunk only."""
    b_total = meas.shape[0]
    if (batch_chunk and b_total > batch_chunk
            and b_total % batch_chunk == 0):
        return torch.cat([
            lct_apply(meas[i:i + batch_chunk], params, time_begin, time_end)
            for i in range(0, b_total, batch_chunk)
        ])

    T, N = params.time_size, params.image_size
    if time_end is None:
        time_end = time_begin + meas.shape[1]
    x = embed_time_window(meas, time_begin, time_end, T)
    b = x.shape[0]
    if tuple(x.shape) != (b, T, N, N):
        raise ValueError(f"bad meas shape {tuple(x.shape)}")
    x = x.float()

    power = 4 if params.material == "diffuse" else 2
    x = x * (params.gridz ** power)[None, :, None, None]
    x = _resample(params.mtx, x)

    # rfftn's s= zero-pads to (2T, 2N, 2N) on the far side of each axis.
    freq = torch.fft.rfftn(x, s=(2 * T, 2 * N, 2 * N), dim=(1, 2, 3))
    vol = torch.fft.irfftn(freq * params.invpsf[None],
                           s=(2 * T, 2 * N, 2 * N), dim=(1, 2, 3))
    vol = vol[:, :T, :N, :N]
    vol = _resample(params.mtxi, vol)

    if params.mode == "bp":
        p = (params.lapw.shape[0] - 1) // 2
        padded = F.pad(vol[:, None], (p,) * 6, mode="replicate")
        vol = F.conv3d(padded, params.lapw[None, None])[:, 0]
        vol[:, :1] = 0.0
    return vol


def lct_apply_bdthw(meas: torch.Tensor, params: LCTParams,
                    time_begin: int = 0,
                    time_end: Optional[int] = None) -> torch.Tensor:
    """The channelled form of the reference's call: meas (B, D, T', H, W)
    -> (B, D, T, H, W), the channels folded into the batch."""
    b, d = meas.shape[:2]
    flat = meas.reshape(b * d, *meas.shape[2:])
    vol = lct_apply(flat, params, time_begin, time_end)
    return vol.reshape(b, d, *vol.shape[1:])
