"""The light-cone transform, written out from its definition.

The constants follow HiddenPose's own construction (``utils/helper.py``):
the temporal resampling matrix built as an M^2 x M one-hot of
ceil(sqrt(i)) - 1 scaled by 1/sqrt(i) and halved log2(M) times, the
light-cone PSF as the argmin-over-z indicator on a meshgrid, rolled by N,
and the Wiener filter conj(F) / (1 / snr + |F|^2) of its full complex FFT.
A volume is filtered by a full complex FFT of the (2T, 2N, 2N) zero-padded
cube, all in float32 / complex64 on the device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def resampling(m: int):
    """(mtx, mtxi), (M, M) float32."""
    if 2 ** int(np.log2(m)) != m:
        raise ValueError(f"time size {m} is not a power of 2")
    i = np.arange(1, m * m + 1, dtype=np.float64)
    col = (np.ceil(np.sqrt(i)) - 1).astype(np.int64)
    mtx = np.zeros((m * m, m), dtype=np.float64)
    mtx[np.arange(m * m), col] = 1.0
    mtx /= np.sqrt(i)[:, None]
    for _ in range(int(np.log2(m))):
        mtx = 0.5 * (mtx[0::2] + mtx[1::2])
    return mtx.astype(np.float32), mtx.T.astype(np.float32).copy()


def light_cone_psf(n: int, m: int, slope: float, device) -> torch.Tensor:
    """(2M, 2N, 2N) float32."""
    x = torch.arange(2 * n, dtype=torch.float32, device=device) \
        / (2 * n - 1) * 2 - 1
    z = torch.arange(2 * m, dtype=torch.float32, device=device) \
        / (2 * m - 1) * 2
    gy, gx, gz = torch.meshgrid(x, x, z, indexing="xy")
    a = (4 * slope) ** 2 * (gx ** 2 + gy ** 2) - gz
    b = a.abs()
    c = b.amin(2, keepdim=True)
    d = ((b - c).abs() < 1e-8).float()
    e = d / d.sum().sqrt()
    f = torch.roll(e, (n, n), (0, 1))
    return f.permute(2, 0, 1).contiguous()


class LCT:
    """Callable (B, T, N, N) -> (B, T, N, N) float32 for one
    configuration: diffuse falloff z^4, resampling, Wiener filtering,
    inverse resampling."""

    def __init__(self, model: dict, device, snr: float = 0.1):
        if model["mode"] != "lct" or model["material"] != "diffuse":
            raise NotImplementedError("the reference covers mode 'lct', "
                                      "material 'diffuse'")
        t, n = model["time_size"], model["image_size"][0]
        slope = (model["wall_size"] / 2.0) / (t * model["bin_len"])
        self.t, self.n = t, n
        self.gridz4 = (torch.arange(t, dtype=torch.float32, device=device)
                       / (t - 1)) ** 4
        mtx, mtxi = resampling(t)
        self.mtx = torch.from_numpy(mtx).to(device)
        self.mtxi = torch.from_numpy(mtxi).to(device)
        fpsf = torch.fft.fftn(light_cone_psf(n, t, slope, device))
        self.invpsf = fpsf.conj() / (1.0 / snr + fpsf.abs() ** 2)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        t, n = self.t, self.n
        out = []
        for v in x:
            v = v * self.gridz4[:, None, None]
            v = (self.mtx @ v.reshape(t, -1)).reshape(t, n, n)
            pad = F.pad(v, (0, n, 0, n, 0, t))
            vol = torch.fft.ifftn(torch.fft.fftn(pad) * self.invpsf).real
            vol = vol[:t, :n, :n]
            out.append((self.mtxi @ vol.reshape(t, -1)).reshape(t, n, n))
        return torch.stack(out)
