"""Batched Light-Cone-Transform reconstruction in PyTorch.

Port of ``hiddenpose_tpu/ops/lct.py`` (``make_lct_params``,
``lct_apply`` and ``lct_apply_sharded``): radiometric falloff, M x M
temporal resampling, 2x zero pad, one-sided rFFT, Wiener multiply,
inverse rFFT, crop, inverse resampling, and for the 'bp' mode the LoG
sharpening with the first slice zeroed.  The inverse filter is one complex64 tensor; the JAX package
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


class _AllToAll(torch.autograd.Function):
    """All-to-all over a group: ``x`` cut into ``n`` chunks along
    ``split_dim``, chunk j sent to rank j, the chunks received concatenated
    along ``concat_dim`` in rank order.  Its gradient is the reverse
    all-to-all.  A complex tensor travels as its real view."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return _all_to_all(g, concat_dim, split_dim, group), None, None, None


def _all_to_all(x, split_dim, concat_dim, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    cplx = x.is_complex()
    xs = torch.view_as_real(x) if cplx else x
    xs = xs.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    chunks = out.view(n, xs.shape[0] // n, *xs.shape[1:]).unbind(0)
    y = torch.cat([c.movedim(0, split_dim) for c in chunks], dim=concat_dim)
    return torch.view_as_complex(y.contiguous()) if cplx else y


def lct_apply_sharded(meas: torch.Tensor, params: LCTParams, mesh,
                      time_begin: int = 0,
                      time_end: Optional[int] = None) -> torch.Tensor:
    """:func:`lct_apply` with the padded (2T, 2N, 2N) FFT cube sharded on H
    over ``mesh``'s 'model' axis (a ``parallel/mesh.py::Mesh``), the JAX
    package's hand-rolled distributed FFT:

    1. this rank takes its H slice of the padded cube (the batch is the
       rank's own share of the data axis; every 'model' rank holds it
       whole); rFFT over W and FFT over T on the slice;
    2. an all-to-all moves the shards H -> T;
    3. FFT over the now whole H, the Wiener multiply with this rank's T
       slice of the inverse PSF, iFFT over H;
    4. an all-to-all back T -> H; iFFT over T, irFFT over W;

    then the crop and the inverse resampling of the whole volume, whose H
    slices are gathered from the 'model' ranks.  Differentiable (each
    all-to-all's gradient is the reverse one; the slice's and the
    gather's are each other, as every 'model' rank computes the same
    loss).  cuFFT through
    ``torch.fft``.  The 'bp' mode's LoG sharpening is not applied, as in
    the JAX function.  2T and 2N must divide by the 'model' size."""
    from hiddenpose_tpu_torch.parallel.sharding_rules import (
        GatherReplicated,
        SliceReplicated,
    )

    T, N = params.time_size, params.image_size
    if time_end is None:
        time_end = time_begin + meas.shape[1]
    x = embed_time_window(meas, time_begin, time_end, T)
    b = x.shape[0]
    if tuple(x.shape) != (b, T, N, N):
        raise ValueError(f"bad meas shape {tuple(x.shape)}")
    n, m = mesh.shape["model"], mesh.index("model")
    if (2 * N) % n or (2 * T) % n:
        raise ValueError(f"2T = {2 * T} and 2N = {2 * N} must divide by the "
                         f"'model' size {n}")
    group = mesh.group("model")
    x = x.float()
    power = 4 if params.material == "diffuse" else 2
    x = x * (params.gridz ** power)[None, :, None, None]
    x = _resample(params.mtx, x)

    rows = SliceReplicated.apply(F.pad(x, (0, 0, 0, N)), 2, group, m)
    pad = F.pad(rows, (0, N, 0, 0, 0, T))          # (b, 2T, 2N / n, 2N)
    f = torch.fft.rfft(pad, dim=3)
    f = torch.fft.fft(f, dim=1)
    f = _AllToAll.apply(f, 1, 2, group)            # (b, 2T / n, 2N, N + 1)
    f = torch.fft.fft(f, dim=2)
    t = 2 * T // n
    f = f * params.invpsf[m * t:(m + 1) * t][None]
    f = torch.fft.ifft(f, dim=2)
    f = _AllToAll.apply(f, 2, 1, group)            # (b, 2T, 2N / n, N + 1)
    f = torch.fft.ifft(f, dim=1)
    vol = torch.fft.irfft(f, n=2 * N, dim=3)
    vol = GatherReplicated.apply(vol.contiguous(), 2, group, m)
    vol = vol[:, :T, :N, :N]
    return _resample(params.mtxi, vol)


def lct_apply_bdthw(meas: torch.Tensor, params: LCTParams,
                    time_begin: int = 0,
                    time_end: Optional[int] = None) -> torch.Tensor:
    """The channelled form of the reference's call: meas (B, D, T', H, W)
    -> (B, D, T, H, W), the channels folded into the batch."""
    b, d = meas.shape[:2]
    flat = meas.reshape(b * d, *meas.shape[2:])
    vol = lct_apply(flat, params, time_begin, time_end)
    return vol.reshape(b, d, *vol.shape[1:])
