"""Virtual-wave (phasor-field) helper ops.

Port of ``hiddenpose_tpu/ops/wave.py``: the Gaussian-windowed quadrature
kernels of the phasor reconstruction method that the reference keeps
disabled, and their 'same' convolution along the time axis of every wall
pixel at once.  The kernels are built on the host in numpy; the
convolution runs on the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

C_LIGHT = 3e8


def gaussian_window(length: int, alpha: float) -> np.ndarray:
    """MATLAB-style gausswin: exp(-0.5 (alpha n / (N/2))^2), n centred."""
    n = length - 1
    k = np.arange(length, dtype=np.float64) - n / 2.0
    return np.exp(-0.5 * (alpha * k / (n / 2.0)) ** 2).astype(np.float32)


def virtual_wave_kernels(bin_resolution: float, virtual_wavelength: float,
                         cycles: float, sigma: float = 0.3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos_kernel, sin_kernel): a Gaussian-windowed quadrature pair."""
    s_z = bin_resolution * C_LIGHT
    samples = int(round(cycles * virtual_wavelength / s_z))
    num_cycles = samples * s_z / virtual_wavelength
    grid = np.arange(1, samples + 1, dtype=np.float64)
    phase = 2 * np.pi * num_cycles * grid / samples
    window = gaussian_window(samples, 1.0 / sigma).astype(np.float64)
    cos_k = (np.cos(phase) * window).astype(np.float32)
    sin_k = (np.sin(phase) * window).astype(np.float32)
    return cos_k, sin_k


def wave_convolve(data_thw: torch.Tensor, bin_resolution: float,
                  virtual_wavelength: float, cycles: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wave_cos, wave_sin), each (T, H, W) float32: ``np.convolve(...,
    mode='same')`` of every pixel's transient with the quadrature kernels,
    as one batched ``conv1d`` (a correlation) on the reversed kernel with
    a (K // 2, K - 1 - K // 2) zero pad."""
    cos_k, sin_k = virtual_wave_kernels(bin_resolution, virtual_wavelength,
                                        cycles)
    t, h, w = data_thw.shape
    sig = data_thw.float().reshape(t, h * w).T[:, None, :]  # (HW, 1, T)

    def conv_same(kernel):
        k = kernel.shape[0]
        rhs = torch.from_numpy(np.ascontiguousarray(kernel[::-1])).to(
            sig.device).reshape(1, 1, k)
        out = F.conv1d(F.pad(sig, (k // 2, k - 1 - k // 2)), rhs)
        return out[:, 0, :].T.reshape(t, h, w)

    return conv_same(cos_k), conv_same(sin_k)
