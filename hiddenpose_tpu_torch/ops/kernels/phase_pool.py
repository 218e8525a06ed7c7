"""K3: MaxPool3d(3, stride 2, padding 1) on the stem output, NDHWC.

Replaces ``hiddenpose_tpu/ops/pallas/phase_pool.py::phase_maxpool_pallas``
(body ``_phase_pool_fwd_kernel``).  The TPU kernel pools the stem output
in its space-to-depth phase layout (B, D/2, H/2, W/2, 8C); the port's stem
writes full resolution, so this pool takes (B, D, H, W, C) and returns
(B, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1, C).  Padded positions never win,
as with the TPU kernel's float32-min padding.  The CUDA source is
``csrc/phase_pool.cu``; its header says what bounds it (device memory
bandwidth) and how its access pattern answers that.

On a CPU tensor the wrapper runs :func:`maxpool3d_k3s2p1_ref`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build


def pooled_extent(n: int) -> int:
    return (n - 1) // 2 + 1


def maxpool3d_k3s2p1_ref(y):
    """Plain version: ``F.max_pool3d(3, 2, 1)`` on the NCDHW view."""
    out = F.max_pool3d(y.permute(0, 4, 1, 2, 3), 3, 2, 1)
    return out.permute(0, 2, 3, 4, 1).contiguous()


def maxpool3d_k3s2p1(y):
    """y (B, D, H, W, C) float32 contiguous, C % 4 == 0 -> pooled NDHWC."""
    if y.dim() != 5:
        raise ValueError(f"y must be (B, D, H, W, C), got {tuple(y.shape)}")
    b, d, h, w, c = y.shape
    if c % 4:
        raise ValueError(f"channels must be a multiple of 4, got {c}")
    dev = y.device
    _build.check(y, "y", device=dev, aligned=True)
    if dev.type == "cpu":
        return maxpool3d_k3s2p1_ref(y)
    if dev.type != "cuda":
        raise ValueError(f"maxpool3d_k3s2p1: unsupported device {dev}")

    od, oh, ow = pooled_extent(d), pooled_extent(h), pooled_extent(w)
    out = torch.empty((b, od, oh, ow, c), device=dev, dtype=torch.float32)
    _build.launch("hp_maxpool3d_k3s2p1", y.data_ptr(), out.data_ptr(),
                  b, d, h, w, c, od, oh, ow)
    maxpool3d_k3s2p1.launches += 1
    return out


maxpool3d_k3s2p1.launches = 0
