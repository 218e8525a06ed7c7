"""TF32 rounding and the hi / lo split of the 3xTF32 kernels (K4, K4-dx, K9),
in plain PyTorch, bit for bit what the kernels do with ``cvt.rna.tf32.f32``.
"""

from __future__ import annotations

import torch


def tf32_round(t):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: half a TF32 ulp is added to the
    bit pattern's magnitude and the low 13 bits are cleared.  Infinities
    and zeros come back unchanged."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """(hi, lo), both TF32 values held in float32, with ``hi + lo`` within
    2^-22 relative of ``t``: ``hi = tf32(t)``, ``lo = tf32(t - hi)`` (the
    difference is exact in float32)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)
