"""DeepVoxels, the reference's legacy NLOS feature-embedding composite.

Port of ``hiddenpose_tpu/models/deepvoxels.py``.  The forward is

    input (B, C, T, H, W)
      -> per-(b, c) min / max normalize
      -> Transient2Volumn (stride 2, the corner branch concatenated first)
      -> the LCT of every channel, folded into the batch, at half the
         spatial size and twice bin_len, in float32
      -> the depth axis cropped to z * 100 // 128
      -> ReLU -> normalize -> x 1e5

The reference's (disabled) training noise is :func:`deepvoxels_noise`,
which the forward does not apply, as in the reference.  The JAX module's
``jax.checkpoint`` around the LCT only saves memory and is not ported.
No hand-written kernel runs here: the 16 -> 16 ``ResConv3D`` convs are
past K1's gate (``models/blocks.py``), and the LCT is cuFFT and matmuls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from hiddenpose_tpu_torch import resolve_device
from hiddenpose_tpu_torch.models.blocks import Transient2Volumn, corner_mask
from hiddenpose_tpu_torch.ops.lct import LCTParams, lct_apply, make_lct_params
from hiddenpose_tpu_torch.ops.normalize import normalize


class DeepVoxels(nn.Module):
    """(B, C, T, H, W) -> (B, 1 + basedim, Zc, H/2, W/2) float32, Zc =
    (T/2) * 100 // 128.  ``basedim`` is the reference's nf0."""

    def __init__(self, basedim: int = 16, in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.downnet = Transient2Volumn(basedim, in_channels, dtype)

    def forward(self, x: torch.Tensor, lct: LCTParams) -> torch.Tensor:
        b = x.shape[0]
        h = self.downnet(normalize(x))
        ch = h.shape[1]
        vol = lct_apply(h.reshape(b * ch, *h.shape[2:]).float(), lct)
        vol = vol.reshape(b, ch, *vol.shape[1:])
        vol = vol[:, :, : vol.shape[2] * 100 // 128]
        return normalize(torch.relu(vol)) * 1.0e5


def deepvoxels_noise(data: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """The reference's (disabled) noise model: with n1, n2 standard normal
    draws of ``data``'s shape, gau = 0.05 + 0.03 n1 + data and the result
    0.03 n2 gau + gau.  The draws come from ``generator`` (on ``data``'s
    device), or are given as ``draws`` = (n1, n2): the JAX package draws
    from its own PRNG, which no torch generator reproduces."""
    if draws is None:
        n1, n2 = (torch.randn(data.shape, generator=generator,
                              device=data.device, dtype=data.dtype)
                  for _ in range(2))
    else:
        n1, n2 = draws
    gau = 0.05 + 0.03 * n1 + data
    return 0.03 * n2 * gau + gau


@torch.no_grad()
def init_deepvoxels(model: DeepVoxels, generator: torch.Generator) -> None:
    """The JAX package's initialisers from an explicit generator: every
    conv lecun-normal (fan-in scaled) with zero bias, the corner mask."""
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * fan_in ** -0.5)
            m.bias.zero_()
    down = model.downnet
    down.weights.copy_(corner_mask(down.weights.shape[1]))


def build_deepvoxels(basedim: int = 16, image_size: int = 256,
                     time_size: int = 512, bin_len: float = 0.01,
                     wall_size: float = 2.0, mode: str = "lct",
                     device="cuda", seed: int = 0
                     ) -> Tuple[DeepVoxels, LCTParams]:
    """The eval-mode model on ``device`` (the GPU by default; raises
    without one unless ``device="cpu"``) with random weights from
    ``seed``, and the LCT constants of the grid after the stride-2
    encoder: ``image_size // 2``, ``time_size // 2``, ``2 * bin_len``.
    TF32 off for a GPU, as ``build_nlospose`` sets it."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = DeepVoxels(basedim=basedim)
    init_deepvoxels(model, torch.Generator().manual_seed(seed))
    lct = make_lct_params(image_size=image_size // 2,
                          time_size=time_size // 2, bin_len=bin_len * 2,
                          wall_size=wall_size, mode=mode, device=device)
    return model.to(device).eval(), lct
