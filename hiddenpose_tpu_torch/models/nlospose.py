"""NlosPose: the composite model, for serving and for the train step.

Port of ``hiddenpose_tpu/models/nlospose.py``:

    meas (B, 1, T, H, W)
      -> FeatureExtraction (learned + corner-mask branches)
      -> LCT reconstruction (``ops/lct.py``)
      -> normalize_feature (min/max x10)
      -> UNet3d residual autoencoder
      -> PoseNet3D on (feature + refine)
      -> (heatmaps (B, J, Z, Y, X), refine (B, 1, T, H, W))

The external API keeps the JAX package's NCDHW conventions.  In eval mode
with grad mode off (serving) the kernels run with their fused epilogues;
in training they run through their ``autograd.Function``s (see
``models/posenet3d.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from hiddenpose_tpu_torch.config import ModelConfig
from hiddenpose_tpu_torch.models.blocks import (
    FeatureExtraction,
    StencilConv3,
    corner_mask,
)
from hiddenpose_tpu_torch.models.posenet3d import PoseNet3D
from hiddenpose_tpu_torch.models.unet3d import UNet3d
from hiddenpose_tpu_torch.ops.lct import LCTParams, lct_apply, make_lct_params
from hiddenpose_tpu_torch.ops.normalize import normalize_feature


class NlosPose(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone != "posenet3d_50":
            raise NotImplementedError(
                f"backbone {cfg.backbone!r}: only posenet3d_50 is ported")
        self.cfg = cfg
        self.feature_extraction = FeatureExtraction(
            basedim=cfg.basedim, in_channels=cfg.in_channels)
        self.autoencoder = UNet3d(in_channels=cfg.in_channels, n_channels=4)
        self.pose_net = PoseNet3D(num_joints=cfg.num_joints)

    def set_use_kernels(self, flag: bool) -> None:
        """Route every kernelled op to its CUDA kernel (True, the default)
        or to its plain PyTorch version (False: a reference for the
        kernels on the GPU; the serving path never sets it)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = bool(flag)

    def forward(self, meas: torch.Tensor,
                lct: LCTParams) -> Tuple[torch.Tensor, torch.Tensor]:
        b = meas.shape[0]
        x = self.feature_extraction(meas)            # (B, ch, T, H, W)
        ch = x.shape[1]
        vol = lct_apply(x.reshape(b * ch, *x.shape[2:]), lct,
                        batch_chunk=self.cfg.lct_batch_chunk)
        feature = normalize_feature(vol.reshape(b, ch, *vol.shape[1:]))
        refine = self.autoencoder(feature)
        heatmaps = self.pose_net(feature + refine)
        return heatmaps.contiguous(), refine


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from an explicit generator, with the JAX package's
    initialisers: lecun-normal 3^3 stencil and UNet convs with zero bias,
    the corner mask, kaiming-normal (fan_out) PoseNet convs,
    normal(0.001) deconvs, unit/zero norms and BN statistics."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, m in model.named_modules():
        if isinstance(m, nn.ConvTranspose3d):
            normal_(m.weight, 0.001)
        elif isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            if isinstance(m, StencilConv3) or name.startswith("autoencoder"):
                normal_(m.weight, fan_in ** -0.5)
            else:
                normal_(m.weight, (2.0 / fan_out) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm3d, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm3d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, FeatureExtraction):
            m.weights.copy_(corner_mask(m.weights.shape[1]))


def build_nlospose(cfg: ModelConfig, device="cpu",
                   seed: int = 0) -> Tuple[NlosPose, LCTParams]:
    """The eval-mode model on ``device`` with random weights from ``seed``,
    plus its LCT constants.

    For a CUDA device this turns TF32 off for cuDNN convolutions and
    matmuls: the path is full float32, as the JAX package's 'highest'
    precision.  The flags are process-wide, so they are set once here and
    never toggled around a forward, where two forwards in flight (two
    servers, or a caller beside the server's pump) would race on them."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = NlosPose(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.pose_net.to(memory_format=torch.channels_last_3d)
    model = model.to(device).eval()
    lct = make_lct_params(
        image_size=cfg.image_size[0], time_size=cfg.time_size,
        bin_len=cfg.bin_len, wall_size=cfg.wall_size, mode=cfg.mode,
        material=cfg.material, device=device)
    return model, lct
