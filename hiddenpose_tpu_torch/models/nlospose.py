"""NlosPose: the composite model, for serving and for the train step.

Port of ``hiddenpose_tpu/models/nlospose.py``:

    meas (B, 1, T, H, W)
      -> FeatureExtraction (learned + corner-mask branches)
      -> LCT reconstruction (``ops/lct.py``)
      -> normalize_feature (min/max x10)
      -> UNet3d residual autoencoder
      -> PoseNet3D on (feature + refine)
      -> (heatmaps (B, J, Z, Y, X), refine (B, 1, T, H, W))

or, with ``backbone="posenet2d"``, ``visible_net`` (``models/posenet2d.py``)
flattens ``feature + refine`` to 2D channels and ``ResPoseNet2D`` emits
``num_joints * heatmap_size[0]`` depth-sliced maps, reshaped to heatmaps
(B, J, heatmap_size[0], H / 4, W / 4): at t128 (B, 24, 64, 32, 32), the
JAX package's shape.  That backbone has no kernel; FeatureExtraction and
the UNet run theirs as in the 3D model.

The external API keeps the JAX package's NCDHW conventions.  In eval mode
with grad mode off (serving) the kernels run with their fused epilogues;
in training they run through their ``autograd.Function``s (see
``models/posenet3d.py``).

``cfg.compute_dtype`` 'bfloat16' (``Config.with_bf16()``, the JAX server's
default) is the JAX package's mixed precision, for serving and training:
parameters stay float32 and are cast at use (their gradients come back
float32, Adam updates them in f32); FeatureExtraction and the UNet run on bf16
volumes (the FeatureExtraction's first conv on the input in its own type,
as the JAX kernel takes it); the LCT and the normalisation run in float32 (the LCT widens its
bf16 input); ``feature + refine`` promotes to float32 (``visible_net``
runs on it in f32 for the ``posenet2d`` backbone); either backbone's convs
round to bf16, its BatchNorms return float32; the heatmaps come out bf16
and the soft-argmax widens them.

In training the three rematerialisation knobs of ``cfg`` apply
(``utils/remat.py``): ``stage_remat`` (the default) recomputes
FeatureExtraction, the LCT and the UNet in the backward, as the JAX
package's ``nn.remat`` / ``jax.checkpoint`` do; ``posenet_remat`` and
``posenet_remat_stem`` PoseNet3D's blocks and stem.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from hiddenpose_tpu_torch import as_dtype, resolve_device
from hiddenpose_tpu_torch.config import ModelConfig
from hiddenpose_tpu_torch.models.blocks import (
    FeatureExtraction,
    StencilConv3,
    corner_mask,
)
from hiddenpose_tpu_torch.models.posenet2d import ResPoseNet2D, visible_net
from hiddenpose_tpu_torch.models.posenet3d import PoseNet3D
from hiddenpose_tpu_torch.models.unet3d import UNet3d
from hiddenpose_tpu_torch.ops.lct import (
    LCTParams,
    lct_apply,
    lct_apply_sharded,
    make_lct_params,
)
from hiddenpose_tpu_torch.ops.normalize import normalize_feature
from hiddenpose_tpu_torch.utils import tracing
from hiddenpose_tpu_torch.utils.remat import remat


class NlosPose(nn.Module):
    """``spatial_mesh``: a ``parallel/mesh.py::Mesh``; when set, the LCT's
    padded FFT cube is sharded on H over its 'model' axis
    (``ops/lct.py::lct_apply_sharded``), the JAX package's decomposition
    for grids whose padded spectrum exceeds one device's memory."""

    def __init__(self, cfg: ModelConfig, spatial_mesh=None):
        super().__init__()
        if cfg.backbone not in ("posenet3d_50", "posenet2d"):
            raise NotImplementedError(f"backbone {cfg.backbone!r}")
        self.cfg = cfg
        self.spatial_mesh = spatial_mesh
        self.compute_dtype = dt = as_dtype(cfg.compute_dtype)
        self.feature_extraction = FeatureExtraction(
            basedim=cfg.basedim, in_channels=cfg.in_channels, dtype=dt)
        self.autoencoder = UNet3d(in_channels=cfg.in_channels, n_channels=4,
                                  dtype=dt)
        if cfg.backbone == "posenet2d":
            # visible_net's values and depths: 2 x 4 channels a channel
            self.pose_net = ResPoseNet2D(in_channels=8 * cfg.in_channels,
                                         num_joints=cfg.num_joints,
                                         depth_dim=cfg.heatmap_size[0],
                                         dtype=dt)
        else:
            self.pose_net = PoseNet3D(
                num_joints=cfg.num_joints, dtype=dt,
                remat=cfg.posenet_remat, remat_stem=cfg.posenet_remat_stem)

    def set_use_kernels(self, flag: bool) -> None:
        """Route every kernelled op to its CUDA kernel (True, the default)
        or to its plain PyTorch version (False: a reference for the
        kernels on the GPU; the serving path never sets it)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = bool(flag)

    def lct(self, flat: torch.Tensor, lct: LCTParams) -> torch.Tensor:
        if self.spatial_mesh is not None:
            return lct_apply_sharded(flat, lct, self.spatial_mesh)
        return lct_apply(flat, lct, batch_chunk=self.cfg.lct_batch_chunk)

    def forward(self, meas: torch.Tensor,
                lct: LCTParams) -> Tuple[torch.Tensor, torch.Tensor]:
        # cfg.stage_remat: FeatureExtraction, the LCT and the UNet recompute
        # their activations in the backward (utils/remat.py)
        stage = remat if self.cfg.stage_remat else (lambda f, *a: f(*a))
        b = meas.shape[0]
        # device stages of a traced serving forward (utils/tracing.py)
        tracing.stage("stage.recon")
        x = stage(self.feature_extraction, meas)     # (B, ch, T, H, W)
        ch = x.shape[1]
        vol = stage(self.lct, x.reshape(b * ch, *x.shape[2:]), lct)
        feature = normalize_feature(vol.reshape(b, ch, *vol.shape[1:]))
        tracing.stage("stage.unet")
        refine = stage(self.autoencoder, feature)
        tracing.stage(None)
        if self.cfg.backbone == "posenet2d":
            hm2d = self.pose_net(visible_net(feature + refine))
            bh, _, hh, ww = hm2d.shape
            heatmaps = hm2d.reshape(bh, self.cfg.num_joints,
                                    self.cfg.heatmap_size[0], hh, ww)
        else:
            heatmaps = self.pose_net(feature + refine)
        return heatmaps.contiguous(), refine


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from an explicit generator, with the JAX package's
    initialisers: lecun-normal 3^3 stencil and UNet convs with zero bias,
    the corner mask, kaiming-normal (fan_out) PoseNet convs,
    normal(0.001) deconvs and 2D-backbone convs (zero bias), unit/zero
    norms and BN statistics."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, m in model.named_modules():
        if isinstance(m, (nn.ConvTranspose3d, nn.Conv2d,
                          nn.ConvTranspose2d)):
            normal_(m.weight, 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            if isinstance(m, StencilConv3) or name.startswith("autoencoder"):
                normal_(m.weight, fan_in ** -0.5)
            else:
                normal_(m.weight, (2.0 / fan_out) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm3d, nn.BatchNorm2d, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, (nn.BatchNorm3d, nn.BatchNorm2d)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, FeatureExtraction):
            m.weights.copy_(corner_mask(m.weights.shape[1]))


def build_nlospose(cfg: ModelConfig, device="cuda", seed: int = 0,
                   spatial_mesh=None) -> Tuple[NlosPose, LCTParams]:
    """The eval-mode model on ``device`` with random weights from ``seed``,
    plus its LCT constants.  ``device`` defaults to the GPU and raises
    without one; pass ``device="cpu"`` to run on the CPU.
    ``spatial_mesh``: see :class:`NlosPose`.

    For a CUDA device this turns TF32 off for cuDNN convolutions and
    matmuls: the float32 path is full float32, as the JAX package's
    'highest' precision (a bf16 model's convs are bf16 on the tensor cores
    whatever the flags).  The flags are process-wide, so they are set once here and
    never toggled around a forward, where two forwards in flight (two
    servers, or a caller beside the server's pump) would race on them."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = NlosPose(cfg, spatial_mesh=spatial_mesh)
    init_weights(model, torch.Generator().manual_seed(seed))
    if cfg.backbone == "posenet3d_50":
        model.pose_net.to(memory_format=torch.channels_last_3d)
    model = model.to(device).eval()
    lct = make_lct_params(
        image_size=cfg.image_size[0], time_size=cfg.time_size,
        bin_len=cfg.bin_len, wall_size=cfg.wall_size, mode=cfg.mode,
        material=cfg.material, device=device)
    return model, lct
