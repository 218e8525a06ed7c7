"""The model and training configuration of the port.

``hiddenpose_tpu/config.py``'s ``ModelConfig`` (every field the models
read, the three rematerialisation knobs included), ``DatasetConfig`` and
``TrainConfig`` field for field, and the run fields of ``Config`` (log and
checkpoint directories, phase, eval batch sizes, loader workers), with
the same defaults and the same presets, so the port runs where the JAX
package is not installed.  Only ``param_dtype`` is left out: the port's
parameters are float32.  Any object with these attributes (the JAX
package's ``Config`` included) is accepted wherever a config is.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """The reference defaults (``config/config_noise.py`` MODEL node)."""

    basedim: int = 1
    bin_len: float = 0.01
    wall_size: float = 2.0
    in_channels: int = 1
    grid_dim: int = 256
    time_size: int = 512
    image_size: Tuple[int, int] = (256, 256)
    heatmap_size: Tuple[int, int, int] = (64, 64, 64)
    patch_size: int = 4
    mode: str = "lct"  # 'lct' | 'bp'
    material: str = "diffuse"  # 'diffuse' | 'specular'
    num_joints: int = 24
    backbone: str = "posenet3d_50"  # or 'posenet2d'
    # Transformer family (``models/sformer.py::sformer_from_config``)
    patch_feature_dim: int = 256
    depth: int = 8
    heads: int = 8
    dim_head: int = 32
    # carried for the JAX package's config, which no module reads
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    rotary_emb: bool = True
    out_dim: int = (64 * 2 + 128) * 2
    num_frames: int = 16
    # activation dtype of NlosPose's convolutions and of the transformer's
    # Linear layers: 'float32' or 'bfloat16' (parameters, normalisation
    # statistics, the LCT and the soft-argmax stay float32; parameters are
    # cast at use)
    compute_dtype: str = "float32"
    # LCT FFT batch chunking (0 = fully batched)
    lct_batch_chunk: int = 0
    # substitute a pretrained UNet3d (train/pretrain.py) and freeze it
    pretrain_autoencoder: bool = False
    pretrain_autoencoder_path: str = "./lib/nlos_unet.pth"
    # Rematerialisation in training (``utils/remat.py``): the backward
    # recomputes a stage's forward instead of keeping its activations.
    # ``stage_remat``: FeatureExtraction, the LCT and the UNet
    # (``models/nlospose.py``); ``posenet_remat``: each residual block of
    # PoseNet3D; ``posenet_remat_stem``: its stem (conv, BN, ReLU, pool).
    # The JAX package's defaults; the results are the same either way.
    stage_remat: bool = True
    posenet_remat: bool = False
    posenet_remat_stem: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    """The reference defaults (``config/config_noise.py`` DATASET node)."""

    name: str = "NlosPoseDataset"
    num_joints: int = 24
    target_type: str = "gaussian"
    heatmap_size: Tuple[int, int, int] = (64, 64, 64)
    vol_size: Tuple[int, int, int] = (256, 256, 256)
    downsample_cnt: int = 1
    sigma: float = 2.0
    use_different_joints_weight: bool = True
    phase: str = "train"
    train_path: str = "/data2/nlospose/pose_v2_noise"
    valid_path: str = "/data2/nlospose/pose_v2_noise"
    test_path: str = "/data2/nlospose/pose_v2_noise"
    simdr_split_ratio: int = 2
    # the noise model of the reference's _noise dataloader
    # (data/preprocess.py::add_noise)
    noise: bool = False
    noise_gaussian_sigma: float = 10.61


@dataclass(frozen=True)
class TrainConfig:
    """The reference defaults (``config/config_noise.py`` TRAIN node)."""

    optimizer: str = "adam"
    lr: float = 1e-3
    lr_factor: float = 0.2
    lr_step: Tuple[int, ...] = (2, 4, 13)
    batch_size: int = 2
    begin_epoch: int = 0
    end_epoch: int = 15
    seed: int = 410
    # The reference calls lr_scheduler.step() BEFORE each epoch, so epoch e
    # trains with the schedule already advanced to e + 1 (train/optim.py).
    step_before_epoch: bool = True
    loss_type: str = "L2JointLocationLoss"
    label_smoothing: float = 0.2
    # 'default' | 'high' | 'highest' (train/step.py: the library in TF32
    # below 'highest', the Bottleneck dx in one bf16 pass at 'default');
    # make_train_step itself defaults to 'highest'.
    matmul_precision: str = "default"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "./log"
    result_dir: str = "./result"
    final_output_dir: str = "./checkpoints"
    phase: str = "train"
    test_batch_size: int = 2
    valid_batch_size: int = 1
    num_workers: int = 8

    def with_bf16(self) -> "Config":
        """Mixed precision: convolutions and matmuls in bfloat16, parameters,
        normalisation statistics, the LCT and the soft-argmax in float32."""
        return replace(self, model=replace(self.model,
                                           compute_dtype="bfloat16"))

    def preset_t128(self) -> "Config":
        """The live training configuration: bin_len x4, T=128,
        128x128 wall, 128^3 grid."""
        return replace(self, model=replace(
            self.model, bin_len=self.model.bin_len * 4, time_size=128,
            image_size=(128, 128), grid_dim=128))

    def tiny(self, size: int = 16) -> "Config":
        """Every ratio of preset_t128 at ``size``^3 grids (for tests)."""
        return replace(
            self,
            model=replace(
                self.model,
                bin_len=self.model.bin_len * (self.model.time_size // size),
                time_size=size, image_size=(size, size), grid_dim=size,
                heatmap_size=(size // 2,) * 3),
            dataset=replace(self.dataset, heatmap_size=(size // 2,) * 3,
                            vol_size=(size * 2,) * 3))


def default_config() -> Config:
    return Config()


def t128_config() -> Config:
    """The configuration the reference trains and serves with."""
    return default_config().preset_t128()
