"""The model and training configuration of the ported paths.

The fields of ``hiddenpose_tpu/config.py::ModelConfig`` that the inference
path reads, and ``TrainConfig`` field for field, with the same defaults and
the same presets, so the port runs where the JAX package is not installed.  Any object with these attributes
(the JAX package's ``Config`` included) is accepted wherever a config is.
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
    mode: str = "lct"  # 'lct' | 'bp'
    material: str = "diffuse"  # 'diffuse' | 'specular'
    num_joints: int = 24
    backbone: str = "posenet3d_50"
    # LCT FFT batch chunking (0 = fully batched)
    lct_batch_chunk: int = 0


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
    # 'default' | 'high' | 'highest'; the port runs 'highest' (full f32,
    # TF32 off) only: train/step.py raises on the others.
    matmul_precision: str = "default"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def preset_t128(self) -> "Config":
        """The live training configuration: bin_len x4, T=128,
        128x128 wall, 128^3 grid."""
        return replace(self, model=replace(
            self.model, bin_len=self.model.bin_len * 4, time_size=128,
            image_size=(128, 128), grid_dim=128))

    def tiny(self, size: int = 16) -> "Config":
        """Every ratio of preset_t128 at ``size``^3 grids (for tests)."""
        return replace(self, model=replace(
            self.model,
            bin_len=self.model.bin_len * (self.model.time_size // size),
            time_size=size, image_size=(size, size), grid_dim=size,
            heatmap_size=(size // 2,) * 3))


def default_config() -> Config:
    return Config()


def t128_config() -> Config:
    """The configuration the reference trains and serves with."""
    return default_config().preset_t128()
