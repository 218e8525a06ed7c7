"""The model configuration of the inference path.

The fields of ``hiddenpose_tpu/config.py::ModelConfig`` that the inference
path reads, with the same defaults and the same presets, so the port runs
where the JAX package is not installed.  Any object with these attributes
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
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)

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
