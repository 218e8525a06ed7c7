"""The port's own configuration and synthetic captures equal the JAX
package's, so the port can run without it: every field of the port's
``ModelConfig`` and ``TrainConfig`` has the JAX package's value in each
preset, and ``make_sample`` and ``make_batch`` give identical arrays."""

import dataclasses

import numpy as np
import pytest

from hiddenpose_tpu import config as jax_config
from hiddenpose_tpu.data.synthetic import make_batch as jax_make_batch
from hiddenpose_tpu.data.synthetic import make_sample as jax_make_sample
from hiddenpose_tpu_torch import config
from hiddenpose_tpu_torch.data.synthetic import make_batch, make_sample
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

PRESETS = {
    "default": lambda c: c.default_config(),
    "t128": lambda c: c.t128_config(),
    "tiny16": lambda c: c.default_config().tiny(16),
    "tiny32": lambda c: c.t128_config().tiny(32),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_model_config_matches_jax(preset):
    got = PRESETS[preset](config).model
    want = PRESETS[preset](jax_config).model
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_model_config_has_the_transformer_fields():
    """The fields ``sformer_from_config`` reads are in the port's copy (the
    test above then holds each equal to the JAX package's)."""
    names = {f.name for f in dataclasses.fields(config.ModelConfig)}
    assert {"patch_size", "patch_feature_dim", "depth", "heads", "dim_head",
            "rotary_emb", "out_dim", "num_frames", "compute_dtype",
            "num_joints", "in_channels", "image_size"} <= names
    m = config.t128_config().model
    assert (m.patch_feature_dim, m.depth, m.heads, m.dim_head, m.patch_size,
            m.out_dim, m.compute_dtype) == (256, 8, 8, 32, 4, 512, "float32")


@pytest.mark.parametrize("seed,size", [(0, 16), (1, 16), (2, 32)])
def test_make_sample_matches_jax(seed, size):
    m = config.default_config().tiny(size).model
    args = (seed, m.time_size, m.image_size[0], m.grid_dim,
            m.heatmap_size[0], m.bin_len)
    got, want = make_sample(*args), jax_make_sample(*args)
    assert got.keys() == want.keys()
    assert got["person_id"] == want["person_id"]
    for k in ("meas", "vol", "joints"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["meas"].max() == 1.0  # a rendered capture, not zeros


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_train_config_matches_jax(preset):
    got = PRESETS[preset](config).train
    want = PRESETS[preset](jax_config).train
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("seeds", [(0, 1), (3,)])
def test_make_batch_matches_jax(seeds):
    m = config.default_config().tiny(16).model
    args = (m.time_size, m.image_size[0], m.grid_dim, m.heatmap_size[0],
            m.bin_len)
    got, want = make_batch(seeds, *args), jax_make_batch(seeds, *args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["joints_vis"].shape == (len(seeds), 72)
    assert (got["joints_vis"] == 1).all()
