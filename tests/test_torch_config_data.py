"""The port's own configuration and synthetic captures equal the JAX
package's, so the port can run without it: every field of the port's
``ModelConfig`` has the JAX package's value in each preset, and
``make_sample`` gives identical arrays."""

import dataclasses

import numpy as np
import pytest

from hiddenpose_tpu import config as jax_config
from hiddenpose_tpu.data.synthetic import make_sample as jax_make_sample
from hiddenpose_tpu_torch import config
from hiddenpose_tpu_torch.data.synthetic import make_sample

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
