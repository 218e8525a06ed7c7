"""The port's LCT physics layer, normalisation and soft-argmax against the
JAX package and against the numpy golden ``ops/lct_reference.py``.

Also checks that the port's copy of ``ops/psf.py`` (it cannot import the
original without importing jax) is the same code giving the same arrays.
Tolerances: LCT against JAX, 1e-5 of the volume's peak (both are f32
FFTs, in different libraries); against the numpy golden, the JAX
package's own tolerances (``tests/test_lct.py``), since the golden runs
a full complex FFT in float64.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.ops import lct as jax_lct
from hiddenpose_tpu.ops import lct_reference as golden
from hiddenpose_tpu.ops import normalize as jax_norm
from hiddenpose_tpu.ops import psf as jax_psf
from hiddenpose_tpu.ops.softargmax import softmax_integral as jax_softmax_int
from hiddenpose_tpu_torch.ops import lct as port_lct
from hiddenpose_tpu_torch.ops import normalize as port_norm
from hiddenpose_tpu_torch.ops import psf as port_psf
from hiddenpose_tpu_torch.ops.softargmax import softmax_integral

N, T, BIN_LEN = 16, 16, 0.04


def _meas(b=2, seed=410):
    return np.random.RandomState(seed).rand(b, T, N, N).astype(np.float32)


def _port(meas, mode, material, **kw):
    params = port_lct.make_lct_params(N, T, BIN_LEN, mode=mode,
                                      material=material, device="cpu")
    return port_lct.lct_apply(torch.from_numpy(meas), params, **kw).numpy()


@pytest.mark.parametrize("mode", ["lct", "bp"])
@pytest.mark.parametrize("material", ["diffuse", "specular"])
def test_lct_matches_jax(mode, material):
    meas = _meas()
    params = jax_lct.make_lct_params(N, T, BIN_LEN, mode=mode,
                                     material=material)
    want = np.asarray(jax.jit(
        lambda m: jax_lct.lct_apply(m, params))(jnp.asarray(meas)))
    got = _port(meas, mode, material)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["lct", "bp"])
def test_lct_matches_numpy_golden(mode):
    meas = _meas()
    got = _port(meas, mode, "diffuse")
    for b in range(meas.shape[0]):
        want = golden.lct_numpy(meas[b], BIN_LEN, mode=mode)
        if mode == "bp":
            # the golden covers the pre-sharpening math; apply the same
            # LoG conv (edge padding, first slice zeroed) in numpy
            k = jax_psf.filter_laplacian()
            padded = np.pad(want, 2, mode="edge")
            out = np.zeros_like(want)
            for dz in range(5):
                for dy in range(5):
                    for dx in range(5):
                        out += k[dz, dy, dx] * padded[dz:dz + T, dy:dy + N,
                                                      dx:dx + N]
            out[:1] = 0.0
            want = out
        atol = 1e-1 if mode == "bp" else 1e-2
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got[b] / scale, want / scale, atol=atol)
        assert np.corrcoef(got[b].ravel(), want.ravel())[0, 1] > (
            0.995 if mode == "bp" else 0.9995)


def test_time_window_and_batch_chunk():
    meas = _meas(b=4)
    full = _port(meas, "lct", "diffuse")
    # chunks run the same math; the FFT may pick another plan per batch size
    np.testing.assert_allclose(
        _port(meas, "lct", "diffuse", batch_chunk=2), full, rtol=0,
        atol=1e-6 * np.abs(full).max())
    # a shorter capture embedded at time_begin equals zero-padding it there
    short = meas[:, :10]
    padded = np.zeros_like(meas)
    padded[:, 3:13] = short
    np.testing.assert_allclose(
        _port(short, "lct", "diffuse", time_begin=3),
        _port(padded, "lct", "diffuse"), rtol=0,
        atol=1e-6 * np.abs(full).max())


def test_psf_copy_is_identical():
    here = Path(port_psf.__file__).read_text()
    assert here == Path(jax_psf.__file__).read_text()
    a = jax_psf.resampling_operator(T)
    b = port_psf.resampling_operator(T)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for fn in (lambda m: m.define_psf(N, T, 0.3),
               lambda m: m.filter_laplacian(),
               lambda m: m.wiener_inverse_psf(N, T, 0.3)):
        np.testing.assert_array_equal(fn(port_psf), fn(jax_psf))


@pytest.mark.parametrize("last", [False, True])
def test_normalize_feature_matches_jax(last):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 3, 4, 5, 6) * 7).astype(np.float32)
    jfn = jax_norm.normalize_feature_last if last else jax_norm.normalize_feature
    pfn = (port_norm.normalize_feature_last if last
           else port_norm.normalize_feature)
    got = pfn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert got.min() >= 0.0 and abs(got.max() - 10.0) < 1e-5


def test_softmax_integral_matches_jax():
    rng = np.random.RandomState(6)
    hm = (rng.randn(2, 24, 8, 6, 4) * 3).astype(np.float32)
    got = softmax_integral(torch.from_numpy(hm), 24).numpy()
    want = np.asarray(jax_softmax_int(jnp.asarray(hm), 24))
    assert got.shape == (2, 72)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
