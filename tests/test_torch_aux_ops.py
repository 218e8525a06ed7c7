"""The port's auxiliary ops against the JAX package's, on the CPU:

* ``ops/wave.py``: the window and quadrature kernels equal the JAX
  package's (the same numpy); ``wave_convolve`` against ``np.convolve``
  'same' on odd and even kernels and against the JAX function (1e-5 of
  the largest output: f32 convolutions in two libraries);
* ``ops/resample.py``: the view rotations and grids equal the JAX
  package's; ``grid_sample_3d`` (``F.grid_sample``) against the JAX
  package's ``map_coordinates(order=1, mode="constant")`` at the border,
  between the border and outside [-1, 1], and far outside, with either
  ``align_corners``, within 1e-6; ``MultiViewResampler`` likewise;
* ``ops/lct.py::lct_apply_bdthw`` against the JAX function (1e-5 of the
  peak, as ``test_torch_lct.py`` holds ``lct_apply``), time window
  included;
* ``ops/lct_reference.py``, the port's own golden LCT: equal to the JAX
  package's golden bit for bit, and ``lct_apply`` held against it with
  the JAX package's own tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.ops import lct as jax_lct
from hiddenpose_tpu.ops import lct_reference as jax_golden
from hiddenpose_tpu.ops import resample as jax_resample
from hiddenpose_tpu.ops import wave as jax_wave
from hiddenpose_tpu_torch.ops import lct as port_lct
from hiddenpose_tpu_torch.ops import lct_reference as golden
from hiddenpose_tpu_torch.ops import resample, wave
import torch_threads  # noqa: F401  (caps this worker's CPU threads)


@pytest.mark.parametrize("wavelength", [0.05, 0.2], ids=["even", "odd"])
def test_wave_convolve_matches_numpy_and_jax(wavelength):
    rng = np.random.RandomState(0)
    data = rng.rand(128, 3, 4).astype(np.float32)
    args = (32e-12, wavelength, 3)
    for a, b in zip(wave.virtual_wave_kernels(*args),
                    jax_wave.virtual_wave_kernels(*args)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(wave.gaussian_window(9, 2.5),
                                  jax_wave.gaussian_window(9, 2.5))
    cos_k, sin_k = wave.virtual_wave_kernels(*args)
    assert len(cos_k) % 2 == (1 if wavelength == 0.2 else 0)
    got = wave.wave_convolve(torch.from_numpy(data), *args)
    want = jax_wave.wave_convolve(jnp.asarray(data), *args)
    for g, w, k in zip(got, want, (cos_k, sin_k)):
        assert g.shape == (128, 3, 4) and g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
        for i in range(3):
            for j in range(4):
                np.testing.assert_allclose(
                    g[:, i, j], np.convolve(data[:, i, j], k, mode="same"),
                    rtol=1e-4, atol=1e-5)


def test_view_rotations_and_grids_are_the_jax_packages():
    for trans in (False, True):
        np.testing.assert_array_equal(resample.view_rotations(trans),
                                      jax_resample.view_rotations(trans))
    for ac in (False, True):
        np.testing.assert_array_equal(
            resample.normalized_grid(3, 4, 5, ac),
            jax_resample._normalized_grid(3, 4, 5, ac))


def _grid(rng, shape):
    """Points on the border (+-1), between the border and 1.2, far outside
    (+-3) and inside, mixed over the three coordinates."""
    pts = rng.choice([-3.0, -1.2, -1.0, -1.05, -0.97, 0.0, 0.3, 0.97, 1.0,
                      1.05, 1.2, 3.0], size=shape + (3,))
    jitter = rng.uniform(-0.02, 0.02, size=pts.shape)
    pts = np.where(rng.rand(*pts.shape) < 0.5, pts, pts + jitter)
    return pts.astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_map_coordinates(align_corners):
    rng = np.random.RandomState(1)
    vol = rng.rand(2, 3, 5, 6, 7).astype(np.float32)
    grid = _grid(rng, (2, 4, 5, 6))
    got = resample.grid_sample_3d(torch.from_numpy(vol),
                                  torch.from_numpy(grid), align_corners)
    want = np.asarray(jax_resample.grid_sample_3d(
        jnp.asarray(vol), jnp.asarray(grid), align_corners))
    assert got.shape == want.shape == (2, 3, 4, 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want == 0).any() and (want != 0).any()  # outside and inside


@pytest.mark.parametrize("align_corners", [False, True])
def test_multiview_resampler_matches_jax(align_corners):
    rng = np.random.RandomState(2)
    vol = rng.rand(3, 2, 8, 6, 6).astype(np.float32)
    kw = dict(spatial=6, tdim=8, trange=3.0, wall_size=2.0,
              align_corners=align_corners)
    got = resample.MultiViewResampler(**kw, device="cpu")(
        torch.from_numpy(vol), [0, 5, 25])
    want = np.asarray(jax_resample.MultiViewResampler(**kw)(
        jnp.asarray(vol), [0, 5, 25]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


N, T, BIN_LEN = 16, 16, 0.04


@pytest.mark.parametrize("window", [None, (2, 14)], ids=["full", "window"])
def test_lct_apply_bdthw_matches_jax(window):
    rng = np.random.RandomState(3)
    t = T if window is None else window[1] - window[0]
    meas = rng.rand(2, 3, t, N, N).astype(np.float32)
    kw = {} if window is None else dict(time_begin=window[0],
                                        time_end=window[1])
    params = jax_lct.make_lct_params(N, T, BIN_LEN)
    want = np.asarray(jax_lct.lct_apply_bdthw(jnp.asarray(meas), params,
                                              **kw))
    got = port_lct.lct_apply_bdthw(
        torch.from_numpy(meas),
        port_lct.make_lct_params(N, T, BIN_LEN, device="cpu"), **kw).numpy()
    assert got.shape == want.shape == (2, 3, T, N, N)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["lct", "bp"])
def test_port_golden_lct_is_the_jax_packages(mode):
    meas = np.random.RandomState(4).rand(T, N, N).astype(np.float32)
    want = jax_golden.lct_numpy(meas, BIN_LEN, mode=mode)
    got = golden.lct_numpy(meas, BIN_LEN, mode=mode)
    np.testing.assert_array_equal(got, want)
    for m in (8, 16):
        for a, b in zip(golden.resampling_operator_dense(m),
                        jax_golden.resampling_operator_dense(m)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(golden.define_psf_meshgrid(N, T, 0.3),
                                  jax_golden.define_psf_meshgrid(N, T, 0.3))
    if mode == "lct":  # the pre-sharpening math: the golden covers it all
        vol = port_lct.lct_apply(
            torch.from_numpy(meas[None]),
            port_lct.make_lct_params(N, T, BIN_LEN, device="cpu"))[0]
        scale = np.abs(got).max()
        np.testing.assert_allclose(vol.numpy() / scale, got / scale,
                                   atol=1e-2)
        assert np.corrcoef(vol.numpy().ravel(), got.ravel())[0, 1] > 0.9995
