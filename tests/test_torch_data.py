"""The port's data path against the JAX package's, on the CPU.

* the configuration's dataset and run fields, preset by preset;
* the preprocess functions (numpy / scipy copies), exactly, on the same
  arrays and on ``scipy.io.savemat`` fixtures;
* the native decoder (the port's copy of ``hdr_decoder.cpp``, which the
  port uses where the JAX package calls cv2) against the JAX package's
  cv2 ``decode_hdr_gray``, on an old-style Radiance file and on a
  run-length-encoded one written by ``cv2.imwrite``, within the JAX
  package's own native-vs-cv2 tolerance (6e-3 of the normalised image,
  the RGBE quantisation); its failures raise, a failed build too;
* ``add_noise``'s blur against cv2's ``GaussianBlur`` within 1e-6 of the
  max (cv2's 87-tap kernel; scipy's 85-tap ``gaussian_filter1d`` misses by
  about 2e-5), and its Poisson draw on that same rate;
* ``NlosPoseSource`` / ``NlosFlatSource`` over a tiny tree on disk, item
  for item against the JAX sources (meas within the decoder tolerance,
  the rest exact), a black .hdr taking the sample-0 fallback and its log
  line;
* ``DataPipeline``'s batches against the JAX ``DataPipeline`` over two
  epochs and two shards with ``drop_last`` False, in the calling process
  and with two worker processes; ``collate``; ``device_prefetch`` on the
  CPU.
"""

import dataclasses
import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from scipy.io import savemat

from hiddenpose_tpu import config as jax_config
from hiddenpose_tpu.data import dataset as jax_dataset
from hiddenpose_tpu.data import preprocess as jax_pp
from hiddenpose_tpu_torch import config
from hiddenpose_tpu_torch.data import dataset, native_loader
from hiddenpose_tpu_torch.data import preprocess as pp
from hiddenpose_tpu_torch.data.device_prefetch import device_prefetch
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

DECODE_TOL = 6e-3  # tests/test_native_loader.py: native vs cv2
PRESETS = {
    "default": lambda c: c.default_config(),
    "t128": lambda c: c.t128_config(),
    "tiny16": lambda c: c.default_config().tiny(16),
    "tiny32": lambda c: c.t128_config().tiny(32),
}
RUN_FIELDS = ("log_dir", "result_dir", "final_output_dir", "phase",
              "test_batch_size", "valid_batch_size", "num_workers")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_dataset_and_run_config_match_jax(preset):
    got, want = PRESETS[preset](config), PRESETS[preset](jax_config)
    for f in dataclasses.fields(want.dataset):
        assert getattr(got.dataset, f.name) == getattr(want.dataset,
                                                       f.name), f.name
    for name in RUN_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("pretrain_autoencoder", "pretrain_autoencoder_path"):
        assert getattr(got.model, name) == getattr(want.model, name), name


# -- preprocess -------------------------------------------------------------

def test_frame_and_volume_transforms_match_jax():
    rng = np.random.RandomState(0)
    gray = rng.rand(600 * 8, 8).astype(np.float32)
    vol = rng.rand(16, 12, 8).astype(np.float32)
    for name, args in (("unpack_frames", (gray,)),
                       ("preprocess_measurement", (gray, 1)),
                       ("preprocess_measurement", (gray, 2)),
                       ("rebin_pairs", (vol, 1)),
                       ("downsample_volume", (vol, 2))):
        got = getattr(pp, name)(*args)
        want = getattr(jax_pp, name)(*args)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    joints = rng.randn(24, 3)
    np.testing.assert_array_equal(
        pp.map_joints_to_heatmap(joints, vol_size=32, heatmap_size=8),
        jax_pp.map_joints_to_heatmap(joints, vol_size=32, heatmap_size=8))


def test_mat_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    real, fk, vol = (str(tmp_path / n) for n in ("r.mat", "f.mat", "v.mat"))
    savemat(real, {"data_new": rng.rand(16, 12, 32)})
    savemat(fk, {"meas": rng.rand(8, 6, 64)})
    savemat(vol, {"vol": rng.rand(8, 8, 8)})
    for got, want in (
            (pp.load_realdata(real), jax_pp.load_realdata(real)),
            (pp.load_realdata(real, 2), jax_pp.load_realdata(real, 2)),
            (pp.load_fk_measurement(fk, 2, (4, 12)),
             jax_pp.load_fk_measurement(fk, 2, (4, 12))),
            (pp.load_vol_mat(vol), jax_pp.load_vol_mat(vol))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# -- the native decoder -----------------------------------------------------

def _write_old_style_hdr(path, rgb):
    """Uncompressed (old-style) Radiance writer, as
    tests/test_native_loader.py's.  rgb: (H, W, 3)."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        maxc = rgb.max(axis=2)
        out = np.zeros((h, w, 4), np.uint8)
        nonzero = maxc > 1e-32
        m, e = np.frexp(np.where(nonzero, maxc, 1.0))
        scale = np.where(nonzero, m * 256.0 / np.where(nonzero, maxc, 1.0),
                         0)
        for c in range(3):
            out[..., c] = np.clip(rgb[..., c] * scale, 0, 255).astype(
                np.uint8)
        out[..., 3] = np.where(nonzero, e + 128, 0).astype(np.uint8)
        f.write(out.tobytes())


def _stacked_gray(seed, h=8, w=8):
    """A stacked-frame capture (600 frames of h x w) as an RGB image with
    channels of different weight, so the gray conversion is exercised."""
    val = np.random.RandomState(seed).rand(600 * h, w) * 5
    return np.stack([val, 0.5 * val, 0.25 * val], axis=-1)


@pytest.fixture(scope="module")
def hdr_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hdr")
    old, rle = str(d / "old.hdr"), str(d / "rle.hdr")
    _write_old_style_hdr(old, _stacked_gray(410))
    # cv2 writes new-style run-length-encoded scanlines (width 16 >= 8)
    bgr = _stacked_gray(411, w=16)[..., ::-1].astype(np.float32)
    assert cv2.imwrite(rle, np.ascontiguousarray(bgr))
    with open(rle, "rb") as f:
        body = f.read()
    assert struct.pack("BBBB", 2, 2, 0, 16) in body  # an RLE scanline
    return {"old": old, "rle": rle}


@pytest.mark.parametrize("kind", ["old", "rle"])
def test_native_decoder_matches_jax_cv2(hdr_files, kind):
    got = pp.decode_hdr_gray(hdr_files[kind])
    want = jax_pp.decode_hdr_gray(hdr_files[kind])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL)
    # the fused native preprocess against the numpy one on the same gray
    np.testing.assert_allclose(native_loader.preprocess_meas(got),
                               pp.preprocess_measurement(got), rtol=1e-5,
                               atol=1e-7)


def test_native_decoder_raises_on_bad_files(tmp_path):
    black, junk = str(tmp_path / "black.hdr"), str(tmp_path / "junk.hdr")
    _write_old_style_hdr(black, np.zeros((8, 8, 3)))
    with open(junk, "wb") as f:
        f.write(b"not a radiance file\n")
    for path, why in ((black, "black"), (junk, "unreadable"),
                      (str(tmp_path / "missing.hdr"), "unreadable")):
        with pytest.raises(native_loader.DecodeError, match=why):
            native_loader.decode_hdr_gray(path)


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    """No fallback: a source that does not compile raises, with g++'s
    message."""
    bad = tmp_path / "hdr_decoder.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_loader.decode_hdr_gray(str(tmp_path / "any.hdr"))


# -- noise ------------------------------------------------------------------

@pytest.mark.parametrize("n", [500, 60000])
def test_noise_blur_matches_cv2(n):
    x = (np.random.RandomState(n).rand(n) ** 4 * 50).astype(np.float32)
    want = cv2.GaussianBlur(x, ksize=(0, 0), sigmaX=10.61,
                            borderType=cv2.BORDER_REPLICATE).reshape(-1)
    got = pp.blur_replicate(x, 10.61)
    assert len(pp.gaussian_kernel(10.61)) == 87
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_add_noise_draws_poisson_of_the_blur():
    """The draw on the blur's own rates (a draw from a nearly equal rate
    may differ, so the JAX package's, on cv2's rates, is not compared)."""
    gray = np.random.RandomState(2).rand(600, 8).astype(np.float32) * 40
    got = pp.add_noise(gray, 10.61, rng=np.random.RandomState(3))
    lam = np.clip(pp.blur_replicate(gray.reshape(-1), 10.61), 0, None)
    want = np.random.RandomState(3).poisson(lam).astype(np.float32)
    assert got.shape == gray.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.reshape(-1), want)


# -- sources ----------------------------------------------------------------

def _tiny_tree(root, black=None):
    """pose_00/train/{meas,vol,joints} with three samples (8 x 8 frames,
    16^3 volumes); ``black``: the name of a sample whose .hdr is black."""
    rng = np.random.RandomState(5)
    split = root / "pose_00" / "train"
    for sub in ("meas", "vol", "joints"):
        (split / sub).mkdir(parents=True)
    (root / "notes.txt").write_text("not a pose directory\n")
    for i, name in enumerate(("a01", "a02", "a03")):
        rgb = (np.zeros((600 * 8, 8, 3)) if name == black
               else _stacked_gray(20 + i))
        _write_old_style_hdr(str(split / "meas" / f"{name}.hdr"), rgb)
        vol = (rng.rand(16, 16, 16) > 0.7).astype(np.float64)
        savemat(str(split / "vol" / f"{name}.mat"), {"vol": vol})
        np.savetxt(str(split / "joints" / f"{name}.joints"),
                   0.3 * rng.randn(24, 3))
    return split


def _flat_tree(root):
    for sub in ("meas", "vol", "joints"):
        (root / sub).mkdir(parents=True)
    rng = np.random.RandomState(6)
    for i, name in enumerate(("b01", "b02")):
        _write_old_style_hdr(str(root / "meas" / f"{name}.hdr"),
                             _stacked_gray(30 + i))
        np.save(str(root / "vol" / f"{name}.npy"),
                rng.rand(16, 16, 16).astype(np.float32))
        np.savetxt(str(root / "joints" / f"{name}.joints"),
                   0.3 * rng.randn(24, 3))


def _assert_items_match(got, want):
    assert got["person_id"] == want["person_id"]
    for k in ("meas", "vol", "joints"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
    np.testing.assert_allclose(got["meas"], want["meas"], rtol=0,
                               atol=DECODE_TOL)
    np.testing.assert_array_equal(got["vol"], want["vol"])
    np.testing.assert_array_equal(got["joints"], want["joints"])


def test_pose_source_matches_jax_with_the_black_file_fallback(tmp_path):
    _tiny_tree(tmp_path / "data", black="a02")
    cfg, jcfg = config.Config().tiny(16), jax_config.Config().tiny(16)
    logs = [tmp_path / "wrong_port.txt", tmp_path / "wrong_jax.txt"]
    src = dataset.NlosPoseSource(cfg, str(tmp_path / "data"),
                                 wrong_files_log=str(logs[0]))
    jsrc = jax_dataset.NlosPoseSource(jcfg, str(tmp_path / "data"),
                                      wrong_files_log=str(logs[1]))
    assert len(src) == len(jsrc) == 3
    assert src.meas_files == jsrc.meas_files
    items = [src[i] for i in range(3)]
    for i, item in enumerate(items):
        _assert_items_match(item, jsrc[i])
    assert items[0]["meas"].shape == (1, 128, 4, 4)
    # the black a02 took sample 0's measurement, joints and id, its own vol
    assert items[1]["person_id"] == "a01"
    np.testing.assert_array_equal(items[1]["meas"], items[0]["meas"])
    lines = logs[0].read_text().splitlines()
    assert lines == [src.meas_files[1]] == logs[1].read_text().splitlines()


def test_flat_source_matches_jax(tmp_path):
    _flat_tree(tmp_path / "flat")
    cfg, jcfg = config.Config().tiny(16), jax_config.Config().tiny(16)
    src = dataset.NlosFlatSource(cfg, str(tmp_path / "flat"))
    jsrc = jax_dataset.NlosFlatSource(jcfg, str(tmp_path / "flat"))
    assert len(src) == len(jsrc) == 2
    for i in range(2):
        _assert_items_match(src[i], jsrc[i])


def test_synthetic_source_matches_jax():
    cfg, jcfg = config.Config().tiny(16), jax_config.Config().tiny(16)
    got = dataset.SyntheticSource(cfg, length=3)[2]
    want = jax_dataset.SyntheticSource(jcfg, length=3)[2]
    assert got["person_id"] == want["person_id"] == "synthetic-412"
    for k in ("meas", "vol", "joints"):
        np.testing.assert_array_equal(got[k], want[k])


# -- batching ---------------------------------------------------------------

def test_collate_matches_jax():
    src = dataset.SyntheticSource(config.Config().tiny(16), length=3)
    samples = [src[i] for i in range(3)]
    got, want = dataset.collate(samples), jax_dataset.collate(samples)
    assert got.keys() == want.keys()
    assert got["person_id"] == want["person_id"]
    for k in ("meas", "vol", "joints", "joints_vis"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tensors = dataset.collate_tensors(samples)
    assert tensors["meas"].dtype == torch.float32
    np.testing.assert_array_equal(tensors["joints"].numpy(), want["joints"])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_pipeline_batches_match_jax(num_workers):
    """Seven samples (a ragged tail), batch 2, both shards of two, two
    epochs; each epoch iterated twice (iteration is pure)."""
    cfg, jcfg = config.Config().tiny(16), jax_config.Config().tiny(16)
    src = dataset.SyntheticSource(cfg, length=7)
    jsrc = jax_dataset.SyntheticSource(jcfg, length=7)
    for shard in (0, 1):
        kw = dict(batch_size=2, seed=410, drop_last=False, shard_index=shard,
                  shard_count=2)
        jpipe = jax_dataset.DataPipeline(jsrc, num_workers=1, **kw)
        with dataset.DataPipeline(src, num_workers=num_workers,
                                  **kw) as pipe:
            assert len(pipe) == len(jpipe) == 2
            for epoch in (0, 1):
                pipe.set_epoch(epoch)
                jpipe.set_epoch(epoch)
                want = list(jpipe)
                for _ in range(2):
                    got = list(pipe)
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        assert g["person_id"] == w["person_id"]
                        for k in ("meas", "vol", "joints", "joints_vis"):
                            assert isinstance(g[k], torch.Tensor)
                            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_pipeline_drop_last_and_order():
    cfg = config.Config().tiny(16)
    pipe = dataset.DataPipeline(dataset.SyntheticSource(cfg, length=5),
                                batch_size=2, num_workers=0)
    jpipe = jax_dataset.DataPipeline(
        jax_dataset.SyntheticSource(jax_config.Config().tiny(16), length=5),
        batch_size=2, num_workers=1)
    assert len(pipe) == 2
    got = [b.tolist() for b in pipe._index_batches()]
    assert got == [b.tolist() for b in jpipe._index_batches()]
    assert [b["person_id"] for b in pipe] == [b["person_id"] for b in jpipe]


def test_pipeline_workers_leave_no_process_at_exit():
    """A process that loaded through workers leaves nothing running when
    it exits: its fork server is stopped and waited for at exit, not left
    to notice the end of a pipe a moment after."""
    code = textwrap.dedent("""
        from multiprocessing import forkserver
        from hiddenpose_tpu_torch import config
        from hiddenpose_tpu_torch.data import dataset
        cfg = config.Config().tiny(16)
        src = dataset.SyntheticSource(cfg, length=4)
        with dataset.DataPipeline(src, batch_size=2, num_workers=2) as pipe:
            n = len(list(pipe))
        print(n, forkserver._forkserver._forkserver_pid, flush=True)
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr
    n, pid = r.stdout.split()
    assert n == "2" and pid != "None"
    with pytest.raises(ProcessLookupError):
        os.kill(int(pid), 0)


def test_device_prefetch_on_the_cpu():
    """Values and order kept, person_id dropped, numpy or tensors in, and
    at most ``buffer_size`` batches pulled ahead of the consumer."""
    pulled = []

    def batches():
        for i in range(4):
            pulled.append(i)
            yield {"meas": np.full((2, 3), i, np.float32),
                   "joints": torch.full((2, 6), float(i)),
                   "person_id": [f"p{i}", "q"]}

    it = device_prefetch(batches(), torch.device("cpu"), buffer_size=2)
    first = next(it)
    assert pulled == [0, 1]
    assert set(first) == {"meas", "joints"}
    rest = list(it)
    for i, b in enumerate([first] + rest):
        assert b["meas"].device.type == "cpu"
        assert torch.equal(b["meas"], torch.full((2, 3), float(i)))
        assert torch.equal(b["joints"], torch.full((2, 6), float(i)))
    assert len(rest) == 3
