"""ctypes binding for the native measurement decoder.

Port of ``hiddenpose_tpu/data/native_loader.py``, over the port's own copy
of ``data/native/hdr_decoder.cpp`` (Radiance RGBE decode, grayscale, /max
twice, and the fused crop + pair-average + downsample).  The source is
compiled with ``g++ -O3 -fopenmp -shared -fPIC`` at first use into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
under a name that hashes the source and the flags, so an edit forces a
rebuild and a stale library is never loaded.  ``-march=native`` is left
out: the build directory may be shared between hosts.

Unlike the JAX package's loader there is no fallback: a failed build
raises with the compiler's output, and a file that does not decode
raises :class:`DecodeError` (the dataset's corrupt-file policy catches
that one, ``data/dataset.py``).  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "hdr_decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
# the reference's stacked-frame capture: 600 frames of 256 x 256
MAX_PIXELS = 600 * 256 * 256

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


class DecodeError(ValueError):
    """A measurement file that the decoder cannot read, or a black one."""


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first call; raises RuntimeError with
    the compiler's output if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libhp_hdr_{_digest()}.so"
        if not path.exists():
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                part = Path(tmp) / path.name
                try:
                    out = subprocess.run(
                        ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(part)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True, timeout=300)
                except (OSError, subprocess.TimeoutExpired) as e:
                    raise RuntimeError(
                        f"cannot build the native decoder: {e}") from e
                if out.returncode != 0:
                    raise RuntimeError(
                        f"g++ failed on {SOURCE}:\n{out.stdout}")
                os.replace(part, path)  # atomic for concurrent builders
        lib = ctypes.CDLL(str(path))
        lib.hdr_decode_gray.restype = ctypes.c_int
        lib.hdr_decode_gray.argtypes = [ctypes.c_char_p, _F32P, _IP, _IP,
                                        ctypes.c_long]
        lib.preprocess_meas.restype = ctypes.c_int
        lib.preprocess_meas.argtypes = [_F32P] + [ctypes.c_int] * 5 + [_F32P]
        _lib = lib
        return lib


def decode_hdr_gray(path: str, max_pixels: int = MAX_PIXELS) -> np.ndarray:
    """Decode an .hdr measurement, BGR -> gray, /max twice: (H, W) float32.
    Raises DecodeError on an unreadable, malformed or black file."""
    lib = library()
    buf = np.empty(max_pixels, dtype=np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.hdr_decode_gray(os.fsencode(path), buf.ctypes.data_as(_F32P),
                             ctypes.byref(h), ctypes.byref(w), buf.size)
    if rc != 0:
        why = {1: "unreadable or malformed", 2: "larger than max_pixels",
               3: "black"}.get(rc, f"rc={rc}")
        raise DecodeError(f"measurement {path}: {why}")
    return buf[: h.value * w.value].reshape(h.value, w.value)


def preprocess_meas(gray: np.ndarray, t_frames: int = 600, crop: int = 512,
                    downsample_cnt: int = 1) -> np.ndarray:
    """Fused crop + pair-average + downsample:
    gray (t_frames * h, w) -> ((crop / 2) >> ds, h >> ds, w >> ds)."""
    gray = np.ascontiguousarray(gray, dtype=np.float32)
    th, w = gray.shape
    h = th // t_frames
    ds = downsample_cnt
    if th != t_frames * h or crop > t_frames or crop % 2:
        raise ValueError(f"gray {gray.shape} is not {t_frames} frames, or "
                         f"crop {crop} does not fit them")
    out = np.empty(((crop // 2) >> ds, h >> ds, w >> ds), dtype=np.float32)
    rc = library().preprocess_meas(gray.ctypes.data_as(_F32P), t_frames, h,
                                   w, crop, ds, out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"native preprocess failed rc={rc} for "
                         f"{gray.shape}, downsample_cnt {ds}")
    return out
