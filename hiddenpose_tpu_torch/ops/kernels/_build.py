"""Build and load the hand-written CUDA kernels of ``hiddenpose_tpu_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them straight
into one shared library (no PyTorch headers, which would cost minutes per
build) and :mod:`ctypes` loads it.  The library is built at first use, for
``sm_90a``, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the sources, the headers they
share and the flags, so an edit to any of them forces a rebuild and a stale
library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
package on a host without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("conv3p.cu", "stem_conv.cu", "phase_pool.cu", "conv3mxu.cu",
           "conv3p_adjoint.cu", "conv3p_wgrad.cu", "phase_pool_vjp.cu",
           "pool2p.cu", "attn.cu", "diag_probes.cu", "conv3mxu_bf16.cu",
           "stem_conv_bf16.cu")
# headers the sources include: hashed with them, so an edit to one rebuilds
HEADERS = ("cp_async.cuh", "conv3p_tile.cuh", "wgmma_tf32.cuh",
           "wgmma_bf16.cuh", "bf16.cuh", "mbarrier.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# Every entry point returns its cudaError_t as an int; pointers and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES = {
    "hp_conv3p_fwd": [_P] * 8 + [_P],
    "hp_stem_conv_prep": [_P] * 2 + [_P],
    "hp_stem_conv_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "hp_maxpool3d_k3s2p1": [_P] * 2 + [_I] * 8 + [_P],
    "hp_maxpool3d_k3s2p1_bf16": [_P] * 2 + [_I] * 8 + [_P],
    "hp_conv3_mxu_prep": [_P] * 2 + [_I] * 3 + [_P],
    "hp_conv3_mxu_fwd": [_P] * 5 + [_I] * 7 + [_P],
    "hp_conv3_mxu_bf16_prep": [_P] * 2 + [_I] * 3 + [_P],
    "hp_conv3_mxu_bf16_fwd": [_P] * 7 + [_P],
    "hp_stem_conv_bf16_prep": [_P] * 2 + [_P],
    "hp_stem_conv_bf16_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "hp_conv3p_adjoint": [_P] * 4 + [_P],
    "hp_conv3p_wgrad": [_P] * 5 + [_I] * 11 + [_P],
    "hp_maxpool3d_k3s2p1_vjp": [_P] * 3 + [_I] * 8 + [_P],
    "hp_maxpool2_bwd": [_P] * 3 + [_I] * 7 + [_P],
    "hp_attend_plan": [_L] + [_I] * 3,
    "hp_attend_chunk": [_L] + [_I] * 3,
    "hp_attend_fwd": [_P] * 5 + [_L] + [_I] * 5 + [_P],
    "hp_probe_im2col": [_P] * 2 + [_P],
    "hp_probe_slice_transpose": [_P] * 3 + [_I] * 2 + [_P],
    "hp_probe_dot_f32": [_P] * 3 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
_entries = {}       # entry points by name, resolved once
build_log = ""      # nvcc's output (-Xptxas=-v: registers, spills, smem)
build_seconds = 0.0


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(
            os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source to an object in parallel, then link."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = []
        try:
            for name, p in zip(SOURCES, procs):
                text, _ = p.communicate()
                logs.append(f"== {name}\n{text}")
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        finally:  # after a failure, stop the builds still running
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                    p.wait()
        part = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode=arch=compute_90a,code=sm_90a",
             *objs, "-o", str(part)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(part, out)  # atomic: a reader never sees a partial file
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libhp_kernels_{_digest()}.so"
        if not path.exists():
            t0 = time.perf_counter()
            build_log = _compile(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def reset() -> None:
    """Forget the loaded library, so that the next launch builds and loads
    the sources as they are now (a tuning sweep edits them in place)."""
    global _lib
    with _lock:
        _lib = None
        _entries.clear()


def launch(name: str, *args, device=None) -> None:
    """Call one entry point on the current stream; raise on a launch error.
    ``device`` (the tensors' ``torch.device``) lets the stream be looked up
    without building a ``torch.cuda.Stream``, which costs more host time
    than the rest of a small kernel's call."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if device is not None and device.index is not None and raw is not None:
        stream = raw(device.index)
    else:
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def int_args(*values: int):
    """A C ``int`` array of ``values``, built once per distinct tuple: an
    entry point that takes its shape and plan as one ``const int*`` spares
    the per-call conversion of every integer."""
    return (ctypes.c_int * len(values))(*values)


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (a C null) for None."""
    return None if t is None else t.data_ptr()


def no_grad_inputs(name: str, *tensors, use: str) -> None:
    """Raise if grad mode is on and an input requires grad.

    A kernel writes into a fresh tensor through a raw pointer, so on the
    GPU its output has no ``grad_fn``: called under autograd it would cut
    the graph silently.  Only the ``autograd.Function`` named by ``use``
    calls a kernel there (its forward and backward run with grad mode off).
    The check runs on every device, so the CPU tests catch a misrouted
    caller."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and grad mode is on; the raw "
            f"kernel is not differentiable, use {use}")


def check(t, name: str, *, shape=None, device=None, aligned: bool = False,
          dtype=torch.float32):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (float32 unless
    given) and ``shape`` on ``device``; ``aligned`` also requires 16-byte
    alignment (float4 loads)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
