"""hiddenpose_tpu_torch: HiddenPose in PyTorch and CUDA.

A port of ``hiddenpose_tpu`` (JAX, the reference) for one NVIDIA H100:
measurement -> FeatureExtraction -> LCT -> normalize -> UNet3d ->
PoseNet3D -> soft-argmax joints, served through
:class:`hiddenpose_tpu_torch.serve.InferenceServer`, trained by
``train/step.py`` in the epoch loop of ``train/loop.py`` over the sources
of ``data/``, evaluated by ``eval/harness.py``, and driven from the
command line by ``python -m hiddenpose_tpu_torch.cli.train`` / ``.test``;
and the transformer variant, video -> NlosPoseSformer -> SimDR logits ->
joints (``models/sformer.py``); the other training objectives
(``train/alt_steps.py``), NlosPose's ``posenet2d`` backbone and TokenPose,
PoseNet3D's other configurations, DeepVoxels (``models/deepvoxels.py``),
the wave, resample and channelled-LCT ops, and the figures (``viz/``);
multi-GPU training (``parallel/``: a ('data', 'model') mesh of process
groups, data and tensor parallelism, the spatially sharded LCT; the
loop's mesh and ``cli.train --multihost``), the rematerialisation knobs
(``utils/remat.py``) and the graft entry points (``graft_entry.py``).
Imports torch, never jax;
the hot kernels are hand-written CUDA under ``csrc/``.

Every entry point that takes a ``device`` defaults to the GPU (``"cuda"``,
or ``None``, which means the same) and raises where there is none; it
runs on the CPU only when the caller asks for it (``device="cpu"``), as
the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` is the GPU); raises if it
    names a GPU and the host has none, so that no entry point carries on
    on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False: "
            "the port runs on the GPU by default; pass device=\"cpu\" to run "
            "on the CPU")
    return dev


def as_dtype(dtype) -> torch.dtype:
    """'float32' / 'bfloat16' (or a torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    except KeyError:
        raise ValueError(f"compute dtype must be 'float32' or 'bfloat16', "
                         f"got {dtype!r}") from None
