"""hiddenpose_tpu_torch: HiddenPose in PyTorch and CUDA.

A port of ``hiddenpose_tpu`` (JAX, the reference) for one NVIDIA H100:
measurement -> FeatureExtraction -> LCT -> normalize -> UNet3d ->
PoseNet3D -> soft-argmax joints, served through
:class:`hiddenpose_tpu_torch.serve.InferenceServer` and trained by
``train/step.py``; and the transformer variant, video -> NlosPoseSformer ->
SimDR logits -> joints (``models/sformer.py``).  Imports torch, never jax;
the hot kernels are hand-written CUDA under ``csrc/``.

Every entry point that takes a ``device`` defaults to the GPU (``"cuda"``)
and raises where there is none; it runs on the CPU only when the caller
asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a GPU and the
    host has none, so that no entry point carries on on the CPU unasked."""
    dev = torch.device(device)
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
