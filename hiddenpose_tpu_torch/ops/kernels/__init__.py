"""The four hand-written CUDA kernels of the inference path.

Each module holds the wrapper (which launches the kernel for a CUDA tensor
and counts the launch), the plain PyTorch version of the same function,
and a note on the TPU kernel it replaces.
"""

from __future__ import annotations

from hiddenpose_tpu_torch.ops.kernels.conv3mxu import conv3_mxu, conv3_mxu_ref
from hiddenpose_tpu_torch.ops.kernels.conv3p import (
    conv3_planes,
    conv3_planes_ref,
)
from hiddenpose_tpu_torch.ops.kernels.phase_pool import (
    maxpool3d_k3s2p1,
    maxpool3d_k3s2p1_ref,
)
from hiddenpose_tpu_torch.ops.kernels.stem_conv import (
    stem_conv_raw,
    stem_conv_raw_ref,
)

# name -> (wrapper, plain version, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "conv3_planes": (
        conv3_planes, conv3_planes_ref,
        "hiddenpose_tpu_torch/csrc/conv3p.cu",
        "hiddenpose_tpu/ops/pallas/conv3p.py:1320",
    ),
    "stem_conv_raw": (
        stem_conv_raw, stem_conv_raw_ref,
        "hiddenpose_tpu_torch/csrc/stem_conv.cu",
        "hiddenpose_tpu/ops/pallas/stem_conv.py:141",
    ),
    "maxpool3d_k3s2p1": (
        maxpool3d_k3s2p1, maxpool3d_k3s2p1_ref,
        "hiddenpose_tpu_torch/csrc/phase_pool.cu",
        "hiddenpose_tpu/ops/pallas/phase_pool.py:145",
    ),
    "conv3_mxu": (
        conv3_mxu, conv3_mxu_ref,
        "hiddenpose_tpu_torch/csrc/conv3mxu.cu",
        "hiddenpose_tpu/ops/pallas/conv3mxu.py:318",
    ),
}


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
