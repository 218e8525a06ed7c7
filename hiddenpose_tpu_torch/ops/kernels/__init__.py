"""The hand-written CUDA kernels of the inference path and the train step.

Each module holds the wrappers (which launch a kernel for a CUDA tensor
and count the launch), the plain PyTorch version of each, the
``torch.autograd.Function`` that routes a training forward and backward
through them, and a note on the TPU kernel each replaces.
"""

from __future__ import annotations

from hiddenpose_tpu_torch.ops.kernels.conv3mxu import (
    conv3_mxu,
    conv3_mxu_diff,
    conv3_mxu_dx,
    conv3_mxu_dx_ref,
    conv3_mxu_ref,
)
from hiddenpose_tpu_torch.ops.kernels.conv3p import (
    conv3_planes,
    conv3_planes_adjoint,
    conv3_planes_adjoint_ref,
    conv3_planes_diff,
    conv3_planes_ref,
    conv3_planes_wgrad,
    conv3_planes_wgrad_ref,
)
from hiddenpose_tpu_torch.ops.kernels.phase_pool import (
    maxpool3d_k3s2p1,
    maxpool3d_k3s2p1_diff,
    maxpool3d_k3s2p1_ref,
    maxpool3d_k3s2p1_vjp,
    maxpool3d_k3s2p1_vjp_ref,
)
from hiddenpose_tpu_torch.ops.kernels.pool2p import (
    max_pool2_bwd,
    max_pool2_bwd_ref,
    max_pool2_diff,
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
    "conv3_mxu_dx": (
        conv3_mxu_dx, conv3_mxu_dx_ref,
        "hiddenpose_tpu_torch/csrc/conv3mxu.cu",
        "hiddenpose_tpu/ops/pallas/conv3mxu.py:525",
    ),
    "conv3_planes_adjoint": (
        conv3_planes_adjoint, conv3_planes_adjoint_ref,
        "hiddenpose_tpu_torch/csrc/conv3p_adjoint.cu",
        "hiddenpose_tpu/ops/pallas/conv3p.py:643",
    ),
    "conv3_planes_wgrad": (
        conv3_planes_wgrad, conv3_planes_wgrad_ref,
        "hiddenpose_tpu_torch/csrc/conv3p_wgrad.cu",
        "hiddenpose_tpu/ops/pallas/conv3p.py:1102",
    ),
    "maxpool3d_k3s2p1_vjp": (
        maxpool3d_k3s2p1_vjp, maxpool3d_k3s2p1_vjp_ref,
        "hiddenpose_tpu_torch/csrc/phase_pool_vjp.cu",
        "hiddenpose_tpu/ops/pallas/phase_pool.py:365",
    ),
    "max_pool2_bwd": (
        max_pool2_bwd, max_pool2_bwd_ref,
        "hiddenpose_tpu_torch/csrc/pool2p.cu",
        "hiddenpose_tpu/ops/pallas/pool2p.py:129",
    ),
}

# The kernels the eval (serving) forward launches; the train step launches
# all but stem_conv_raw (training keeps the library stem conv, as the JAX
# package does).
SERVING = ("conv3_planes", "stem_conv_raw", "maxpool3d_k3s2p1", "conv3_mxu")
TRAINING = tuple(k for k in KERNELS if k != "stem_conv_raw")


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
