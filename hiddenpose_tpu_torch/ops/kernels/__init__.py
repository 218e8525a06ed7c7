"""The hand-written CUDA kernels of the NlosPose inference path and train
step, of the Sformer's grouped attention, and the stem probes.

Each module holds the wrappers (which launch a kernel for a CUDA tensor
and count the launch), the plain PyTorch version of each, the
``torch.autograd.Function`` that routes a training forward and backward
through them, and a note on the TPU kernel each replaces.
"""

from __future__ import annotations

import torch

from hiddenpose_tpu_torch.ops.kernels.attn import (
    attend,
    attend_diff,
    attend_ref,
)
from hiddenpose_tpu_torch.ops.kernels.conv3mxu import (
    conv3_mxu,
    conv3_mxu_bf16,
    conv3_mxu_bwd_diff,
    conv3_mxu_diff,
    conv3_mxu_dx,
    conv3_mxu_dx_bf16,
    conv3_mxu_dx_bf16_ref,
    conv3_mxu_dx_ref,
    conv3_mxu_ref,
)
from hiddenpose_tpu_torch.ops.kernels.conv3p import (
    conv3_planes,
    conv3_planes_adjoint,
    conv3_planes_adjoint_ref,
    conv3_planes_bf16,
    conv3_planes_diff,
    conv3_planes_ref,
    conv3_planes_wgrad,
    conv3_planes_wgrad_ref,
)
from hiddenpose_tpu_torch.ops.kernels.phase_pool import (
    maxpool3d_k3s2p1,
    maxpool3d_k3s2p1_bf16,
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
from hiddenpose_tpu_torch.ops.kernels.probes import (
    probe_dot_f32,
    probe_dot_f32_ref,
    probe_im2col,
    probe_im2col_ref,
    probe_slice_transpose,
    probe_slice_transpose_ref,
)
from hiddenpose_tpu_torch.ops.kernels.stem_conv import (
    stem_conv_raw,
    stem_conv_raw_bf16,
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
    # the bfloat16 model's serving forward (Config.with_bf16(), the JAX
    # server's default): the same TPU kernels on bf16 operands
    "conv3_planes_bf16": (
        conv3_planes_bf16, conv3_planes_ref,
        "hiddenpose_tpu_torch/csrc/conv3p.cu",
        "hiddenpose_tpu/ops/pallas/conv3p.py:1320",
    ),
    "stem_conv_raw_bf16": (
        stem_conv_raw_bf16, stem_conv_raw_ref,
        "hiddenpose_tpu_torch/csrc/stem_conv_bf16.cu",
        "hiddenpose_tpu/ops/pallas/stem_conv.py:141",
    ),
    "maxpool3d_k3s2p1_bf16": (
        maxpool3d_k3s2p1_bf16, maxpool3d_k3s2p1_ref,
        "hiddenpose_tpu_torch/csrc/phase_pool.cu",
        "hiddenpose_tpu/ops/pallas/phase_pool.py:145",
    ),
    "conv3_mxu_bf16": (
        conv3_mxu_bf16, conv3_mxu_ref,
        "hiddenpose_tpu_torch/csrc/conv3mxu_bf16.cu",
        "hiddenpose_tpu/ops/pallas/conv3mxu.py:318",
    ),
    # the train step at the default precision (f32 and bf16 models): the
    # same TPU kernel at compute_dtype 'bf16' on the flipped, swapped taps
    "conv3_mxu_dx_bf16": (
        conv3_mxu_dx_bf16, conv3_mxu_dx_bf16_ref,
        "hiddenpose_tpu_torch/csrc/conv3mxu_bf16.cu",
        "hiddenpose_tpu/ops/pallas/conv3mxu.py:318",
    ),
    "attend": (
        attend, attend_ref,
        "hiddenpose_tpu_torch/csrc/attn.cu",
        "hiddenpose_tpu/ops/pallas/attn_vmem.py:101",
    ),
    "probe_im2col": (
        probe_im2col, probe_im2col_ref,
        "hiddenpose_tpu_torch/csrc/diag_probes.cu",
        "scripts/tpu_diag_stem_paired.py:57",
    ),
    "probe_slice_transpose": (
        probe_slice_transpose, probe_slice_transpose_ref,
        "hiddenpose_tpu_torch/csrc/diag_probes.cu",
        "scripts/tpu_diag_stem_paired.py:89",
    ),
    "probe_dot_f32": (
        probe_dot_f32, probe_dot_f32_ref,
        "hiddenpose_tpu_torch/csrc/diag_probes.cu",
        "scripts/tpu_diag_stem_paired.py:109",
    ),
}

# The kernels NlosPose's eval (serving) forward launches (the bf16 model's:
# SERVING_BF16, and K1 for the UNet's first conv, whose input is f32).  Its
# train step (the library stem conv in training, as the JAX package keeps
# it) at 'high' or 'highest': TRAINING; the f32 model's at 'default', where
# the Bottleneck conv2 takes the library forward and K4-dx-bf16:
# TRAINING_DEFAULT; the bf16 model's at 'default': TRAINING_BF16 (K1 for
# the convs whose input is f32, the FeatureExtraction's and the UNet's
# first; K1's backward, K7 and K8 are the f32 kernels behind casts, as the
# JAX wrappers cast to f32 before their pallas_call).  The Sformer's and
# TimeSformer's forward launches "attend"; the probes run from
# scripts/torch_diag_stem_paired.py.
SERVING = ("conv3_planes", "stem_conv_raw", "maxpool3d_k3s2p1", "conv3_mxu")
SERVING_BF16 = ("conv3_planes_bf16", "stem_conv_raw_bf16",
                "maxpool3d_k3s2p1_bf16", "conv3_mxu_bf16")
TRAINING = ("conv3_planes", "maxpool3d_k3s2p1", "conv3_mxu", "conv3_mxu_dx",
            "conv3_planes_adjoint", "conv3_planes_wgrad",
            "maxpool3d_k3s2p1_vjp", "max_pool2_bwd")
TRAINING_DEFAULT = ("conv3_planes", "maxpool3d_k3s2p1", "conv3_mxu_dx_bf16",
                    "conv3_planes_adjoint", "conv3_planes_wgrad",
                    "maxpool3d_k3s2p1_vjp", "max_pool2_bwd")
TRAINING_BF16 = ("conv3_planes", "conv3_planes_bf16", "maxpool3d_k3s2p1_bf16",
                 "conv3_mxu_dx_bf16", "conv3_planes_adjoint",
                 "conv3_planes_wgrad", "maxpool3d_k3s2p1_vjp",
                 "max_pool2_bwd")
SFORMER = ("attend",)
PROBES = ("probe_im2col", "probe_slice_transpose", "probe_dot_f32")


def bf16_ulp(t):
    """The spacing of bfloat16 values at |t| (float32 tensor out): one unit
    in the last place of a bf16 number of that magnitude, 0 at 0."""
    _, e = torch.frexp(t.float())
    ulp = torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)
    return torch.where(t == 0, torch.zeros_like(ulp), ulp)


def bf16_ulp_excess(got, want, atol):
    """How far ``got`` strays beyond one bf16 ulp of ``want`` plus ``atol``
    (the largest |got - want| - ulp(want) - atol; a result <= 0 passes):
    the limit every bf16 kernel is held to against its plain version."""
    want = want.float()
    d = (got.float() - want).abs() - bf16_ulp(want) - atol
    return d.max().item()


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
