"""K4: 3x3x3 stride-1 pad-1 conv, channels-last, fused BN affine + ReLU.

Replaces ``hiddenpose_tpu/ops/pallas/conv3mxu.py::conv3_mxu`` (body
``_conv3mxu_kernel``): the Bottleneck conv2 of the stride-1 c64 @64^3,
c128 @32^3 and c256 @16^3 blocks, with the eval BatchNorm affine and the
ReLU as an epilogue.  Same argument order and NDHWC / DHWIO layouts as the
JAX function; the arithmetic is full f32 (the JAX path's
``compute_dtype='f32'``): fp32 FMA, no TF32.  The CUDA source is
``csrc/conv3mxu.cu``; its header says what bounds it (fp32 FMA issue and
operand reuse) and how the SIMT implicit-GEMM tiling answers that.

Its gradient (:class:`Conv3Mxu`, the port of ``conv3_mxu_diff`` /
``_conv3_bwd``, ``hiddenpose_tpu/ops/pallas/conv3mxu.py:524-589``) runs
the same kernel for dx, on the spatially flipped, in/out-swapped weights
(:func:`conv3_mxu_dx`, counted apart), and leaves dk to the library's
weight gradient, as the JAX package leaves it to XLA's native one.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  A wrapper also raises when an input
requires grad and grad mode is on: under autograd only
:func:`conv3_mxu_diff` may call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build


def conv3mxu_supported(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes (its 16-deep k-slices lie inside one
    tap; its 64-wide output tiles never straddle C_out)."""
    return cin % 16 == 0 and cout % 64 == 0 and cin > 0 and cout > 0


def conv3_mxu_ref(x, k, scale=None, shift=None, relu=False):
    """Plain version: ``F.conv3d(pad=1)`` + affine + ReLU, NDHWC in/out."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 k.float().permute(4, 3, 0, 1, 2), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if scale is not None:
        y = y * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.contiguous()


def conv3_mxu(x, k, scale=None, shift=None, relu=False):
    """x (B, D, H, W, C_in); k (3, 3, 3, C_in, C_out) DHWIO; optional
    per-C_out ``scale``/``shift`` (both or neither) then optional ReLU.
    Returns (B, D, H, W, C_out) float32."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if k.dim() != 5 or tuple(k.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"k must be (3, 3, 3, {cin}, C_out), "
                         f"got {tuple(k.shape)}")
    cout = k.shape[4]
    if not conv3mxu_supported(cin, cout):
        raise ValueError(f"conv3_mxu takes C_in % 16 == 0 and C_out % 64 == 0,"
                         f" got {cin} -> {cout}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    _build.no_grad_inputs("conv3_mxu", x, k, scale, shift,
                          use="conv3_mxu_diff")
    dev = x.device
    _build.check(x, "x", device=dev, aligned=True)
    _build.check(k, "k", device=dev, aligned=True)
    if scale is not None:
        _build.check(scale, "scale", shape=(cout,), device=dev)
        _build.check(shift, "shift", shape=(cout,), device=dev)
    if dev.type == "cpu":
        return conv3_mxu_ref(x, k, scale, shift, relu)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu: unsupported device {dev}")

    out = _launch(x, k, scale, shift, relu)
    conv3_mxu.launches += 1
    return out


conv3_mxu.launches = 0


def _launch(x, k, scale=None, shift=None, relu=False):
    b, d, h, w, cin = x.shape
    cout = k.shape[4]
    out = torch.empty((b, d, h, w, cout), device=x.device,
                      dtype=torch.float32)
    _build.launch(
        "hp_conv3_mxu_fwd", x.data_ptr(), k.data_ptr(), _build.ptr(scale),
        _build.ptr(shift), out.data_ptr(), b, d, h, w, cin, cout,
        int(bool(relu)))
    return out


def flip_swap(k):
    """The dx weights of a SAME 3^3 conv: taps flipped, in/out swapped."""
    return torch.flip(k, (0, 1, 2)).transpose(3, 4).contiguous()


def conv3_mxu_dx_ref(dz, k):
    """Plain version: ``torch.nn.grad.conv3d_input``, NDHWC in/out."""
    b, d, h, w, _ = dz.shape
    dx = torch.nn.grad.conv3d_input(
        (b, k.shape[3], d, h, w), k.detach().float().permute(4, 3, 0, 1, 2),
        dz.detach().float().permute(0, 4, 1, 2, 3), padding=1)
    return dx.permute(0, 2, 3, 4, 1).contiguous()


def conv3_mxu_dx(dz, k):
    """dL/dx of :func:`conv3_mxu` (no epilogue) given dz (B, D, H, W,
    C_out): the K4 kernel on :func:`flip_swap` of k.  Returns
    (B, D, H, W, C_in)."""
    if dz.dim() != 5 or k.dim() != 5 or tuple(k.shape[:3]) != (3, 3, 3) \
            or k.shape[4] != dz.shape[4]:
        raise ValueError(f"dz {tuple(dz.shape)} must be (B, D, H, W, C_out) "
                         f"of k (3, 3, 3, C_in, C_out), got {tuple(k.shape)}")
    cin, cout = k.shape[3], k.shape[4]
    if not conv3mxu_supported(cout, cin):
        raise ValueError(f"conv3_mxu_dx runs the kernel {cout} -> {cin}: "
                         "needs C_out % 16 == 0 and C_in % 64 == 0")
    _build.no_grad_inputs("conv3_mxu_dx", dz, k, use="conv3_mxu_diff")
    dev = dz.device
    _build.check(dz, "dz", device=dev, aligned=True)
    _build.check(k, "k", device=dev)
    if dev.type == "cpu":
        return conv3_mxu_dx_ref(dz, k)
    if dev.type != "cuda":
        raise ValueError(f"conv3_mxu_dx: unsupported device {dev}")
    out = _launch(dz, flip_swap(k))
    conv3_mxu_dx.launches += 1
    return out


conv3_mxu_dx.launches = 0


class Conv3Mxu(torch.autograd.Function):
    """Differentiable K4 without epilogue: forward K4, dx K4 on the
    flipped, swapped taps, dk the library's weight gradient."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return conv3_mxu(x, k)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_k = ctx.needs_input_grad
        dx = conv3_mxu_dx(g, k) if need_x else None
        dk = None
        if need_k:
            dk = torch.nn.grad.conv3d_weight(
                x.permute(0, 4, 1, 2, 3), (k.shape[4], k.shape[3], 3, 3, 3),
                g.permute(0, 4, 1, 2, 3), padding=1).permute(2, 3, 4, 1, 0)
        return dx, dk


def conv3_mxu_diff(x, k):
    """Differentiable :func:`conv3_mxu` (no epilogue: training applies BN
    with batch statistics to the raw conv output)."""
    return Conv3Mxu.apply(x, k)
