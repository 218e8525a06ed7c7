"""K1: SAME 3x3x3 stride-1 stencil convolution on channels-planes volumes.

Replaces ``hiddenpose_tpu/ops/pallas/conv3p.py::conv3_planes`` (the Pallas
bodies ``_conv3p_kernel`` / ``_conv3p_kernel_db``), with the same argument
order, the same (B, C, D, H, W) planes layout (which is PyTorch's NCDHW)
and a DHWIO kernel.  The CUDA source is ``csrc/conv3p.cu``; its header says
what bounds it on the card (memory traffic, at these 1-64 channels) and how
the shared-memory halo tile answers that.

The TPU kernel's eligibility limits (``cin * cout <= 64``, ``W <= 128``,
``H % 8 == 0``) were limits of its compiler, not of the contract: this
kernel takes any shape, so every FeatureExtraction and UNet 3^3 conv uses
it.

Its gradient (:class:`Conv3Planes`, the port of ``_conv3p_diff``) runs two
more kernels: K5 (:func:`conv3_planes_adjoint`, ``csrc/conv3p_adjoint.cu``)
for dx and K6 (:func:`conv3_planes_wgrad`, ``csrc/conv3p_wgrad.cu``) for
the kernel and bias gradients.  Their TPU counterparts take
``cin * cout <= 64`` and ``<= 32`` and leave the rest to XLA; both Hopper
kernels take every shape of the path.

On a CPU tensor each wrapper runs its plain PyTorch version (``*_ref``); on
a CUDA tensor it launches the kernel or raises.  A wrapper also raises when
an input requires grad and grad mode is on: under autograd only
:func:`conv3_planes_diff` may call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hiddenpose_tpu_torch.ops.kernels import _build

_ACTS = {"none": 0, "relu": 1, "leaky": 2}
_PADS = {"zero": 0, "edge": 1}


def _activation(out, act):
    # torch.relu's gradient at exactly 0 is 0, as the JAX backward's
    # ``out > 0`` mask; clamp_min's would be 1.
    if act == "relu":
        return torch.relu(out)
    if act == "leaky":
        return torch.where(out >= 0.0, out, 0.2 * out)
    return out


def conv3_planes_ref(x, kernel, bias=None, residual=None, pre_scale=None,
                     pre_shift=None, *, act="none", pad_mode="zero",
                     pre_relu=None):
    """Plain version: pre-affine, pad, ``F.conv3d``, bias, residual, act."""
    x = x.float()
    if pre_relu is not None:
        x = x * pre_scale[None, :, None, None, None] \
            + pre_shift[None, :, None, None, None]
        if pre_relu:
            x = torch.relu(x)
    mode = "replicate" if pad_mode == "edge" else "constant"
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode=mode)
    w = kernel.float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    out = F.conv3d(xp, w, bias)
    if residual is not None:
        out = out + residual
    return _activation(out, act)


def conv3_planes(x, kernel, bias=None, residual=None, pre_scale=None,
                 pre_shift=None, *, act="none", pad_mode="zero",
                 pre_relu=None):
    """SAME 3^3 stride-1 conv on (B, C_in, D, H, W).

    out = act(conv(pre(x), kernel) + bias [+ residual]), where
    pre(x) = [relu](x * pre_scale + pre_shift) per input channel when
    ``pre_relu`` is not None (``pre_relu`` chooses the ReLU).  kernel
    (3, 3, 3, C_in, C_out) DHWIO; bias (C_out,); residual
    (B, C_out, D, H, W).  ``pad_mode`` 'zero' or 'edge' (replicate);
    ``act`` 'none', 'relu' or 'leaky' (slope 0.2, after the residual).
    All float32 and contiguous; f32 accumulation.
    """
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if pad_mode not in _PADS:
        raise ValueError(f"pad_mode must be 'zero' or 'edge', got {pad_mode!r}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, C, D, H, W), got {tuple(x.shape)}")
    b, cin, d, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, 3, {cin}, C_out), "
                         f"got {tuple(kernel.shape)}")
    cout = kernel.shape[4]
    _build.no_grad_inputs("conv3_planes", x, kernel, bias, residual,
                          pre_scale, pre_shift, use="conv3_planes_diff")
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(kernel, "kernel", device=dev)
    if bias is not None:
        _build.check(bias, "bias", shape=(cout,), device=dev)
    if residual is not None:
        _build.check(residual, "residual", shape=(b, cout, d, h, w),
                     device=dev)
    if pre_relu is not None:
        if pre_scale is None or pre_shift is None:
            raise ValueError("pre_relu given without pre_scale/pre_shift")
        _build.check(pre_scale, "pre_scale", shape=(cin,), device=dev)
        _build.check(pre_shift, "pre_shift", shape=(cin,), device=dev)
    if dev.type == "cpu":
        return conv3_planes_ref(
            x, kernel, bias, residual, pre_scale, pre_shift, act=act,
            pad_mode=pad_mode, pre_relu=pre_relu)
    if dev.type != "cuda":
        raise ValueError(f"conv3_planes: unsupported device {dev}")

    out = torch.empty((b, cout, d, h, w), device=dev, dtype=torch.float32)
    pre_mode = 0 if pre_relu is None else (2 if pre_relu else 1)
    use_pre = pre_relu is not None
    _build.launch(
        "hp_conv3p_fwd", x.data_ptr(), kernel.data_ptr(), _build.ptr(bias),
        _build.ptr(residual), _build.ptr(pre_scale if use_pre else None),
        _build.ptr(pre_shift if use_pre else None), out.data_ptr(),
        b, cin, cout, d, h, w, _PADS[pad_mode], _ACTS[act], pre_mode)
    conv3_planes.launches += 1
    return out


conv3_planes.launches = 0


def _pad_name(pad_mode):
    if pad_mode not in _PADS:
        raise ValueError(f"pad_mode must be 'zero' or 'edge', got {pad_mode!r}")
    return "replicate" if pad_mode == "edge" else "constant"


def conv3_planes_adjoint_ref(dz, kernel, *, pad_mode="zero"):
    """Plain version: the VJP of "pad, then VALID conv" by autograd."""
    b, _, d, h, w = dz.shape
    mode = _pad_name(pad_mode)
    wt = kernel.detach().float().permute(4, 3, 0, 1, 2)
    with torch.enable_grad():
        x = torch.zeros((b, kernel.shape[3], d, h, w), device=dz.device,
                        requires_grad=True)
        out = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1), mode=mode), wt)
        (dx,) = torch.autograd.grad(out, x, dz.detach().float())
    return dx


def conv3_planes_adjoint(dz, kernel, *, pad_mode="zero"):
    """dL/dx of :func:`conv3_planes` given dz = dL/d(pre-activation).

    dz (B, C_out, D, H, W), kernel (3, 3, 3, C_in, C_out): the FORWARD
    kernel.  Returns (B, C_in, D, H, W) float32: dx[i] = sum of
    k[t] . dz[o] over every (o, t) whose padded read lands on i (with edge
    padding the boundary voxels also collect the clamped halo reads)."""
    _pad_name(pad_mode)
    if dz.dim() != 5:
        raise ValueError(f"dz must be (B, C, D, H, W), got {tuple(dz.shape)}")
    b, cout, d, h, w = dz.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:3]) != (3, 3, 3) \
            or kernel.shape[4] != cout:
        raise ValueError(f"kernel must be (3, 3, 3, C_in, {cout}), "
                         f"got {tuple(kernel.shape)}")
    cin = kernel.shape[3]
    _build.no_grad_inputs("conv3_planes_adjoint", dz, kernel,
                          use="conv3_planes_diff")
    dev = dz.device
    _build.check(dz, "dz", device=dev)
    _build.check(kernel, "kernel", device=dev)
    if dev.type == "cpu":
        return conv3_planes_adjoint_ref(dz, kernel, pad_mode=pad_mode)
    if dev.type != "cuda":
        raise ValueError(f"conv3_planes_adjoint: unsupported device {dev}")

    dx = torch.empty((b, cin, d, h, w), device=dev, dtype=torch.float32)
    _build.launch("hp_conv3p_adjoint", dz.data_ptr(), kernel.data_ptr(),
                  dx.data_ptr(), b, cin, cout, d, h, w, _PADS[pad_mode])
    conv3_planes_adjoint.launches += 1
    return dx


conv3_planes_adjoint.launches = 0


def conv3_planes_wgrad_ref(x, dz, *, pad_mode="zero", has_bias=True):
    """Plain version: ``conv3d_weight`` of the padded input, and the sum
    of dz over (B, D, H, W)."""
    mode = _pad_name(pad_mode)
    xp = F.pad(x.detach().float(), (1, 1, 1, 1, 1, 1), mode=mode)
    dz = dz.detach().float()
    dk = torch.nn.grad.conv3d_weight(
        xp, (dz.shape[1], x.shape[1], 3, 3, 3), dz)
    db = dz.sum(dim=(0, 2, 3, 4)) if has_bias else None
    return dk.permute(2, 3, 4, 1, 0).contiguous(), db


def conv3_planes_wgrad(x, dz, *, pad_mode="zero", has_bias=True):
    """dL/dkernel (3, 3, 3, C_in, C_out) and dL/dbias (C_out,) (or None)
    of :func:`conv3_planes`, from x (B, C_in, D, H, W) and
    dz (B, C_out, D, H, W) = dL/d(pre-activation).  Summed in a fixed
    order on the GPU, so a result repeats exactly from run to run."""
    _pad_name(pad_mode)
    if x.dim() != 5 or dz.dim() != 5 or x.shape[0] != dz.shape[0] \
            or x.shape[2:] != dz.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and dz {tuple(dz.shape)} must "
                         "be (B, C, D, H, W) with equal B, D, H, W")
    b, cin, d, h, w = x.shape
    cout = dz.shape[1]
    _build.no_grad_inputs("conv3_planes_wgrad", x, dz,
                          use="conv3_planes_diff")
    dev = x.device
    _build.check(x, "x", device=dev)
    _build.check(dz, "dz", device=dev)
    if dev.type == "cpu":
        return conv3_planes_wgrad_ref(x, dz, pad_mode=pad_mode,
                                      has_bias=has_bias)
    if dev.type != "cuda":
        raise ValueError(f"conv3_planes_wgrad: unsupported device {dev}")

    # First pass: `chunks` partial sums per output, each over a fixed run
    # of voxel tiles; second pass: their sum, in chunk order.  About 4096
    # partial rows in all keeps the scratch small and the grid full.
    chunks = max(1, min(1024, 4096 // (cin * cout)))
    rows = 27 * cin * cout + cout
    partial = torch.empty((chunks, rows), device=dev, dtype=torch.float32)
    dk = torch.empty((3, 3, 3, cin, cout), device=dev, dtype=torch.float32)
    db = (torch.empty((cout,), device=dev, dtype=torch.float32)
          if has_bias else None)
    _build.launch("hp_conv3p_wgrad", x.data_ptr(), dz.data_ptr(),
                  partial.data_ptr(), dk.data_ptr(), _build.ptr(db), b, cin,
                  cout, d, h, w, _PADS[pad_mode], chunks)
    conv3_planes_wgrad.launches += 1
    return dk, db


conv3_planes_wgrad.launches = 0


class Conv3Planes(torch.autograd.Function):
    """Differentiable K1: the port of ``_conv3p_diff``
    (``hiddenpose_tpu/ops/pallas/conv3p.py:1242-1317``).

    Forward K1, saving the output when ``act != 'none'``.  Backward:
    dz = g masked by ``out > 0`` (relu) or ``out >= 0 -> 1, else 0.2``
    (leaky); dx by K5 (only when x needs a gradient), dk and db by K6,
    dres = dz."""

    @staticmethod
    def forward(ctx, x, kernel, bias, residual, act, pad_mode):
        out = conv3_planes(x, kernel, bias, residual, act=act,
                           pad_mode=pad_mode)
        ctx.act, ctx.pad_mode = act, pad_mode
        ctx.save_for_backward(x, kernel, out if act != "none" else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, out = ctx.saved_tensors
        need_x, need_k, need_b, need_res = ctx.needs_input_grad[:4]
        g = g.contiguous()
        if ctx.act == "relu":
            dz = torch.where(out > 0, g, 0.0)
        elif ctx.act == "leaky":
            dz = g * torch.where(out >= 0, 1.0, 0.2)
        else:
            dz = g
        dx = (conv3_planes_adjoint(dz, kernel, pad_mode=ctx.pad_mode)
              if need_x else None)
        dk = db = None
        if need_k or need_b:
            dk, db = conv3_planes_wgrad(x, dz, pad_mode=ctx.pad_mode,
                                        has_bias=need_b)
        return (dx, dk if need_k else None, db, dz if need_res else None,
                None, None)


def conv3_planes_diff(x, kernel, bias=None, residual=None, *, act="none",
                      pad_mode="zero"):
    """Differentiable :func:`conv3_planes` (no pre-affine, as the JAX
    package's ``conv3_planes_diff``)."""
    return Conv3Planes.apply(x, kernel, bias, residual, act, pad_mode)
