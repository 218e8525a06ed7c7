"""K9: fused short-sequence attention, ``softmax(q k^T) v`` in one pass.

Replaces ``hiddenpose_tpu/ops/pallas/attn_vmem.py::attend_fused`` (body
``_attn_kernel``): the grouped patch attention of the Sformer
(``models/sformer.py::JointTokenAttention``: per layer 1024 groups of
Lq 1024, Lk 1048, head dim 32 at full width) and of the TimeSformer.  The
plain formulation writes the f32 score tensor to device memory and reads it
back twice; the kernel never does.  The CUDA source is ``csrc/attn.cu``; its
header says what bounds it (the fp32 FMA rate, once the scores stay on the
chip) and how the streaming, online-softmax design answers that.

Contract (the JAX function's): ``out = softmax(q k^T, axis=-1) v`` for q
(B, Lq, dh) **already scaled** by ``dh ** -0.5``, k and v (B, Lk, dh); f32
scores and f32 max-subtracted softmax; the probabilities cast to
``v.dtype`` before the second product; f32 accumulation; output
``v.dtype``.  No mask, no dropout.  The (q/k, v) dtypes taken are
(f32, f32), (bf16, bf16) and (f32, bf16): the last is what the Sformer's
bfloat16 mode feeds it, where the float32 rotary tables promote q and k.
f32 inputs use fp32 FMA only, never TF32.

Which shapes go where.  The kernel takes every head dim that is a multiple
of 4 up to 256 and any Lq and Lk (it masks ragged tails itself; the TPU
kernel's ``Lq % 8`` and ``dh % 8`` were its compiler's limits).  The
model's router (:func:`attend_routed`) sends it every such call with
``Lk <= 4096``: every shape the TPU router sends and more.  Calls with
longer keys stay on the library path (``torch.bmm`` / ``softmax``): that is
the joint-token read (Lq = 24, Lk = 131 096 at full width), whose 8 groups
of 24 rows would occupy 8 blocks of the card's 132 SMs, each walking all
131 k keys alone, because this kernel does not split keys across blocks:
at that shape it takes 15.5 ms against 5.1 ms for the library path
(``chip_smoke.py`` phase 3, NVIDIA H100 80GB HBM3, 700 W).

* :func:`attend_ref`: the plain version, used by the tests, by CPU
  tensors and by ``set_use_kernels(False)``;
* :func:`attend`: the raw wrapper.  On a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel or raises.  It raises
  when an input requires grad and grad mode is on;
* :func:`attend_diff` (:class:`AttendFused`): forward the kernel, backward
  the plain attention gradient (a recompute through :func:`attend_ref`),
  as the JAX package's custom VJP is ``jax.vjp(attend_ref, ...)``: the TPU
  kernel has no backward kernel, so the port has none.
"""

from __future__ import annotations

import torch

from hiddenpose_tpu_torch.ops.kernels import _build

MAX_DH = 256
ROUTED_MAX_LK = 4096
_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16))


def attend_supported(q_shape, k_shape) -> bool:
    """Shapes the kernel takes: head dim a multiple of 4 up to 256."""
    _, lq, dh = q_shape
    _, lk, _ = k_shape
    return (dh % 4 == 0 and 4 <= dh <= MAX_DH and lq >= 1 and lk >= 1
            and q_shape[0] >= 1)


def attend_routed(q_shape, k_shape) -> bool:
    """Whether the model sends this call to the kernel: a shape it takes
    with at most 4096 keys.  Longer keys mean few, long groups, which the
    kernel is measured slower on (see the module docstring)."""
    return attend_supported(q_shape, k_shape) and k_shape[1] <= ROUTED_MAX_LK


def attend_ref(q, k, v):
    """Plain version: f32 scores and softmax, probabilities cast to
    ``v.dtype``, f32-accumulated second product, output ``v.dtype``."""
    sim = torch.bmm(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.bmm(attn.float(), v.float()).to(v.dtype)


def attend(q, k, v):
    """q (B, Lq, dh), scaled; k, v (B, Lk, dh) -> (B, Lq, dh) ``v.dtype``."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be (B, L, dh), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    b, lq, dh = q.shape
    lk = k.shape[1]
    if not attend_supported(q.shape, k.shape):
        raise ValueError(f"attend takes non-empty q and k with dh % 4 == 0, "
                         f"4 <= dh <= {MAX_DH}, "
                         f"got q {tuple(q.shape)} k {tuple(k.shape)}")
    if (q.dtype, v.dtype) not in _DTYPES:
        raise TypeError(f"attend takes (q/k, v) dtypes (float32, float32), "
                        f"(bfloat16, bfloat16) or (float32, bfloat16), got "
                        f"({q.dtype}, {v.dtype})")
    _build.no_grad_inputs("attend", q, k, v, use="attend_diff")
    dev = q.device
    _build.check(q, "q", device=dev, aligned=True, dtype=q.dtype)
    _build.check(k, "k", shape=(b, lk, dh), device=dev, aligned=True,
                 dtype=q.dtype)
    _build.check(v, "v", shape=(b, lk, dh), device=dev, aligned=True,
                 dtype=v.dtype)
    if dev.type == "cpu":
        return attend_ref(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"attend: unsupported device {dev}")

    out = torch.empty((b, lq, dh), device=dev, dtype=v.dtype)
    _build.launch("hp_attend_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, lq, lk, dh,
                  int(q.dtype == torch.bfloat16),
                  int(v.dtype == torch.bfloat16))
    attend.launches += 1
    return out


attend.launches = 0


class AttendFused(torch.autograd.Function):
    """Differentiable K9: forward the kernel, backward the plain attention
    gradient, recomputed through :func:`attend_ref`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attend(q, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attend_ref(q, k, v)
        need = ctx.needs_input_grad
        inputs = [t for t, n in zip((q, k, v), need) if n]
        grads = iter(torch.autograd.grad(out, inputs, g))
        return tuple(next(grads) if n else None for n in need)


def attend_diff(q, k, v):
    """Differentiable :func:`attend`."""
    return AttendFused.apply(q, k, v)
