"""K9: fused attention, ``softmax(q k^T) v`` in one pass.

Replaces ``hiddenpose_tpu/ops/pallas/attn_vmem.py::attend_fused`` (body
``_attn_kernel``): the grouped patch attention of the Sformer
(``models/sformer.py::JointTokenAttention``: per layer 1024 groups of
Lq 1024, Lk 1048, head dim 32 at full width) and of the TimeSformer.  The
plain formulation writes the f32 score tensor to device memory and reads it
back twice; the kernel never does.  The CUDA source is ``csrc/attn.cu``; its
header says what bounds it and how the design answers that: at head dim 32
both products run on the tensor cores (``wgmma``), k and v stream through a
shared-memory ring, the softmax is the online one, and few-row, long-key
calls are split over the keys across blocks.

Contract (the JAX function's): ``out = softmax(q k^T, axis=-1) v`` for q
(B, Lq, dh) **already scaled** by ``dh ** -0.5``, k and v (B, Lk, dh); f32
scores and f32 max-subtracted softmax; the probabilities cast to
``v.dtype`` before the second product; f32 accumulation; output
``v.dtype``.  No mask, no dropout.  The (q/k, v) dtypes taken are
(f32, f32), (bf16, bf16) and (f32, bf16): the last is what the Sformer's
bfloat16 mode feeds it, where the float32 rotary tables promote q and k.
An f32 operand never takes a single TF32 pass: on the tensor cores it is
split into TF32 hi and lo parts and multiplied in three passes (3xTF32,
:func:`attend_3xtf32_ref` is that arithmetic in plain PyTorch), which errs
against a float64 attention no more than the plain f32 version does; head
dims other than 32 use fp32 FMA.

Which shapes go where.  The kernel takes every head dim that is a multiple
of 4 up to 256 and any Lq and Lk (it masks ragged tails itself; the TPU
kernel's ``Lq % 8``, ``dh % 8`` and ``Lk <= 4096`` were its compiler's and
its fast memory's limits).  The model's router (:func:`attend_routed`)
sends it every such call: every shape the TPU router sends, and the
joint-token read (Lq = 24, Lk = 131 096 at full width), which the TPU
router leaves to XLA.  There 8 groups of 24 rows cannot fill 132 SMs, so
the kernel cuts the keys into chunks (65 of 2048 at that shape), a block a
chunk, and a second small kernel combines the chunks' running max, sum and
unnormalised accumulator in chunk order (:func:`attend_split_ref` is that
in plain PyTorch; no atomics, so two calls agree bit for bit): 0.18 ms a
call against 5.09 ms for ``torch.bmm`` / ``softmax`` / ``bmm``, whose
batched GEMM does not split the keys (``chip_smoke.py`` phase 3, NVIDIA
H100 80GB HBM3, 700 W).

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
from hiddenpose_tpu_torch.ops.kernels._tf32 import tf32_split

MAX_DH = 256
_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.bfloat16))


def attend_supported(q_shape, k_shape) -> bool:
    """Shapes the kernel takes: head dim a multiple of 4 up to 256."""
    _, lq, dh = q_shape
    _, lk, _ = k_shape
    return (dh % 4 == 0 and 4 <= dh <= MAX_DH and lq >= 1 and lk >= 1
            and q_shape[0] >= 1)


def attend_routed(q_shape, k_shape) -> bool:
    """Whether the model sends this call to the kernel: every shape it
    takes.  Few rows against long keys (the joint-token read) are split
    over the keys inside the kernel (see the module docstring)."""
    return attend_supported(q_shape, k_shape)


def attend_ref(q, k, v):
    """Plain version: f32 scores and softmax, probabilities cast to
    ``v.dtype``, f32-accumulated second product, output ``v.dtype``."""
    sim = torch.bmm(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.bmm(attn.float(), v.float()).to(v.dtype)


def _bmm_3xtf32(a, b):
    """a @ b as the tensor cores take f32 operands: both split into TF32 hi
    and lo parts, three f32 products, the two small terms summed first."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)


def attend_3xtf32_ref(q, k, v):
    """The kernel's arithmetic in plain PyTorch.  f32 q and k: the scores as
    three TF32 products (:func:`_bmm_3xtf32`); bf16 q and k: one exact
    product.  f32 max-subtracted exponentials p and their row sum l.  An
    f32 v: ``p v`` as three TF32 products; a bf16 v: one product on p
    rounded to bf16 (l is summed before the rounding).  The quotient by l
    comes last, as in the kernel."""
    kt = k.float().transpose(1, 2).contiguous()
    if q.dtype == torch.float32:
        sim = _bmm_3xtf32(q, kt)
    else:
        sim = torch.bmm(q.float(), kt)
    p = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if v.dtype == torch.float32:
        acc = _bmm_3xtf32(p, v)
    else:
        acc = torch.bmm(p.to(v.dtype).float(), v.float())
    return (acc / l).to(v.dtype)


def attend_split_ref(q, k, v, splits: int):
    """Plain version of the split over the keys: the keys are cut into
    ``splits`` chunks of ``ceil(Lk / splits)``; each chunk gives its rows'
    running max m, sum l and unnormalised accumulator; the chunks combine
    in order as ``sum_s exp(m_s - m) acc_s / sum_s exp(m_s - m) l_s``.  A
    chunk with no key (m = -inf, l = 0) weighs 0."""
    b, lq, dh = q.shape
    lk = k.shape[1]
    chunk = -(-lk // splits)
    ms, ls, accs = [], [], []
    for s in range(splits):
        ks = k[:, s * chunk:(s + 1) * chunk].float()
        vs = v[:, s * chunk:(s + 1) * chunk]
        if ks.shape[1] == 0:
            ms.append(q.new_full((b, lq, 1), float("-inf"), dtype=torch.float32))
            ls.append(q.new_zeros((b, lq, 1), dtype=torch.float32))
            accs.append(q.new_zeros((b, lq, dh), dtype=torch.float32))
            continue
        sim = torch.bmm(q.float(), ks.transpose(1, 2))
        m = sim.amax(dim=-1, keepdim=True)
        p = torch.exp(sim - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.bmm(p.to(v.dtype).float(), vs.float()))
    m = torch.stack(ms).amax(dim=0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(ls[0])
    for m_s, l_s, acc_s in zip(ms, ls, accs):
        w = torch.exp(m_s - m)
        num = num + w * acc_s
        den = den + w * l_s
    return (num / den).to(v.dtype)


LOG2E = 1.4426950408889634  # the kernel's base-2 exponentials' factor
KEY_TILE = 64                 # keys a softmax update of the kernel takes


def attend_online_ref(q, k, v, chunk=None):
    """The kernel's softmax order in plain PyTorch, so that a computation
    through it rounds where the kernel rounds: the tensor-core form's
    (head dim 32; the SIMT form updates every 8 keys).  The keys pass in
    tiles of 64.  A row keeps its running max n in base-2 units (the max score
    times log2 e, over its chunk's tiles so far); a tile's weights are
    p = 2^(s log2 e - n), rounded to ``v.dtype`` before ``p v`` (the row
    sum l is taken before the rounding), and its ``p v`` and l enter the
    chunk's sums scaled by 2^(n - n_last).  ``chunk``: keys a chunk, a
    multiple of 64 (:func:`attend_chunk`; None, one chunk); the chunks
    combine as :func:`attend_split_ref` combines them.  Scores, and an f32
    ``p v``, as :func:`attend_3xtf32_ref`.  What is left against the
    kernel is float32 rounding: the sums' order and ``ex2.approx``.  With
    a bf16 v, :func:`attend_3xtf32_ref` rounds p against the row's final
    max, which differs from the kernel's at every tile before the max."""
    b, lq, dh = q.shape
    lk = k.shape[1]
    tiles = -(-lk // KEY_TILE)
    per = tiles if chunk is None else chunk // KEY_TILE
    if per < 1 or (chunk is not None and chunk % KEY_TILE):
        raise ValueError(f"chunk must be a multiple of {KEY_TILE}, got "
                         f"{chunk}")
    nchunks = -(-tiles // per)
    # groups a slice: about 2^27 scores, so that the full-width grouped
    # call (1024 groups of 1024 x 1048) runs in a few GB
    step = max(1, (1 << 27) // (lq * nchunks * per * KEY_TILE))
    return torch.cat([_online_slice(q[g:g + step], k[g:g + step],
                                    v[g:g + step], nchunks, per)
                      for g in range(0, b, step)])


def _online_slice(q, k, v, nchunks, per):
    g, lq, dh = q.shape
    lk = k.shape[1]
    keys = nchunks * per * KEY_TILE
    kt = torch.nn.functional.pad(k.float(), (0, 0, 0, keys - lk))
    kt = kt.transpose(1, 2).contiguous()
    if q.dtype == torch.float32:
        s = _bmm_3xtf32(q, kt)
    else:
        s = torch.bmm(q.float(), kt)
    s[..., lk:] = float("-inf")
    s = s.view(g, lq, nchunks, per, KEY_TILE)
    n = torch.cummax(s.amax(dim=-1) * LOG2E, dim=-1).values
    p = torch.exp2(s * LOG2E - n[..., None])
    del s
    w = torch.exp2(n - n[..., -1:])             # 2^(n - n_last) a tile
    l = (p.sum(dim=-1) * w).sum(dim=-1)         # (g, lq, chunks)
    vt = torch.nn.functional.pad(v, (0, 0, 0, keys - lk))
    vt = vt.reshape(g * nchunks * per, KEY_TILE, dh)
    pt = p.view(g, lq, nchunks * per, KEY_TILE).transpose(1, 2)
    pt = pt.reshape(g * nchunks * per, lq, KEY_TILE)
    del p
    if v.dtype == torch.float32:
        part = _bmm_3xtf32(pt, vt)
    else:
        part = torch.bmm(pt.to(v.dtype).float(), vt.float())
    part = part.view(g, nchunks, per, lq, dh)
    acc = (part * w.permute(0, 2, 3, 1)[..., None]).sum(dim=2)
    m = n[..., -1].transpose(1, 2)[..., None]   # (g, chunks, lq, 1)
    l = l.transpose(1, 2)[..., None]
    if nchunks > 1:
        c = torch.exp2(m - m.amax(dim=1, keepdim=True))
        acc, l = (c * acc).sum(dim=1), (c * l).sum(dim=1)
    else:
        acc, l = acc[:, 0], l[:, 0]
    return (acc * (1.0 / l)).to(v.dtype)


def attend_chunk(b: int, lq: int, lk: int, dh: int) -> int:
    """Keys a chunk in the kernel's plan for this shape (a multiple of 64;
    Lk rounded up to 64 where the plan is one chunk).  Builds the kernel
    library: CUDA only."""
    return int(_build.library().hp_attend_chunk(b, lq, lk, dh))


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

    # The kernel's own plan: S > 1 chunks of keys for few-row, long-key
    # calls, whose partial rows pass through a workspace.
    splits = _build.library().hp_attend_plan(b, lq, lk, dh)
    if splits < 1:
        raise ValueError(f"attend: the kernel takes no shape "
                         f"q {tuple(q.shape)} k {tuple(k.shape)}")
    ws = (torch.empty(splits * b * lq * (dh + 2), device=dev,
                      dtype=torch.float32) if splits > 1 else None)
    out = torch.empty((b, lq, dh), device=dev, dtype=v.dtype)
    _build.launch("hp_attend_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), _build.ptr(ws), b, lq, lk, dh,
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
