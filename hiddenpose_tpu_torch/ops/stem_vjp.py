"""The train-mode stem conv with a backward rewritten as matrix products.

Port of the VJP of ``hiddenpose_tpu/ops/space_to_depth.py::
conv_s2d_stem_diff`` (``_stem_conv_bwd`` for dk, ``_stem_dx_mm`` for dx).
The reference runs it on the space-to-depth form of the volume, a layout of
its own hardware that the port does not need: here the same backward runs
on the raw (B, 1, D, H, W) volume and the (C_out, 1, k, k, k) weight of the
stem's 7^3 conv, stride 1, padding k // 2.

Why not autograd of ``F.conv3d``: with one input channel the library's f32
weight and input gradients run in direct kernels that take most of a train
step at 2 x 128^3.  As in the reference, both gradients become dense
products, one depth tap ``a`` at a time so that no full im2col matrix
(k^3 rows x B D H W) ever exists:

* dk[:, 0, a] = patches_a (k^2 x N) . dy (N x C_out), where row (bh, cw) of
  patches_a is the padded input shifted by (a, bh, cw).  The groups have
  disjoint outputs.  The product is taken per sample and depth plane as a
  batched product (K = H W each) and the planes' partial results are summed
  afterwards: many independent products fill the card where one product
  with a (k^2 x C_out) result and K in the millions would not, and the
  order of the sum is fixed.
* dx: U_a = k[a] (k^2 x C_out) . dy (C_out x N), then the k^2 rows of U_a,
  each shifted by its tap, are added into a zero-padded accumulator whose
  interior is dx (the reference pads dy instead; padding the accumulator
  is the same sum and avoids a padded copy of dy, which is the largest
  tensor here).  The adds are in place on views.

One scratch buffer of k^2 x D H W floats serves both the patches and U_a of
every (sample, tap) pair.  Everything is ``torch.matmul`` / ``torch.bmm``
and copies: the reference computes these products outside any Pallas
kernel, so no hand-written kernel stands here.  float32 throughout for the
float32 model (the reference's bf16 operand cast of f32 operands is for its
own hardware and off on its CPU oracle); any floating dtype works, which
the float64 tests use.

The bfloat16 model's stem conv takes bf16 x and weight (the reference's
``conv_s2d_stem_diff`` on bf16 operands, ``space_to_depth.py:191-197,
250-252``): its backward widens them to f32, which holds every product of
two bf16 values exactly (TF32 too), runs the same f32 products and sums,
and returns dx and dk in the operands' type: the contract of bf16 operands
with f32 sums.  (The reference also rounds its s2d-space partial products
to bf16 before the shifted adds; the port's partial products are other
sums, of the raw volume's taps, so that rounding has no counterpart here.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _check(x, weight):
    if x.dim() != 5 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, D, H, W), got {tuple(x.shape)}")
    if weight.dim() != 5 or weight.shape[1] != 1 \
            or len(set(weight.shape[2:])) != 1 or weight.shape[2] % 2 == 0:
        raise ValueError("weight must be (C_out, 1, k, k, k) with k odd, got "
                         f"{tuple(weight.shape)}")


def stem_conv_dk(x, dy, k: int):
    """dL/dweight (C_out, 1, k, k, k) of ``F.conv3d(x, weight, padding=k //
    2)`` from x (B, 1, D, H, W) and dy (B, C_out, D, H, W)."""
    b, _, d, h, w = x.shape
    co = dy.shape[1]
    p = k // 2
    xp = F.pad(x[:, 0], (p,) * 6)
    # (B, C_out, D, H W): a view for a dense NCDHW or channels-last dy
    dyv = dy.flatten(3)
    buf = x.new_empty((d, k, k, h, w))
    dk = x.new_empty((k, k * k, co))
    for a in range(k):
        acc = None
        for i in range(b):
            # patches[d, bh, cw, h, w] = xp[i, a + d, bh + h, cw + w]
            buf.copy_(xp[i, a:a + d].unfold(1, h, 1).unfold(2, w, 1))
            part = torch.bmm(buf.view(d, k * k, h * w),
                             dyv[i].permute(1, 2, 0))     # (D, k^2, C_out)
            part = part.sum(0)
            acc = part if acc is None else acc.add_(part)
        dk[a] = acc
    return dk.view(k, k, k, co).permute(3, 0, 1, 2).unsqueeze(1).contiguous()


def stem_conv_dx(weight, dy):
    """dL/dx (B, 1, D, H, W) of ``F.conv3d(x, weight, padding=k // 2)`` from
    weight (C_out, 1, k, k, k) and dy (B, C_out, D, H, W)."""
    b, co, d, h, w = dy.shape
    k = weight.shape[2]
    p = k // 2
    # rows (a, bh, cw), columns C_out
    km = weight[:, 0].permute(1, 2, 3, 0).reshape(k, k * k, co)
    dyv = dy.flatten(2)                                   # (B, C_out, N)
    u = dy.new_empty((k * k, d, h, w))
    # The forward read x[o + t - p] with tap t for output o, so dy[o] goes
    # to padded index o + t: dxp[o + (a, bh, cw)] += U_a[bh, cw][o]; dx is
    # the interior.
    dxp = dy.new_zeros((b, d + 2 * p, h + 2 * p, w + 2 * p))
    for i in range(b):
        for a in range(k):
            torch.matmul(km[a], dyv[i], out=u.view(k * k, d * h * w))
            for bh in range(k):
                for cw in range(k):
                    dxp[i, a:a + d, bh:bh + h, cw:cw + w].add_(u[bh * k + cw])
    return dxp[:, p:p + d, p:p + h, p:p + w].unsqueeze(1).contiguous()


class StemConvDiff(torch.autograd.Function):
    """Forward: the library conv, in x's type.  Backward:
    :func:`stem_conv_dx` (skipped when x needs no gradient) and
    :func:`stem_conv_dk`, for bf16 operands on their f32 widening."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, padding=weight.shape[2] // 2)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_k = ctx.needs_input_grad
        dtype = x.dtype
        if dtype == torch.bfloat16:
            x, weight, dy = x.float(), weight.float(), dy.float()
        dx = stem_conv_dx(weight, dy).to(dtype) if need_x else None
        dk = stem_conv_dk(x, dy, weight.shape[2]).to(dtype) if need_k else None
        return dx, dk


def stem_conv_diff(x, weight):
    """``F.conv3d(x, weight, padding=k // 2)`` for x (B, 1, D, H, W) and
    weight (C_out, 1, k, k, k), k odd, with the matrix-product backward;
    both float32, or both bfloat16 (a bf16 result)."""
    _check(x, weight)
    return StemConvDiff.apply(x, weight)
