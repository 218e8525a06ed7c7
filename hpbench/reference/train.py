"""The NlosPose train step in plain PyTorch: forward with BatchNorm on the
batch's statistics, the joint loss (soft-argmax joints, squared error
weighted by visibility, summed over the batch's size) plus the voxel loss
(binary cross-entropy from logits plus one Dice score over the batch) on
the refined volume, the backward, and Adam (b1 0.9, b2 0.999, eps 1e-8).

``rounding`` is applied as in ``model.py``; ``rounded`` gives a rounding
whose backward rounds the cotangent too, for the control.
"""

from __future__ import annotations

import torch

from hpbench.reference import model as ref


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _fp8(t):
    """float8 e4m3 with one scale a tensor, its largest value at 448."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"float32": None, "bfloat16": _bf16, "float8": _fp8}


def rounded(precision: str):
    """The rounding to ``precision`` ('float32', 'bfloat16' or 'float8')
    of forward values and their cotangents."""
    fn = ROUNDINGS[precision]
    if fn is None:
        return ref.identity
    return lambda x: _Round.apply(x, fn)


def joint_loss(heatmaps, joints, vis):
    pred = ref.soft_argmax(heatmaps)
    return (((pred - joints) ** 2) * vis).sum() / pred.shape[0]


def voxel_loss(refine, vol):
    b = refine.shape[0]
    x, t = refine.reshape(b, -1), vol.reshape(b, -1)
    bce = (x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()
    p = torch.sigmoid(x)
    dice = 1.0 - (2.0 * (p * t).sum() + 1e-9) / (p.sum() + t.sum())
    return bce + dice


def train_steps(m: ref.NlosPose, lct, batches, lr: float, q=ref.identity):
    """One Adam step on each of ``batches`` in turn, from ``m``'s
    parameters (updated in place).  Returns the loss and the voxel loss of
    each step, the first step's gradient of each parameter and BatchNorm
    running statistics after it, each parameter's change over all the
    steps, by name, and the first step's refined volume."""
    params = dict(m.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    sq = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, voxels, first = [], [], None
    for step, batch in enumerate(batches, 1):
        heatmaps, refine = ref.forward(m, batch["meas"], lct, q,
                                       training=True)
        voxel = voxel_loss(refine, batch["vol"])
        loss = joint_loss(heatmaps, batch["joints"], batch["joints_vis"]) \
            + voxel
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(loss.item())
        voxels.append(voxel.item())
        if first is None:
            first = {k: g.clone() for k, g in zip(params, grads)}
            stats = running_stats(m)
            refine1 = refine.detach().clone()
        del heatmaps, refine, loss, voxel
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                mom[k].mul_(0.9).add_(g, alpha=0.1)
                sq[k].mul_(0.999).addcmul_(g, g, value=0.001)
                mhat = mom[k] / (1 - 0.9 ** step)
                vhat = sq[k] / (1 - 0.999 ** step)
                p.sub_(lr * mhat / (vhat.sqrt() + 1e-8))
        del grads
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return losses, voxels, first, stats, change, refine1


def running_stats(m) -> dict:
    """Copies of the BatchNorm running statistics of ``m``, by name."""
    return {k: b.detach().clone() for k, b in m.named_buffers()
            if k.endswith(("running_mean", "running_var"))}
