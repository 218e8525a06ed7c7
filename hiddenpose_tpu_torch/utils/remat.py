"""Rematerialisation: recompute a piece of the forward in the backward.

The counterpart of flax's ``nn.remat`` and ``jax.checkpoint``, which the
JAX package puts around NlosPose's stages (``cfg.stage_remat``) and
PoseNet3D's blocks and stem (``cfg.posenet_remat``,
``cfg.posenet_remat_stem``): :func:`remat` runs ``fn`` under
``torch.utils.checkpoint`` (non-reentrant), which keeps only ``fn``'s
inputs and runs ``fn`` again when the backward first needs what it saved.

Two things the recompute must not change, as flax's functional remat
does not:

* the BatchNorm buffers.  A training BatchNorm updates its running
  statistics in its forward; the recompute sees the same inputs and
  computes the same batch statistics, and :func:`recomputing` tells the
  norm to leave its buffers alone then (``models/posenet3d.py``'s and
  ``models/posenet2d.py``'s ``FlaxBatchNorm``), so they are updated once;
* the routes.  The recompute runs inside the backward, which may run on
  another thread than the forward: it re-enters the forward's ambient
  matmul precision (``ops/kernels/conv3mxu.py``), so the conv2 routes and
  their kernels are those of the forward.  The TF32 flags are
  process-wide and the train step holds them over its backward.

The kernels inside ``fn`` launch again in the recompute through their
``autograd.Function``s, and their launch counts grow by that much.
Outside grad mode :func:`remat` is a plain call.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

from hiddenpose_tpu_torch.ops.kernels import conv3mxu

_state = threading.local()


def recomputing() -> bool:
    """Whether the code running is a :func:`remat` recompute."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_scope():
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward where a
    gradient is wanted (see the module's docstring)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    precision = conv3mxu.current_precision()
    calls = []

    def run(*a):
        if not calls:  # the forward
            calls.append(1)
            return fn(*a)
        with _recompute_scope(), conv3mxu.matmul_precision(precision):
            return fn(*a)

    # no random op runs in these models: the RNG state need not be kept
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
