"""The device mesh and its layout: data parallel over 'data', tensor
parallel over 'model'.

Port of ``hiddenpose_tpu/parallel/mesh.py``.  There a ``jax.sharding.Mesh``
of devices names the axes and ``jit`` inserts the collectives; here each
rank of a ``torch.distributed`` job is one device of a ('data', 'model')
mesh, laid out as the JAX mesh reshapes its devices: rank r sits at
(r // n_model, r % n_model).  :func:`make_mesh` makes one process group
per row and per column, and the code calls the collectives itself:

* the batch is split over 'data' (:func:`shard_batch`): every rank of one
  'model' group holds the same share;
* parameters, buffers and the LCT constants are replicated
  (:func:`replicate`: broadcast from rank 0), except where
  ``parallel/sharding_rules.py`` keeps a wide weight as this rank's slice
  over 'model';
* the train step (``train/step.py``) averages the gradients over 'data',
  and inside :func:`data_parallel` every training BatchNorm takes its
  moments over the whole batch (:class:`SyncBatchNorm`) and the Dice loss
  its sums (``losses.py``, :func:`all_reduce_sum`), their gradients
  reduced too, so the step is the single-process step on the global
  batch, as a JAX step ``jit`` over the sharded batch is.

The job itself is started by ``parallel/distributed.py::initialize``
(or by the caller's ``torch.distributed.init_process_group``): NCCL on
the GPUs, gloo on the CPU when asked for.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (n_data, n_model) mesh of the job's ranks,
    the process groups of its two axes through it, and its device."""

    n_data: int
    n_model: int
    rank: int
    groups: Tuple[Any, Any]  # ('data' group, 'model' group) of this rank
    device: torch.device

    axis_names = AXES

    @property
    def shape(self):
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return (self.rank // self.n_model if axis == "data"
                else self.rank % self.n_model)

    def group(self, axis: str):
        return self.groups[AXES.index(axis)]


@dataclass(frozen=True)
class Sharding:
    """A layout on a mesh, as a ``NamedSharding``'s PartitionSpec: the
    mesh axis each leading dimension is split over (None: whole).  Kept,
    with :func:`batch_sharding` and :func:`replicated`, for the JAX
    module's names only: no code of the port reads a ``Sharding``; the
    layouts it names are made by :func:`shard_batch` and
    :func:`replicate`."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over every rank of the job (the default
    process group, which must be initialised).  ``n_data`` defaults to
    the world size over ``n_model``; ``n_data * n_model`` must be the
    world size.  Every rank must call it, in the same order as any other
    group creation."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed to be "
                           "initialised (parallel/distributed.py::"
                           "initialize, or init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not cover the "
                         f"job's {world} ranks")
    grid = np.arange(world).reshape(n_data, n_model)
    groups = [None, None]
    # every rank creates every group, in one order
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if rank % n_model == m:
            groups[0] = g
    for d in range(n_data):
        g = dist.new_group([int(r) for r in grid[d]])
        if rank // n_model == d:
            groups[1] = g
    return Mesh(n_data, n_model, rank, tuple(groups), _rank_device())


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (batch) axis over 'data'; everything else whole."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    """Every axis whole."""
    return Sharding(mesh, ())


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def shard_batch(mesh: Mesh, batch):
    """This rank's share of a global host batch (a dict of arrays or
    tensors, batch axis first), split over 'data' in order, on the
    rank's device.  The batch must divide by the 'data' size."""
    out = {}
    for k, v in batch.items():
        t = _as_tensor(v)
        if t.shape[0] % mesh.n_data:
            raise ValueError(f"batch of {t.shape[0]} ({k}) does not split "
                             f"over {mesh.n_data} data ranks")
        share = t.shape[0] // mesh.n_data
        i = mesh.index("data")
        out[k] = t[i * share:(i + 1) * share].to(mesh.device)
    return out


def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank, in place: a ``torch.nn.Module``
    (parameters and buffers), a ``train/state.py::TrainState`` (its
    model: the optimizer's state is empty at the start, or restored from
    one checkpoint on every rank), a dataclass of tensors (the LCT
    constants), a dict of tensors or a tensor.  Returns the tree."""
    from hiddenpose_tpu_torch.train.state import TrainState

    if isinstance(tree, TrainState):
        replicate(mesh, tree.model)
        return tree
    if isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    elif is_dataclass(tree):
        tensors = [getattr(tree, f.name) for f in fields(tree)
                   if isinstance(getattr(tree, f.name), torch.Tensor)]
    else:
        raise TypeError(f"cannot replicate a {type(tree).__name__}")
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0)
    return tree


# The mesh of the data-parallel step running (process-wide, as the
# backward, and a recompute in it, may run on another thread).
_active = [None]


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """For the block, training BatchNorms and the Dice loss reduce over
    ``mesh``'s 'data' group (nothing changes with None)."""
    saved = _active[0]
    _active[0] = mesh
    try:
        yield
    finally:
        _active[0] = saved


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`data_parallel` block, or None."""
    return _active[0]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiably."""
    return _AllReduceSum.apply(x, group)


class SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the whole 'data' axis: ``x`` normalised with
    the mean and biased variance of every rank's share (equal shares), and
    those two statistics (for the running ones; no gradient).

    Forward: each rank's moments in one ``var_mean``, the global mean and
    variance from two all-reduces of per-channel vectors (the variance
    from the ranks' variances and their means' spread, exact for equal
    shares), then the library's normalisation with those statistics.
    Backward: the gradient of a BatchNorm over the global batch, whose two
    per-channel sums (of dy and of dy x-hat) are all-reduced; the weight's
    and bias's gradients are this rank's sums, as autograd gives each rank
    (the train step averages them over 'data')."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        dims = (0, *range(2, x.dim()))
        group, n = mesh.group("data"), mesh.n_data
        var_l, mean_l = torch.var_mean(x, dim=dims, unbiased=False)
        mean = mean_l.clone()
        dist.all_reduce(mean, group=group)
        mean /= n
        var = var_l + (mean_l - mean) ** 2
        dist.all_reduce(var, group=group)
        var /= n
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.group, ctx.count = group, n * (x.numel() // x.shape[1])
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = (0, *range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        sums = torch.stack([dy.sum(dim=dims), (dy * xhat).sum(dim=dims)])
        local = sums.clone()
        dist.all_reduce(sums, group=ctx.group)
        sums /= ctx.count
        dx = (dy - sums[0].view(shape) - xhat * sums[1].view(shape)) \
            * (weight * invstd).view(shape)
        return dx, local[1], local[0], None, None


def sync_batch_norm(x, weight, bias, eps: float, mesh: Mesh):
    """(y, mean, var) of :class:`SyncBatchNorm`."""
    return SyncBatchNorm.apply(x, weight, bias, eps, mesh)


def average_gradients(params, mesh: Mesh) -> None:
    """Each gradient of ``params`` averaged over 'data', in place: one
    all-reduce of them all, flattened."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group("data"))
    flat /= mesh.n_data
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def mean_over_data(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``values`` averaged over 'data' (the step's metrics)."""
    out = values.detach().clone()
    dist.all_reduce(out, group=mesh.group("data"))
    return out / mesh.n_data
