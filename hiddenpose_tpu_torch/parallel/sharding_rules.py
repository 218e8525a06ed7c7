"""Parameter sharding rules: optional tensor parallelism over 'model'.

Port of ``hiddenpose_tpu/parallel/sharding_rules.py``.  The JAX rule
shards a kernel whose last axis (flax's output channels) is at least
``min_channels`` wide and divides by the 'model' size, and replicates
everything else; ``jit`` then gathers it where it is used.  In PyTorch
the output-channel axis is dim 0 of a ``Conv*d`` or ``Linear`` weight and
dim 1 of a ``ConvTranspose*d`` weight (PoseNet3D's and the 2D net's
deconv heads), which :func:`out_channel_dim` says; the set of sharded
tensors is then the JAX set (``tests/test_torch_parallel.py`` holds it
leaf by leaf through ``utils/jax_bridge.py``).

:func:`apply_tp` keeps such a weight as this rank's slice over 'model'
(a ``torch.nn.utils.parametrize`` parametrization whose ``original`` is
the slice), and its two Adam moments with it, since the optimizer holds
the slice.  Where the module reads the weight, the slices are gathered
whole (:class:`GatherReplicated`); every 'model' rank then computes the
same thing on the same data, so the gradient of the whole weight is the
same on each, and each keeps its slice of it.  The 'data' average of the
train step then treats the slice as any other parameter.

:func:`full_state_dict` and :func:`full_optimizer_state_dict` read a
sharded model's state whole, under the plain names, as the model and its
optimizer on one GPU hold it.  As in the JAX package, tensor parallelism
is not an option of the train loop; ``graft_entry.py::dryrun_multichip``
drives the DP x TP step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from hiddenpose_tpu_torch.parallel.mesh import Mesh

_CONV_T = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def out_channel_dim(module: nn.Module, name: str,
                    p: torch.Tensor) -> Optional[int]:
    """The output-channel axis of ``module``'s parameter ``name`` (flax's
    last kernel axis), or None for a vector (biases, norms)."""
    if p.dim() < 2:
        return None
    return 1 if isinstance(module, _CONV_T) and name == "weight" else 0


def params_tp_sharding(model: nn.Module, mesh: Mesh,
                       min_channels: int = 256) -> Dict[str, Optional[int]]:
    """{parameter name: the dim sharded over 'model', or None}: the
    output-channel axis of a weight at least ``min_channels`` wide that
    divides by the 'model' size; None (replicated) for the rest."""
    model_size = mesh.shape["model"]
    out = {}
    for mod_name, m in model.named_modules():
        for name, p in m.named_parameters(recurse=False):
            dim = out_channel_dim(m, name, p)
            full = f"{mod_name}.{name}" if mod_name else name
            out[full] = (dim if model_size > 1 and dim is not None
                         and p.shape[dim] >= min_channels
                         and p.shape[dim] % model_size == 0 else None)
    return out


def _gather(x, dim, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class GatherReplicated(torch.autograd.Function):
    """The whole tensor from every rank's slice along ``dim`` of a group;
    its gradient is this rank's slice of the whole tensor's gradient (each
    rank of the group computes the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.n, ctx.index = dim, dist.get_world_size(group), index
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None,
                None, None)


class SliceReplicated(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor every rank of the group
    holds whole; its gradient is the whole gradient, gathered from every
    rank's slice (the inverse pair of :class:`GatherReplicated`)."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group = dim, group
        return x.chunk(n, dim=dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None, None


class ModelSlice(nn.Module):
    """The parametrization of a weight sharded over 'model': ``original``
    is this rank's slice; the module reads the gathered whole."""

    def __init__(self, dim: int, mesh: Mesh):
        super().__init__()
        self.dim, self.mesh = dim, mesh

    def forward(self, x):
        return GatherReplicated.apply(x, self.dim, self.mesh.group("model"),
                                      self.mesh.index("model"))

    def right_inverse(self, full):
        n = self.mesh.shape["model"]
        return full.chunk(n, dim=self.dim)[self.mesh.index("model")].clone()


def apply_tp(model: nn.Module, mesh: Mesh, optimizer=None,
             min_channels: int = 256) -> nn.Module:
    """Shard ``model``'s wide weights over 'model' by
    :func:`params_tp_sharding`, in place; with ``optimizer``, its
    parameter references and Adam moments follow (sliced).  Call it on a
    replicated model (``parallel/mesh.py::replicate`` first): each rank
    keeps its own slice.  Returns the model."""
    rules = params_tp_sharding(model, mesh, min_channels)
    model._tp_plain_names = list(rules)
    moved = {}
    for full, dim in rules.items():
        if dim is None:
            continue
        mod_name, _, name = full.rpartition(".")
        m = model.get_submodule(mod_name)
        old = getattr(m, name)
        parametrize.register_parametrization(m, name, ModelSlice(dim, mesh),
                                             unsafe=True)
        moved[old] = (m.parametrizations[name].original, dim)
    if optimizer is not None:
        slicer = ModelSlice(0, mesh)
        for group in optimizer.param_groups:
            group["params"] = [moved.get(p, (p,))[0]
                               for p in group["params"]]
        for old, (new, dim) in moved.items():
            if old in optimizer.state:
                slicer.dim = dim
                optimizer.state[new] = {
                    k: (slicer.right_inverse(v) if torch.is_tensor(v)
                        and v.shape == old.shape else v)
                    for k, v in optimizer.state.pop(old).items()}
    return model


def _sharded(model: nn.Module):
    """(plain name, module, tensor name, parametrization) of every sharded
    tensor of ``model``."""
    for mod_name, m in model.named_modules():
        if parametrize.is_parametrized(m):
            for name, plist in m.parametrizations.items():
                yield (f"{mod_name}.{name}" if mod_name else name, m, name,
                       plist[0])


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded weight gathered whole
    under its plain name (a collective over 'model': every rank calls
    it).  The model's own state_dict without sharding."""
    sd = model.state_dict()
    with torch.no_grad():
        for plain, m, name, _ in _sharded(model):
            prefix = plain[:-len(name)]
            for k in [k for k in sd
                      if k.startswith(f"{prefix}parametrizations.{name}.")]:
                del sd[k]
            sd[plain] = getattr(m, name).detach().clone()
    return sd


def full_optimizer_state_dict(model: nn.Module, optimizer) -> Dict:
    """``optimizer.state_dict()`` as the same optimizer over the plain
    model would have it: the moments of sharded weights gathered whole,
    and the parameters indexed in the plain model's order (a collective
    over 'model')."""
    sd = optimizer.state_dict()
    sharded = list(_sharded(model))
    if not sharded:
        return sd
    plain_of = {id(p): n for n, p in model.named_parameters()}
    dim_of = {}
    for plain, m, name, slicer in sharded:
        orig = m.parametrizations[name].original
        plain_of[id(orig)] = plain
        dim_of[id(orig)] = slicer.dim
    mesh = sharded[0][3].mesh
    group, index = mesh.group("model"), mesh.index("model")
    order = {n: i for i, n in enumerate(model._tp_plain_names)}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    ranked = sorted(range(len(params)),
                    key=lambda i: order[plain_of[id(params[i])]])
    new_index = {old: new for new, old in enumerate(ranked)}
    state = {}
    for old, st in sd["state"].items():
        p = params[old]
        dim = dim_of.get(id(p))
        if dim is not None:
            st = {k: (GatherReplicated.apply(v, dim, group, index)
                      if torch.is_tensor(v) and v.shape == p.shape else v)
                  for k, v in st.items()}
        state[new_index[old]] = st
    groups = [dict(g, params=sorted(new_index[i] for i in g["params"]))
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}
