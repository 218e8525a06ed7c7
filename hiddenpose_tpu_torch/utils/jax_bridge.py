"""Weight bridge between the JAX package's variable trees and the port.

``hiddenpose_tpu/utils/torch_import.py`` maps a reference-named PyTorch
``state_dict`` to the JAX NlosPose's ``{"params", "batch_stats"}`` trees.
This module is the port's own copy of that map, in both directions:

* :func:`state_dict_from_jax` turns the JAX variables (nested dicts of
  numpy arrays) into the ``state_dict`` that ``NlosPose.load_state_dict``
  takes, so both packages run identical weights;
* :func:`from_jax` / :func:`to_jax` carry any tree shaped like one
  collection (``"params"`` or ``"batch_stats"``) to a dict keyed by the
  port's names and back: parameters, but also gradients and Adam's ``mu``
  and ``nu``, so one train step's results compare name by name.

Conversions (each linear and a pure relayout, so they carry gradients and
both Adam moments as they carry weights):

* flax conv kernels are DHWIO; torch ``Conv3d.weight`` is OIDHW;
* flax ``ConvTranspose`` correlates a kernel (D, H, W, I, O) with the
  dilated input; torch's transposed conv convolves a (I, O, D, H, W)
  weight, so the bridge transposes back and flips the three spatial axes;
* the PoseNet stem (``StemS2D``) keeps its BatchNorm inside the conv
  scope (``bn_scale``/``bn_bias``, ``bn_mean``/``bn_var``), which maps to
  ``pose_net.conv1`` and ``pose_net.bn1``;
* every BatchNorm gets ``num_batches_tracked = 0`` in a state_dict, which
  the importer ignores.

The ``posenet2d`` NlosPose (``cfg.backbone == "posenet2d"``) has a table
of its own for ``pose_net``, which the JAX package's importer does not
cover: the port's names are the flax tree's (``pose_net.backbone.
layer1_0.conv1``), a flax 2D kernel (H, W, I, O) is torch's (O, I, H, W),
and a 2D ``ConvTranspose`` flips as the 3D head's does.  Which table a
tree takes is read from the tree (a ``pose_net`` with a ``backbone``) or
from the names (``pose_net.backbone.*``).

:func:`adam_state_from_jax` carries optax's Adam state (``mu``, ``nu``,
the count) into a port ``TrainState``'s ``torch.optim.Adam``, so both
packages' loops can start from one optimizer state; :func:`load_adam`
does it for a bare ``torch.optim.Adam`` from moments keyed by the port's
names (the SimDR and 2D-heatmap steps take an optimizer, not a state).

The transformer family (``NlosPoseSformer``, ``TimeSformer`` and
``TokenPose``) has no table: its port names are the flax paths joined by
dots, so the map is a walk of the tree (:func:`sformer_state_dict_from_jax`
and, back, :func:`sformer_params_to_jax`; like the two above they carry
gradients as they carry weights): flax ``Dense.kernel`` is
(in, out) and ``nn.Linear.weight`` (out, in); LayerNorm ``scale`` is
``weight``; the GEGLU's ``in`` / ``out`` are ``proj_in`` / ``proj_out``;
``joints_token``, ``cls_token`` and ``pos_emb`` go as they are.

Pure numpy in, torch tensors out (and back); no jax import.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_RESNET50_LAYERS = (3, 4, 6, 3)
_DECONV_LAYERS = 3
_BN_KEYS = ("scale", "bias", "mean", "var")

# (port name, collection, path inside the collection, kind); kind 'conv'
# is DHWIO <-> OIDHW, 'deconv' the transposed conv, 'conv2d' and
# 'deconv2d' their 2D forms, 'same' no relayout.
Entry = Tuple[str, str, Tuple[str, ...], str]


def _conv(out: List[Entry], name, path, bias=True, kind="conv"):
    out.append((f"{name}.weight", "params", (*path, "kernel"), kind))
    if bias:
        out.append((f"{name}.bias", "params", (*path, "bias"), "same"))


def _bn(out: List[Entry], name, path, stats_path, keys):
    """keys: (scale, bias, mean, var) leaf names."""
    for suffix, coll, p, key in (
            ("weight", "params", path, keys[0]),
            ("bias", "params", path, keys[1]),
            ("running_mean", "batch_stats", stats_path, keys[2]),
            ("running_var", "batch_stats", stats_path, keys[3])):
        out.append((f"{name}.{suffix}", coll, (*p, key), "same"))


def _double_conv(out, name, path):
    _conv(out, f"{name}.0", (*path, "conv1"))
    _conv(out, f"{name}.3", (*path, "conv2"))
    for i, gn in ((1, "gn1"), (4, "gn2")):
        out.append((f"{name}.{i}.weight", "params", (*path, gn, "scale"),
                    "same"))
        out.append((f"{name}.{i}.bias", "params", (*path, gn, "bias"),
                    "same"))


def posenet2d_layout(name="", path=(), layers=_RESNET50_LAYERS,
                     block="bottleneck") -> List[Entry]:
    """Every tensor of the port's ``ResPoseNet2D`` under the port name
    ``name`` and the JAX path ``path`` (the whole network when empty)."""
    out: List[Entry] = []
    pre = f"{name}." if name else ""

    def conv_bn(cname, cpath, bname, bpath):
        _conv(out, pre + cname, (*path, *cpath), bias=False, kind="conv2d")
        _bn(out, pre + bname, (*path, *bpath), (*path, *bpath), _BN_KEYS)

    conv_bn("backbone.conv1", ("backbone", "conv1"),
            "backbone.bn1", ("backbone", "bn1"))
    expansion = 4 if block == "bottleneck" else 1
    convs = (1, 2, 3) if block == "bottleneck" else (1, 2)
    in_planes = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
        for b in range(blocks):
            blk = f"layer{stage + 1}_{b}"
            for i in convs:
                conv_bn(f"backbone.{blk}.conv{i}", ("backbone", blk,
                                                    f"conv{i}"),
                        f"backbone.{blk}.bn{i}", ("backbone", blk, f"bn{i}"))
            if b == 0 and (stage > 0 or in_planes != planes * expansion):
                conv_bn(f"backbone.{blk}.conv_proj",
                        ("backbone", blk, "conv_proj"),
                        f"backbone.{blk}.bn_proj", ("backbone", blk,
                                                    "bn_proj"))
            in_planes = planes * expansion
    for i in range(1, _DECONV_LAYERS + 1):
        out.append((f"{pre}head.deconv{i}.weight", "params",
                    (*path, "head", f"deconv{i}", "kernel"), "deconv2d"))
        _bn(out, f"{pre}head.bn{i}", (*path, "head", f"bn{i}"),
            (*path, "head", f"bn{i}"), _BN_KEYS)
    _conv(out, f"{pre}head.final", (*path, "head", "final"), kind="conv2d")
    return out


def _layout(backbone: str = "posenet3d_50") -> List[Entry]:
    """Every tensor of the port's NlosPose (basedim 1) and where it lives
    in the JAX variables."""
    out: List[Entry] = []
    fe, fep = "feature_extraction", ("feature_extraction",)
    _conv(out, f"{fe}.conv1.1", (*fep, "conv_in"))
    for i, res in ((2, "res1"), (3, "res2")):
        _conv(out, f"{fe}.conv1.{i}.tmp.1", (*fep, res, "conv1"))
        _conv(out, f"{fe}.conv1.{i}.tmp.4", (*fep, res, "conv2"))
    out.append((f"{fe}.weights", "params", (*fep, "corner_kernel"), "conv"))

    ae, aep = "autoencoder", ("autoencoder",)
    _double_conv(out, f"{ae}.conv.double_conv", (*aep, "conv"))
    for i in range(1, 5):
        _double_conv(out, f"{ae}.enc{i}.encoder.1.double_conv",
                     (*aep, f"enc{i}"))
        _double_conv(out, f"{ae}.dec{i}.conv.double_conv", (*aep, f"dec{i}"))
    _conv(out, f"{ae}.out.conv", (*aep, "out"))

    pn, pnp = "pose_net", ("pose_net",)
    if backbone == "posenet2d":
        return out + posenet2d_layout(pn, pnp)
    _conv(out, f"{pn}.conv1", (*pnp, "conv1"), bias=False)
    _bn(out, f"{pn}.bn1", (*pnp, "conv1"), (*pnp, "conv1"),
        ("bn_scale", "bn_bias", "bn_mean", "bn_var"))
    for stage, blocks in enumerate(_RESNET50_LAYERS, start=1):
        for b in range(blocks):
            name, path = f"{pn}.layer{stage}.{b}", (*pnp, f"layer{stage}_{b}")
            for i in (1, 2, 3):
                _conv(out, f"{name}.conv{i}", (*path, f"conv{i}"), bias=False)
                _bn(out, f"{name}.bn{i}", (*path, f"bn{i}"),
                    (*path, f"bn{i}"), _BN_KEYS)
            if b == 0:  # every stage's first block projects (ResNet-50)
                _conv(out, f"{name}.downsample.0", (*path, "conv_proj"),
                      bias=False)
                _bn(out, f"{name}.downsample.1", (*path, "bn_proj"),
                    (*path, "bn_proj"), _BN_KEYS)
    hp = (*pnp, "head")
    for i in range(_DECONV_LAYERS):
        out.append((f"{pn}.head.features.{3 * i}.weight", "params",
                    (*hp, f"deconv{i + 1}", "kernel"), "deconv"))
        _bn(out, f"{pn}.head.features.{3 * i + 1}", (*hp, f"bn{i + 1}"),
            (*hp, f"bn{i + 1}"), _BN_KEYS)
    _conv(out, f"{pn}.head.features.{3 * _DECONV_LAYERS}", (*hp, "final"))
    return out


def _to_port(a, kind) -> torch.Tensor:
    a = np.asarray(a)
    if kind == "conv":      # DHWIO -> OIDHW
        a = np.transpose(a, (4, 3, 0, 1, 2))
    elif kind == "deconv":  # correlating (D, H, W, I, O) -> (I, O, D, H, W)
        a = np.transpose(a, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
    elif kind == "conv2d":  # HWIO -> OIHW
        a = np.transpose(a, (3, 2, 0, 1))
    elif kind == "deconv2d":  # correlating (H, W, I, O) -> (I, O, H, W)
        a = np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return torch.from_numpy(np.array(a, dtype=np.float32))  # writable copy


def _to_jax(t, kind) -> np.ndarray:
    a = t.detach().cpu().float().numpy()
    if kind == "conv":
        a = np.transpose(a, (2, 3, 4, 1, 0))
    elif kind == "deconv":
        a = np.transpose(a[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1))
    elif kind == "conv2d":
        a = np.transpose(a, (2, 3, 1, 0))
    elif kind == "deconv2d":
        a = np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1))
    # a copy: .numpy() of a CPU tensor shares its memory, and a parameter
    # updated in place would change the tree
    return np.array(a, order="C")


def sformer_state_dict_from_jax(params: Mapping,
                                prefix=()) -> Dict[str, torch.Tensor]:
    """The ``"params"`` tree of the JAX ``NlosPoseSformer`` or
    ``TimeSformer`` (numpy leaves) -> the port model's state_dict."""
    out = {}
    for key, leaf in params.items():
        if isinstance(leaf, Mapping):
            mod = f"proj_{key}" if key in ("in", "out") else key
            out.update(sformer_state_dict_from_jax(leaf, (*prefix, mod)))
            continue
        a = np.array(leaf, dtype=np.float32)  # writable copy
        if key == "kernel":
            key, a = "weight", np.ascontiguousarray(a.T)
        elif key == "scale":
            key = "weight"
        out[".".join((*prefix, key))] = torch.from_numpy(a)
    return out


def sformer_params_to_jax(named: Mapping[str, torch.Tensor]) -> Dict:
    """{port name: tensor} of an ``NlosPoseSformer`` or ``TimeSformer``
    (a state_dict, ``named_parameters()``) -> the JAX ``"params"`` tree."""
    tree: Dict = {}
    for name, t in named.items():
        *mods, key = name.split(".")
        a = t.detach().cpu().float().numpy()
        if key == "weight":
            key, a = ("kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for mod in mods:
            mod = mod[len("proj_"):] if mod in ("proj_in", "proj_out") else mod
            node = node.setdefault(mod, {})
        node[key] = np.ascontiguousarray(a)
    return tree


def _backbone(tree_or_names) -> str:
    """The NlosPose backbone whose table fits a JAX tree (a ``pose_net``
    with a ``backbone`` scope) or a set of port names."""
    if isinstance(tree_or_names, Mapping) and isinstance(
            tree_or_names.get("pose_net"), Mapping):
        two_d = "backbone" in tree_or_names["pose_net"]
    else:
        two_d = any(n.startswith("pose_net.backbone.")
                    for n in tree_or_names)
    return "posenet2d" if two_d else "posenet3d_50"


def _from_layout(tree: Mapping, layout: List[Entry],
                 collection: str) -> Dict[str, torch.Tensor]:
    out = {}
    for name, coll, path, kind in layout:
        if coll == collection:
            leaf = tree
            for key in path:
                leaf = leaf[key]
            out[name] = _to_port(leaf, kind)
    return out


def _to_layout(named: Mapping[str, torch.Tensor], layout: List[Entry],
               collection: str) -> Dict:
    tree: Dict = {}
    for name, coll, path, kind in layout:
        if coll != collection:
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax(named[name], kind)
    return tree


def _state_dict(variables: Mapping,
                layout: List[Entry]) -> Dict[str, torch.Tensor]:
    sd = {**_from_layout(variables["params"], layout, "params"),
          **_from_layout(variables["batch_stats"], layout, "batch_stats")}
    for name in [n for n in sd if n.endswith(".running_var")]:
        sd[name[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd


def from_jax(tree: Mapping,
             collection: str = "params") -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX NlosPose's ``collection`` (params, their
    gradients or Adam moments; or batch_stats) -> {port name: tensor}."""
    return _from_layout(tree, _layout(_backbone(tree)), collection)


def to_jax(named: Mapping[str, torch.Tensor],
           collection: str = "params") -> Dict:
    """{port name: tensor} (e.g. ``named_parameters()``, their ``.grad``
    or Adam's ``exp_avg``) -> the nested dict of numpy arrays shaped like
    the JAX NlosPose's ``collection``.  Every name of the collection must
    be there."""
    return _to_layout(named, _layout(_backbone(named)), collection)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX NlosPose (numpy
    leaves) -> the port's ``NlosPose`` state_dict."""
    return _state_dict(variables,
                       _layout(_backbone(variables["params"])))


def posenet2d_state_dict_from_jax(variables: Mapping,
                                  layers=_RESNET50_LAYERS,
                                  block="bottleneck"
                                  ) -> Dict[str, torch.Tensor]:
    """The variables of a JAX ``ResPoseNet2D`` alone -> the port's
    ``ResPoseNet2D`` state_dict."""
    return _state_dict(variables, posenet2d_layout(layers=layers,
                                                   block=block))


def posenet2d_to_jax(named: Mapping[str, torch.Tensor],
                     collection: str = "params", layers=_RESNET50_LAYERS,
                     block="bottleneck") -> Dict:
    """{port name: tensor} of a ``ResPoseNet2D`` alone -> the JAX tree of
    ``collection``."""
    return _to_layout(named, posenet2d_layout(layers=layers, block=block),
                      collection)


def load_adam(optimizer: torch.optim.Adam,
              named_params: Mapping[str, torch.nn.Parameter],
              mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
              count: int) -> None:
    """optax's ``scale_by_adam`` state, its moments keyed by the port's
    names, into ``optimizer`` (a bare ``torch.optim.Adam``), in place.

    Each parameter the optimizer holds gets ``exp_avg`` = mu, ``exp_avg_sq``
    = nu and ``step`` = count (torch's Adam bias-corrects with its step
    after the increment, optax with count + 1: the same number)."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"expected torch.optim.Adam, got "
                        f"{type(optimizer).__name__}")
    held = {p for g in optimizer.param_groups for p in g["params"]}
    for name, p in named_params.items():
        if p not in held:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            # in the parameter's memory format and device, as Adam makes
            # its own
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name]),
        }


def adam_state_from_jax(state, mu: Mapping, nu: Mapping, count: int) -> None:
    """Carry optax's ``scale_by_adam`` state into ``state`` (a port
    ``TrainState`` whose optimizer is ``torch.optim.Adam``), in place.

    ``mu`` and ``nu`` are trees shaped like the JAX NlosPose's params
    (numpy leaves), ``count`` optax's update count: :func:`load_adam` on
    the model's parameters, and ``state.step`` = count, which the schedule
    reads as optax's ``scale_by_schedule`` reads its count."""
    load_adam(state.optimizer, dict(state.model.named_parameters()),
              from_jax(mu), from_jax(nu), count)
    state.step = int(count)
