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

The transformer family (``NlosPoseSformer``, ``TimeSformer``) has no
table: its port names are the flax paths joined by dots, so the map is a
walk of the tree (:func:`sformer_state_dict_from_jax` and, back,
:func:`sformer_params_to_jax`; like the two above they carry gradients as
they carry weights): flax ``Dense.kernel`` is
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

# (port name, collection, path inside the collection, kind); kind 'conv'
# is DHWIO <-> OIDHW, 'deconv' the transposed conv, 'same' no relayout.
Entry = Tuple[str, str, Tuple[str, ...], str]


def _conv(out: List[Entry], name, path, bias=True):
    out.append((f"{name}.weight", "params", (*path, "kernel"), "conv"))
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


def _layout() -> List[Entry]:
    """Every tensor of the port's NlosPose (posenet3d_50, basedim 1) and
    where it lives in the JAX variables."""
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
    _conv(out, f"{pn}.conv1", (*pnp, "conv1"), bias=False)
    _bn(out, f"{pn}.bn1", (*pnp, "conv1"), (*pnp, "conv1"),
        ("bn_scale", "bn_bias", "bn_mean", "bn_var"))
    bn_keys = ("scale", "bias", "mean", "var")
    for stage, blocks in enumerate(_RESNET50_LAYERS, start=1):
        for b in range(blocks):
            name, path = f"{pn}.layer{stage}.{b}", (*pnp, f"layer{stage}_{b}")
            for i in (1, 2, 3):
                _conv(out, f"{name}.conv{i}", (*path, f"conv{i}"), bias=False)
                _bn(out, f"{name}.bn{i}", (*path, f"bn{i}"),
                    (*path, f"bn{i}"), bn_keys)
            if b == 0:  # every stage's first block projects (ResNet-50)
                _conv(out, f"{name}.downsample.0", (*path, "conv_proj"),
                      bias=False)
                _bn(out, f"{name}.downsample.1", (*path, "bn_proj"),
                    (*path, "bn_proj"), bn_keys)
    hp = (*pnp, "head")
    for i in range(_DECONV_LAYERS):
        out.append((f"{pn}.head.features.{3 * i}.weight", "params",
                    (*hp, f"deconv{i + 1}", "kernel"), "deconv"))
        _bn(out, f"{pn}.head.features.{3 * i + 1}", (*hp, f"bn{i + 1}"),
            (*hp, f"bn{i + 1}"), bn_keys)
    _conv(out, f"{pn}.head.features.{3 * _DECONV_LAYERS}", (*hp, "final"))
    return out


def _to_port(a, kind) -> torch.Tensor:
    a = np.asarray(a)
    if kind == "conv":      # DHWIO -> OIDHW
        a = np.transpose(a, (4, 3, 0, 1, 2))
    elif kind == "deconv":  # correlating (D, H, W, I, O) -> (I, O, D, H, W)
        a = np.transpose(a, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
    return torch.from_numpy(np.array(a, dtype=np.float32))  # writable copy


def _to_jax(t, kind) -> np.ndarray:
    a = t.detach().cpu().float().numpy()
    if kind == "conv":
        a = np.transpose(a, (2, 3, 4, 1, 0))
    elif kind == "deconv":
        a = np.transpose(a[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1))
    return np.ascontiguousarray(a)


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


def from_jax(tree: Mapping,
             collection: str = "params") -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX NlosPose's ``collection`` (params, their
    gradients or Adam moments; or batch_stats) -> {port name: tensor}."""
    out = {}
    for name, coll, path, kind in _layout():
        if coll == collection:
            leaf = tree
            for key in path:
                leaf = leaf[key]
            out[name] = _to_port(leaf, kind)
    return out


def to_jax(named: Mapping[str, torch.Tensor],
           collection: str = "params") -> Dict:
    """{port name: tensor} (e.g. ``named_parameters()``, their ``.grad``
    or Adam's ``exp_avg``) -> the nested dict of numpy arrays shaped like
    the JAX NlosPose's ``collection``.  Every name of the collection must
    be there."""
    tree: Dict = {}
    for name, coll, path, kind in _layout():
        if coll != collection:
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax(named[name], kind)
    return tree


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX NlosPose (numpy
    leaves) -> the port's ``NlosPose`` state_dict."""
    sd = {**from_jax(variables["params"], "params"),
          **from_jax(variables["batch_stats"], "batch_stats")}
    for name in [n for n in sd if n.endswith(".running_var")]:
        sd[name[:-len("running_var")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return sd
