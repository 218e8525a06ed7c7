"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

The inverse of ``hiddenpose_tpu/utils/torch_import.py``: it takes the
``{"params", "batch_stats"}`` trees of ``hiddenpose_tpu``'s NlosPose (as
nested dicts of numpy arrays) and returns the reference-named PyTorch
``state_dict`` that ``NlosPose.load_state_dict`` takes, so both packages
can run identical weights.  Conversions:

* flax conv kernels are DHWIO; torch ``Conv3d.weight`` is OIDHW;
* flax ``ConvTranspose`` correlates a kernel (D, H, W, I, O) with the
  dilated input; torch's transposed conv convolves a (I, O, D, H, W)
  weight, so the bridge transposes back and flips the three spatial axes;
* the PoseNet stem (``StemS2D``) keeps its BatchNorm inside the conv
  scope (``bn_scale``/``bn_bias``, ``bn_mean``/``bn_var``); the bridge
  unfolds it into ``pose_net.conv1`` and ``pose_net.bn1``;
* every BatchNorm gets ``num_batches_tracked = 0``, which the importer
  ignores.

Pure numpy in, torch tensors out; no jax import.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RESNET50_LAYERS = (3, 4, 6, 3)
_DECONV_LAYERS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _conv_w(k) -> torch.Tensor:
    """DHWIO -> OIDHW."""
    return _t(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _deconv_w(k) -> torch.Tensor:
    """Correlating (D, H, W, I, O) -> convolving (I, O, D, H, W)."""
    w = np.transpose(np.asarray(k), (3, 4, 0, 1, 2))
    return _t(w[:, :, ::-1, ::-1, ::-1])


def _conv(sd, prefix, p, bias=True):
    sd[f"{prefix}.weight"] = _conv_w(p["kernel"])
    if bias:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd, prefix, scale, bias, mean, var):
    sd[f"{prefix}.weight"] = _t(scale)
    sd[f"{prefix}.bias"] = _t(bias)
    sd[f"{prefix}.running_mean"] = _t(mean)
    sd[f"{prefix}.running_var"] = _t(var)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _feature_extraction(sd, p):
    pre = "feature_extraction"
    _conv(sd, f"{pre}.conv1.1", p["conv_in"])
    for i, res in ((2, "res1"), (3, "res2")):
        _conv(sd, f"{pre}.conv1.{i}.tmp.1", p[res]["conv1"])
        _conv(sd, f"{pre}.conv1.{i}.tmp.4", p[res]["conv2"])
    sd[f"{pre}.weights"] = _conv_w(p["corner_kernel"])


def _double_conv(sd, prefix, p):
    _conv(sd, f"{prefix}.0", p["conv1"])
    sd[f"{prefix}.1.weight"] = _t(p["gn1"]["scale"])
    sd[f"{prefix}.1.bias"] = _t(p["gn1"]["bias"])
    _conv(sd, f"{prefix}.3", p["conv2"])
    sd[f"{prefix}.4.weight"] = _t(p["gn2"]["scale"])
    sd[f"{prefix}.4.bias"] = _t(p["gn2"]["bias"])


def _unet(sd, p):
    pre = "autoencoder"
    _double_conv(sd, f"{pre}.conv.double_conv", p["conv"])
    for i in range(1, 5):
        _double_conv(sd, f"{pre}.enc{i}.encoder.1.double_conv", p[f"enc{i}"])
        _double_conv(sd, f"{pre}.dec{i}.conv.double_conv", p[f"dec{i}"])
    _conv(sd, f"{pre}.out.conv", p["out"])


def _posenet(sd, p, s):
    pre = "pose_net"
    stem_p, stem_s = p["conv1"], s["conv1"]
    sd[f"{pre}.conv1.weight"] = _conv_w(stem_p["kernel"])
    _bn(sd, f"{pre}.bn1", stem_p["bn_scale"], stem_p["bn_bias"],
        stem_s["bn_mean"], stem_s["bn_var"])
    for stage, blocks in enumerate(_RESNET50_LAYERS, start=1):
        for b in range(blocks):
            bp, bs = p[f"layer{stage}_{b}"], s[f"layer{stage}_{b}"]
            tp = f"{pre}.layer{stage}.{b}"
            for i in (1, 2, 3):
                _conv(sd, f"{tp}.conv{i}", bp[f"conv{i}"], bias=False)
                _bn(sd, f"{tp}.bn{i}", bp[f"bn{i}"]["scale"],
                    bp[f"bn{i}"]["bias"], bs[f"bn{i}"]["mean"],
                    bs[f"bn{i}"]["var"])
            if "conv_proj" in bp:
                _conv(sd, f"{tp}.downsample.0", bp["conv_proj"], bias=False)
                _bn(sd, f"{tp}.downsample.1", bp["bn_proj"]["scale"],
                    bp["bn_proj"]["bias"], bs["bn_proj"]["mean"],
                    bs["bn_proj"]["var"])
    hp, hs = p["head"], s["head"]
    for i in range(_DECONV_LAYERS):
        sd[f"{pre}.head.features.{3 * i}.weight"] = _deconv_w(
            hp[f"deconv{i + 1}"]["kernel"])
        _bn(sd, f"{pre}.head.features.{3 * i + 1}", hp[f"bn{i + 1}"]["scale"],
            hp[f"bn{i + 1}"]["bias"], hs[f"bn{i + 1}"]["mean"],
            hs[f"bn{i + 1}"]["var"])
    _conv(sd, f"{pre}.head.features.{3 * _DECONV_LAYERS}", hp["final"])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX NlosPose (numpy
    leaves) -> the port's ``NlosPose`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _feature_extraction(sd, params["feature_extraction"])
    _unet(sd, params["autoencoder"])
    _posenet(sd, params["pose_net"], stats["pose_net"])
    return sd
