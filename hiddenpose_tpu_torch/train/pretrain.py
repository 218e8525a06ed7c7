"""A pretrained, frozen autoencoder.

Port of ``hiddenpose_tpu/train/pretrain.py``.  The reference substitutes a
whole pretrained UNet3d for the fresh one when
``cfg.MODEL.PRETRAIN_AUTOENCODER`` is set, and freezes it
(``requires_grad=False`` on every parameter).  In this port:

* :func:`save_autoencoder` writes the ``autoencoder`` part of a state_dict
  (or module) as its own file, atomically;
* :func:`load_pretrained_autoencoder` loads it into the model's UNet3d
  (strictly: every name and shape must match);
* :func:`freeze_autoencoder` turns its parameters' ``requires_grad`` off
  and returns the other parameters, which are all the optimizer gets
  (``TrainState.create(..., params=...)``): the frozen ones never move and
  carry no Adam moments, and gradients still flow through the UNet to the
  FeatureExtraction before it, as in the reference (and as the JAX
  package's ``optax.multi_transform`` with a zero branch does).
"""

from __future__ import annotations

import os
from typing import List, Mapping, Union

import torch
from torch import nn

AUTOENCODER_SCOPE = "autoencoder"
_PREFIX = AUTOENCODER_SCOPE + "."


def _autoencoder_part(params: Mapping[str, torch.Tensor]) -> dict:
    """The autoencoder's tensors of a whole model's state_dict (prefix
    dropped), or ``params`` itself if it is the autoencoder's already."""
    if any(k.startswith(_PREFIX) for k in params):
        return {k[len(_PREFIX):]: v for k, v in params.items()
                if k.startswith(_PREFIX)}
    return dict(params)


def save_autoencoder(path: str,
                     params: Union[nn.Module, Mapping[str, torch.Tensor]]
                     ) -> str:
    """Write the autoencoder's weights (of an NlosPose, a UNet3d or either's
    state_dict) to ``path``; returns the absolute path."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    part = {k: v.detach().cpu() for k, v in _autoencoder_part(params).items()}
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp")
    torch.save(part, tmp)
    os.replace(tmp, path)
    return path


def load_pretrained_autoencoder(path: str, model: nn.Module) -> nn.Module:
    """Replace the weights of ``model.autoencoder`` with those at ``path``
    (names and shapes checked); returns ``model``."""
    ae = getattr(model, AUTOENCODER_SCOPE)
    device = next(ae.parameters()).device
    ae.load_state_dict(torch.load(path, map_location=device,
                                  weights_only=True))
    return model


def freeze_autoencoder(model: nn.Module) -> List[nn.Parameter]:
    """Freeze ``model.autoencoder``; returns the parameters the optimizer
    is to update (every parameter outside the autoencoder)."""
    trainable = []
    for name, p in model.named_parameters():
        if name.startswith(_PREFIX):
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return trainable
