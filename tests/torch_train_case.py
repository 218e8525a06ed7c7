"""The tiny NlosPose train case of ``tests/test_torch_train_step.py`` and
``tests/test_torch_train_step_parts.py``.

Weights: the port's peaked random weights (``utils/peaked.py``), carried
to the JAX layout by the JAX package's ``convert_state_dict`` (the strict
oracle for names) and back by ``utils/jax_bridge``; batch:
``make_batch([0, 1])``.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from hiddenpose_tpu.config import Config
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def model_cfg(size):
    return Config().tiny(size).model


@functools.lru_cache(maxsize=None)
def jax_tree(size, seed=1):
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(model_cfg(size))
    sd = peaked_state_dict(template, seed)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


def tiny_batch(size):
    m = model_cfg(size)
    return make_batch([0, 1], m.time_size, m.image_size[0], m.grid_dim,
                      m.heatmap_size[0], m.bin_len)


def port_model(size, tree=None, train=True):
    model, lct = build_nlospose(model_cfg(size), device="cpu")
    model.load_state_dict(state_dict_from_jax(tree or jax_tree(size)))
    return model.train(train), lct
