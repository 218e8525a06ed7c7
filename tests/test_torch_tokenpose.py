"""TokenPose in the port against the JAX package, at a narrow width.

The same feature maps, made from a numpy seed, go through flax's
``TokenPose`` and the port's (``hiddenpose_tpu_torch/models/
tokenpose.py``), with the port's peaked weights (``utils/peaked.py``:
random LayerNorm affines and biases, peaked attention rows and
heatmaps) carried to flax by the bridge's walk of the tree
(``utils/jax_bridge.py``), whose tree must equal flax's own ``init`` tree
name by name and shape by shape.  Every ``pos_embedding_type`` and both
head branches (the hidden layer is taken only when ``dim * 3 <=
hidden_heatmap_dim * 0.5``).

Tolerances: the sine table bit for bit (the same numpy code); outputs
1e-5 of the largest heatmap value (float32 on both sides, summation order
through 3 x 2 layers), parameter gradients 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.models import tokenpose as jax_tokenpose
from hiddenpose_tpu_torch.models import tokenpose
from hiddenpose_tpu_torch.utils.jax_bridge import (
    sformer_params_to_jax,
    sformer_state_dict_from_jax,
)
from hiddenpose_tpu_torch.utils.peaked import peaked_transformer_state_dict

KW = dict(feature_size=(16, 16), patch_size=(4, 4), num_keypoints=5, dim=16,
          channels=8, depth=2, heads=2, mlp_ratio=3, heatmap_size=(8, 12))
# hidden_heatmap_dim: 96 takes the hidden layer (48 <= 48), 64 does not
HEADS = {"hidden": 96, "direct": 64}


def _feature(seed, b=2):
    return np.random.RandomState(seed).randn(b, 8, 16, 16).astype(np.float32)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), dict(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(pos, head, seed=1):
    kw = dict(KW, pos_embedding_type=pos, hidden_heatmap_dim=HEADS[head])
    port = tokenpose.TokenPose(**kw)
    sd = peaked_transformer_state_dict(port, seed)
    port.load_state_dict(sd)
    jmodel = jax_tokenpose.TokenPose(**kw)
    init = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(_feature(0))))["params"]
    params = sformer_params_to_jax(sd)
    assert _shapes(params) == _shapes(init)
    back = sformer_state_dict_from_jax(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[n], sd[n]) for n in sd)
    assert port.hidden == (head == "hidden")
    return port, jmodel, params


@pytest.mark.parametrize("h,w,d", [(4, 4, 16), (16, 16, 192), (3, 5, 8)])
def test_sine_position_embedding_matches_jax(h, w, d):
    got = tokenpose.sine_position_embedding(h, w, d)
    want = jax_tokenpose.sine_position_embedding(h, w, d)
    assert got.dtype == np.float32 and got.shape == (1, h * w, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("pos", tokenpose.POS_EMBEDDING_TYPES)
def test_tokenpose_matches_jax(pos, head):
    """Forward on two feature maps, then the gradients of a random
    cotangent with respect to every parameter."""
    port, jmodel, params = _pair(pos, head)
    x = _feature(2)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                            jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = port(xt)
    assert got.shape == want.shape == (2, 5, 8, 12)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    # peaked heatmaps: the argmax differs across keypoints
    assert len({int(a) for a in want[0].reshape(5, -1).argmax(1)}) >= 3

    r = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
    gj = _flat(jax.jit(jax.grad(lambda p: jnp.sum(
        jmodel.apply({"params": p}, jnp.asarray(x)) * r)))(params))
    (got * torch.from_numpy(r)).sum().backward()
    gp = _flat(sformer_params_to_jax({n: p.grad for n, p in
                                      port.named_parameters()}))
    assert gp.keys() == gj.keys()
    num = np.sqrt(sum(np.sum((gp[k] - gj[k]).astype(np.float64) ** 2)
                      for k in gj))
    den = np.sqrt(sum(np.sum(gj[k].astype(np.float64) ** 2) for k in gj))
    assert num / den < 1e-4


def test_tokenpose_rejects_an_unknown_position_type():
    with pytest.raises(ValueError, match="pos_embedding_type"):
        tokenpose.TokenPose(**KW, pos_embedding_type="rotary")


def test_build_tokenpose_published_config_shapes():
    """The JAX defaults (feature (B, 128, 64, 64), dim 192, 8 heads, 64 x
    64 heatmaps, sine-full): the published head takes no hidden layer,
    and the parameter count equals flax's."""
    model = tokenpose.build_tokenpose(device="cpu", seed=0)
    assert not model.hidden and not model.training
    n_port = sum(p.numel() for p in model.parameters())
    init = jax.eval_shape(lambda: jax_tokenpose.TokenPose().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 64, 64))))
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree_util.tree_leaves(init))
    assert n_port == n_jax
    with torch.no_grad():
        out = model(torch.zeros(1, 128, 64, 64))
    assert out.shape == (1, 24, 64, 64)
