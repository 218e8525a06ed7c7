"""The Sformer serving slice on the CPU: the port against the JAX package.

The same inputs, made from a numpy seed, go through the flax module and its
counterpart in ``hiddenpose_tpu_torch``; weights are made by the port's
peaked recipe (``utils/peaked.py::peaked_transformer_state_dict``) and
carried to flax by the bridge (``utils/jax_bridge.py``), whose tree must
equal flax's own ``init`` tree name by name and shape by shape.  On the CPU
the port's attention wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode where a test sets ``HP_SFORMER_ATTN=fused``.

Tolerances: float32 outputs 1e-5 of the reference's largest value (the two
frameworks sum matrix products in different orders; 8 stacked residual
layers keep that at a few 1e-6); bfloat16 mode 3e-2 (bf16 rounds to 3
decimal digits at every Dense); tables and element-wise functions 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu import config as jax_config
from hiddenpose_tpu.models import rotary as jax_rotary
from hiddenpose_tpu.models import sformer as jax_sformer
from hiddenpose_tpu.models import timesformer as jax_timesformer
from hiddenpose_tpu.ops import softargmax as jax_softargmax
from hiddenpose_tpu_torch import config
from hiddenpose_tpu_torch.models import rotary, sformer, timesformer
from hiddenpose_tpu_torch.ops.softargmax import simdr_decode
from hiddenpose_tpu_torch.utils.jax_bridge import (
    sformer_params_to_jax,
    sformer_state_dict_from_jax,
)
from hiddenpose_tpu_torch.utils.peaked import peaked_transformer_state_dict

F32_TOL = 1e-5
BF16_TOL = 3e-2

SFORMER_KW = dict(dim=32, num_frames=2, num_joints=4, image_size=16,
                  patch_size=4, channels=1, depth=2, heads=2, dim_head=8,
                  out_dim=32)
TIMESFORMER_KW = dict(dim=32, num_frames=3, num_classes=72, image_size=16,
                      patch_size=4, channels=1, depth=2, heads=2, dim_head=8)


def _video(seed, b=2, f=2, c=1, size=16):
    return np.random.RandomState(seed).rand(b, f, c, size, size).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), dict(tree))


def _pair(port_cls, jax_cls, kw, video, seed=1, dtype="float32"):
    """The port model with peaked weights and the flax model with the same
    weights through the bridge (after checking the bridged tree against
    flax's own init tree, and the round trip)."""
    port = port_cls(**kw, dtype=dtype).eval()
    sd = peaked_transformer_state_dict(port, seed)
    port.load_state_dict(sd)
    jmodel = jax_cls(**kw, dtype=jnp.dtype(dtype))
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(video))["params"]
    params = sformer_params_to_jax(sd)
    assert _shapes(params) == _shapes(jax.device_get(init))
    back = sformer_state_dict_from_jax(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[n], sd[n]) for n in sd)
    return port, jmodel, {"params": params}


# -- tables and element-wise functions ------------------------------------


@pytest.mark.parametrize("n,dim", [(7, 16), (128, 32)])
def test_rotary_1d_matches_jax(n, dim):
    for got, want in zip(rotary.rotary_1d(n, dim),
                         jax_rotary.rotary_1d(n, dim)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # built once per (shape, device), not once per call
    assert rotary.rotary_1d(n, dim)[0] is rotary.rotary_1d(n, dim)[0]


@pytest.mark.parametrize("h,w,dim", [(4, 6, 32), (32, 32, 32), (3, 3, 8)])
def test_rotary_axial_matches_jax(h, w, dim):
    for got, want in zip(rotary.rotary_axial(h, w, dim),
                         jax_rotary.rotary_axial(h, w, dim)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dh,rot_dim", [(16, 16), (16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_matches_jax(dh, rot_dim, dtype):
    """Interleaved (-x2, x1) pairs, a passed-through tail, and float32
    tables that promote bfloat16 q and k to float32."""
    rng = np.random.RandomState(0)
    q = rng.randn(3, 7, dh).astype(np.float32)
    k = rng.randn(3, 7, dh).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = rotary.apply_rotary(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        rotary.rotary_1d(7, rot_dim))
    want = jax_rotary.apply_rotary(
        jnp.asarray(q).astype(dtype), jnp.asarray(k).astype(dtype),
        jax_rotary.rotary_1d(7, rot_dim))
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=1e-6)
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert rotary.rotate_every_two(x).tolist() == [[-2.0, 1.0, -4.0, 3.0]]


def test_token_shift_matches_jax():
    x = np.random.RandomState(0).randn(2, 1 + 6, 9).astype(np.float32)
    got = timesformer.token_shift(torch.from_numpy(x), f=3, n=2)
    want = jax_timesformer.token_shift(jnp.asarray(x), f=3, n=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_simdr_decode_matches_jax():
    """(B, J, 3, K) logits -> expected bin / 2; float32 whatever comes in."""
    logits = (np.random.RandomState(0).randn(2, 24, 3, 128) * 4).astype(
        np.float32)
    want = np.asarray(jax_softargmax.simdr_decode(jnp.asarray(logits)))
    got = simdr_decode(torch.from_numpy(logits))
    assert got.shape == (2, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert simdr_decode(torch.from_numpy(logits).bfloat16()).dtype == \
        torch.float32


def test_patchify_is_the_jax_transpose():
    """Tokens ordered (frame, patch row, patch column), features (row in
    patch, column in patch, channel): transpose (0, 1, 3, 5, 4, 6, 2)."""
    v = np.random.RandomState(0).rand(2, 3, 2, 8, 12).astype(np.float32)
    b, f, c, h, w = v.shape
    p = 4
    want = v.reshape(b, f, c, h // p, p, w // p, p).transpose(
        0, 1, 3, 5, 4, 6, 2).reshape(b, f * (h // p) * (w // p), p * p * c)
    got = sformer.patchify(torch.from_numpy(v), p)
    np.testing.assert_array_equal(got.numpy(), want)


# -- likely first faults, each on purpose ---------------------------------


def test_geglu_uses_the_tanh_gelu():
    """jax.nn.gelu is the tanh approximation; torch's default is erf.  At
    gates of a unit or two the two differ by a few 1e-4."""
    port = sformer.GEGLUFeedForward(8).eval()
    sd = peaked_transformer_state_dict(port, 3)
    port.load_state_dict(sd)
    x = np.random.RandomState(0).randn(2, 5, 8).astype(np.float32)
    want = jax_sformer.GEGLUFeedForward(8).apply(
        {"params": sformer_params_to_jax(sd)}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        a, gates = port.proj_in(torch.from_numpy(x)).chunk(2, dim=-1)
        erf = port.proj_out(a * torch.nn.functional.gelu(gates))
    assert _rel(got, want) <= F32_TOL
    assert _rel(erf, want) > 5 * F32_TOL  # the test can tell them apart


def test_layernorm_eps_is_flax():
    """flax LayerNorm eps 1e-6 (torch 1e-5): visible on a low-variance
    input."""
    from flax import linen as nn

    port = sformer.NlosPoseSformer(**SFORMER_KW)
    x = (np.random.RandomState(0).randn(2, 3, 32) * 3e-3).astype(np.float32)
    want = nn.LayerNorm().apply(
        {"params": {"scale": np.ones(32, np.float32),
                    "bias": np.zeros(32, np.float32)}}, jnp.asarray(x))
    with torch.no_grad():
        port.out_ln.weight.fill_(1.0)
        port.out_ln.bias.zero_()
        got = port.out_ln(torch.from_numpy(x))
        torch_default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (32,))
    assert _rel(got, want) <= F32_TOL
    assert _rel(torch_default, want) > 1e-2


# -- modules --------------------------------------------------------------


@pytest.mark.parametrize("over", ["space", "time"])
@pytest.mark.parametrize("with_rot", [True, False])
def test_joint_token_attention_matches_jax(over, with_rot):
    """b*h = 4 head groups and several groups each, so a ``repeat`` instead
    of ``repeat_interleave`` of the joint keys, or a wrong head split,
    fails."""
    f, n, dim, heads, dh, j = 3, 4, 16, 2, 8, 5
    port = sformer.JointTokenAttention(dim, heads, dh, j).eval()
    sd = peaked_transformer_state_dict(port, 2)
    port.load_state_dict(sd)
    x = np.random.RandomState(1).randn(2, j + f * n, dim).astype(np.float32)
    rot_p = rot_j = None
    if with_rot:
        if over == "space":
            rot_p = rotary.rotary_axial(2, 2, dh)
            rot_j = jax_rotary.rotary_axial(2, 2, dh)
        else:
            rot_p = rotary.rotary_1d(f, dh)
            rot_j = jax_rotary.rotary_1d(f, dh)
    want = jax_sformer.JointTokenAttention(dim, heads, dh, j).apply(
        {"params": sformer_params_to_jax(sd)}, jnp.asarray(x),
        f=f, n=n, over=over, rot=rot_j)
    with torch.no_grad():
        got = port(torch.from_numpy(x), f=f, n=n, over=over, rot=rot_p)
        other = None if with_rot else rotary.rotary_1d(
            n if over == "space" else f, dh)
        moved = port(torch.from_numpy(x), f=f, n=n, over=over, rot=other)
    assert (moved - got).abs().max() > 1e-3, "the tables have no effect"
    assert _rel(got, want) <= F32_TOL


VARIANTS = {
    "rotary": dict(),
    "pos_emb": dict(rotary_emb=False),
    "time_attn": dict(use_time_attn=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sformer_matches_jax_f32(variant, monkeypatch):
    """The JAX side through its Pallas kernel in interpret mode."""
    kw = dict(SFORMER_KW, **VARIANTS[variant])
    videos = [_video(4), _video(5)]
    port, jmodel, variables = _pair(
        sformer.NlosPoseSformer, jax_sformer.NlosPoseSformer, kw, videos[0])
    monkeypatch.setenv("HP_SFORMER_ATTN", "fused")
    outs = []
    for v in videos:
        want = np.asarray(jmodel.apply(variables, jnp.asarray(v)))
        with torch.no_grad():
            got = port(torch.from_numpy(v))
        assert got.shape == (2, 4, 4, 8) and got.dtype == torch.float32
        assert _rel(got, want) <= F32_TOL
        outs.append(got)
    # the comparison means something: logits are peaked, the decoded joints
    # spread across joints and move with the video
    joints = [simdr_decode(o[:, :, :3, :]).numpy() for o in outs]
    assert np.ptp(joints[0], axis=1).min() > 0.2
    assert np.abs(joints[0] - joints[1]).max() > 0.05
    assert _rel(outs[1], outs[0]) > 100 * F32_TOL


def test_sformer_without_rotary_tables_is_far_off():
    """Dropping the rotary tables moves the head output by far more than
    the tolerance: the parity above does test them."""
    port = sformer.NlosPoseSformer(**SFORMER_KW).eval()
    port.load_state_dict(peaked_transformer_state_dict(port, 1))
    v = torch.from_numpy(_video(4))
    with torch.no_grad():
        want = port(v)
        port.rotary_emb = False
        port.pos_emb = torch.zeros(1, 1, 1)
        got = port(v)
    assert _rel(got, want) > 1000 * F32_TOL


@pytest.mark.parametrize("shift_tokens", [False, True])
def test_timesformer_matches_jax_f32(shift_tokens, monkeypatch):
    kw = dict(TIMESFORMER_KW, shift_tokens=shift_tokens)
    v = _video(6, f=3)
    port, jmodel, variables = _pair(
        timesformer.TimeSformer, jax_timesformer.TimeSformer, kw, v)
    monkeypatch.setenv("HP_SFORMER_ATTN", "fused")
    want = np.asarray(jmodel.apply(variables, jnp.asarray(v)))
    with torch.no_grad():
        got = port(torch.from_numpy(v))
    assert got.shape == (2, 72)
    assert _rel(got, want) <= F32_TOL


def test_timesformer_pos_emb_variant_matches_jax():
    kw = dict(TIMESFORMER_KW, rotary_emb=False)
    v = _video(7, f=3)
    port, jmodel, variables = _pair(
        timesformer.TimeSformer, jax_timesformer.TimeSformer, kw, v)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(v)))
    with torch.no_grad():
        got = port(torch.from_numpy(v))
    assert _rel(got, want) <= F32_TOL


def test_bridge_round_trip_from_a_flax_init():
    """to_jax(from_jax(p)) == p on flax's own init, and
    sformer_state_dict_from_jax loads strictly."""
    v = _video(0)
    jmodel = jax_sformer.NlosPoseSformer(**SFORMER_KW, use_time_attn=True)
    p = jax.device_get(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(v)))[
        "params"]
    sd = sformer_state_dict_from_jax(p)
    port = sformer.NlosPoseSformer(**SFORMER_KW, use_time_attn=True)
    port.load_state_dict(sd, strict=True)
    back = sformer_params_to_jax(sformer_state_dict_from_jax(p))
    flat_p = jax.tree_util.tree_leaves_with_path(dict(p))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    with torch.no_grad():
        got = port(torch.from_numpy(v))
    assert _rel(got, jmodel.apply({"params": p}, jnp.asarray(v))) <= F32_TOL


# -- the bfloat16 mode ----------------------------------------------------


def _jax_dtypes(jmodel, variables, video, monkeypatch):
    """Output, per-module output dtypes and the (q, k, v) dtypes of every
    ``_attend`` call of the flax model (eager apply)."""
    calls = []
    plain = jax_sformer._attend

    def spy(q, k, v):
        calls.append((str(q.dtype), str(k.dtype), str(v.dtype)))
        return plain(q, k, v)

    monkeypatch.setattr(jax_sformer, "_attend", spy)
    out, state = jmodel.apply(variables, jnp.asarray(video),
                              capture_intermediates=True)
    mods = {}

    def walk(node, prefix):
        for key, val in node.items():
            if key == "__call__":
                mods["/".join(prefix)] = str(val[0].dtype)
            else:
                walk(val, (*prefix, key))

    walk(state["intermediates"], ())
    return out, mods, calls


def _port_dtypes(port, video):
    calls, mods, hooks = [], {}, []
    for name, m in port.named_modules():
        if name:
            hooks.append(m.register_forward_hook(
                lambda _m, _i, o, name=name: mods.__setitem__(
                    name.replace(".", "/").replace("proj_", ""),
                    str(o.dtype).replace("torch.", ""))))
        if isinstance(m, sformer.JointTokenAttention):
            plain = m._attend

            def spy(q, k, v, plain=plain):
                calls.append(tuple(str(t.dtype).replace("torch.", "")
                                   for t in (q, k, v)))
                return plain(q, k, v)

            m._attend = spy
    with torch.no_grad():
        out = port(torch.from_numpy(video))
    for h in hooks:
        h.remove()
    return out, mods, calls


@pytest.mark.parametrize("variant", ["rotary", "pos_emb", "time_attn"])
def test_sformer_bf16_mode_dtypes_and_values(variant, monkeypatch):
    """Only the Dense layers run in bfloat16: LayerNorm and the residual
    stream stay float32, the rotary tables promote the patch q and k, so
    the grouped attention sees (f32, f32, bf16) and the joint-token read
    (bf16, bf16, bf16).  Every module's output dtype and every attention
    call's dtypes equal the JAX package's."""
    kw = dict(SFORMER_KW, **VARIANTS[variant])
    v = _video(8)
    port, jmodel, variables = _pair(
        sformer.NlosPoseSformer, jax_sformer.NlosPoseSformer, kw, v,
        dtype="bfloat16")
    want, jmods, jcalls = _jax_dtypes(jmodel, variables, v, monkeypatch)
    got, pmods, pcalls = _port_dtypes(port, v)
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    assert pcalls == jcalls
    patch_call = ("float32", "float32", "bfloat16") if kw.get(
        "rotary_emb", True) else ("bfloat16",) * 3
    assert pcalls[:2] == [("bfloat16",) * 3, patch_call]
    shared = {k: v_ for k, v_ in jmods.items() if k in pmods}
    assert len(shared) >= 5 * kw["depth"] + 3, sorted(jmods)
    assert {k: pmods[k] for k in shared} == shared
    assert shared["spatial_ln_0"] == "float32"
    assert shared["spatial_attn_0/to_qkv"] == "bfloat16"
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) <= BF16_TOL


def test_timesformer_bf16_mode_matches_jax():
    v = _video(9, f=3)
    port, jmodel, variables = _pair(
        timesformer.TimeSformer, jax_timesformer.TimeSformer,
        dict(TIMESFORMER_KW, shift_tokens=True), v, dtype="bfloat16")
    want = jmodel.apply(variables, jnp.asarray(v))
    with torch.no_grad():
        got = port(torch.from_numpy(v))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) <= BF16_TOL


# -- the slice as a whole -------------------------------------------------


def _tiny_model_cfg(mod):
    m = mod.default_config().tiny(16).model
    return dataclasses.replace(m, patch_feature_dim=32, depth=2, heads=2,
                               dim_head=8, out_dim=64, num_frames=4)


@pytest.mark.parametrize("dtype,tol,joint_tol", [
    ("float32", F32_TOL, 1e-3), ("bfloat16", BF16_TOL, 1.0)])
def test_video_to_joints_matches_jax(dtype, tol, joint_tol, monkeypatch):
    """video -> sformer_from_config -> SimDR logits -> simdr_decode -> joints
    in both packages at a tiny config (24 joints, 16 bins per axis)."""
    pcfg = dataclasses.replace(_tiny_model_cfg(config), compute_dtype=dtype)
    jcfg = dataclasses.replace(_tiny_model_cfg(jax_config),
                               compute_dtype=dtype)
    port = sformer.build_sformer(pcfg, device="cpu", seed=0)
    assert not port.training and port.compute_dtype == getattr(torch, dtype)
    sd = peaked_transformer_state_dict(port, 5)
    port.load_state_dict(sd)
    video = _video(10, b=2, f=4)
    jmodel = jax_sformer.sformer_from_config(jcfg)
    variables = {"params": sformer_params_to_jax(sd)}
    monkeypatch.setenv("HP_SFORMER_ATTN", "fused")
    jout = jax.jit(jmodel.apply)(variables, jnp.asarray(video))
    want = np.asarray(jax_softargmax.simdr_decode(jout[:, :, :3, :]))
    joints, out = sformer.serve_video(port, torch.from_numpy(video))
    assert out.shape == (2, 24, 4, 16) and joints.shape == (2, 24, 3)
    assert joints.dtype == torch.float32
    assert _rel(out.float(), np.asarray(jout.astype(jnp.float32))) <= tol
    assert np.ptp(want, axis=1).min() > 1.0  # joints spread over the bins
    # joints in image units (bins / 2): the f32 limit is the logits' 1e-5
    # through a peaked softmax; bf16 may move a peak by a bin or two
    assert np.abs(joints.numpy() - want).max() <= joint_tol


def test_set_use_kernels_routes_to_the_plain_version(monkeypatch):
    port = sformer.NlosPoseSformer(**SFORMER_KW).eval()
    port.load_state_dict(peaked_transformer_state_dict(port, 1))
    calls = []
    monkeypatch.setattr(
        sformer, "attend",
        lambda q, k, v: calls.append(q.shape) or sformer.attend_ref(q, k, v))
    v = torch.from_numpy(_video(4))
    with torch.no_grad():
        a = port(v)
        assert len(calls) == 2 * SFORMER_KW["depth"]  # joint read + groups
        port.set_use_kernels(False)
        b = port(v)
        assert len(calls) == 2 * SFORMER_KW["depth"]
    assert torch.equal(a, b)


def test_training_forward_goes_through_the_function():
    """With grad mode on and parameters that require grad the model calls
    K9's autograd.Function (the raw wrapper would raise), and every
    parameter gets a gradient."""
    port = sformer.NlosPoseSformer(**SFORMER_KW)
    port.load_state_dict(peaked_transformer_state_dict(port, 1))
    out = port(torch.from_numpy(_video(4)))
    out.square().mean().backward()
    missing = [n for n, p in port.named_parameters() if p.grad is None]
    assert not missing, missing
