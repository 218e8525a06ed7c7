"""K9 (fused grouped attention) on the CPU: the port's plain version
``attend_ref`` against the JAX package's Pallas kernel in interpret mode
and against its ``attend_ref``; the ``autograd.Function``'s gradients
against ``jax.grad`` of the JAX ``attend_fused``; the wrapper's argument
checks and the router; the plain emulations of the CUDA kernel's arithmetic
(three TF32 passes, the split over the keys) against a float64 attention,
the plain version and the JAX package.  On a CPU tensor the wrapper runs the plain version,
so these tests hold the arithmetic contract; the CUDA kernel itself is held
against the plain version on the GPU (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

Tolerances: float32 1e-5 (the two differ in summation order only; the JAX
tests hold the TPU kernel to 1e-6 on these shapes, and torch's CPU bmm sums
in another order than XLA's); bfloat16 2e-2 (one bf16 rounding of the
probabilities and of the output); gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.ops.pallas import attn_vmem as jax_attn
from hiddenpose_tpu_torch.ops.kernels import KERNELS
from hiddenpose_tpu_torch.ops.kernels._tf32 import tf32_round
from hiddenpose_tpu_torch.ops.kernels.attn import (
    AttendFused,
    attend,
    attend_3xtf32_ref,
    attend_diff,
    attend_online_ref,
    attend_ref,
    attend_split_ref,
    attend_routed,
    attend_supported,
)

# (B, Lq, Lk, dh): the shapes of tests/test_attn_vmem.py (ragged Lk below
# and above 128, the Sformer's group shape at a small B, a small-Lq wide
# head).
SHAPES = [(3, 64, 80, 32), (2, 256, 131, 32), (1, 128, 1048, 32),
          (2, 24, 640, 64)]


def _qkv(shape, seed, q_scale=None):
    b, lq, lk, dh = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, dh).astype(np.float32) * (
        dh ** -0.5 if q_scale is None else q_scale)
    k = rng.randn(b, lk, dh).astype(np.float32)
    v = rng.randn(b, lk, dh).astype(np.float32)
    return q, k, v


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_attend_ref_matches_pallas_interpret_f32(shape):
    q, k, v = _qkv(shape, 0)
    got = attend(_t(q), _t(k), _t(v)).numpy()  # CPU tensor: the plain version
    pallas = np.asarray(jax_attn._attend_fused_impl(
        _j(q), _j(k), _j(v), interpret=True))
    ref = np.asarray(jax_attn.attend_ref(_j(q), _j(k), _j(v)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_attend_ref_extreme_logits():
    """Logits x 50: the max-subtracted softmax stays finite and equal."""
    q, k, v = _qkv((1, 8, 136, 8), 2, q_scale=50.0)
    got = attend_ref(_t(q), _t(k), _t(v)).numpy()
    pallas = np.asarray(jax_attn._attend_fused_impl(
        _j(q), _j(k), _j(v), interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qk_dtype", ["bfloat16", "float32"])
def test_attend_ref_matches_pallas_interpret_bf16_v(qk_dtype):
    """(bf16, bf16, bf16) and the Sformer's bfloat16-mode combination,
    float32 q/k with a bfloat16 v: output dtype and values."""
    q, k, v = _qkv((2, 64, 200, 32), 1)
    tq = torch.bfloat16 if qk_dtype == "bfloat16" else torch.float32
    jq = jnp.bfloat16 if qk_dtype == "bfloat16" else jnp.float32
    got = attend(_t(q, tq), _t(k, tq), _t(v, torch.bfloat16))
    pallas = jax_attn._attend_fused_impl(
        _j(q, jq), _j(k, jq), _j(v, jnp.bfloat16), interpret=True)
    ref = jax_attn.attend_ref(_j(q, jq), _j(k, jq), _j(v, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert pallas.dtype == jnp.bfloat16 and ref.dtype == jnp.bfloat16
    for want in (pallas, ref):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want).astype(np.float32),
            rtol=2e-2, atol=2e-2)


def test_attend_diff_gradients_match_jax(monkeypatch):
    """Forward the wrapper, backward the plain attention gradient, against
    jax.grad of the JAX package's attend_fused (whose VJP is the same)."""
    monkeypatch.setattr(jax_attn, "on_tpu_default_device", lambda: False)
    q, k, v = _qkv((2, 16, 40, 16), 3)

    def loss(q_, k_, v_):
        return jnp.sum(jax_attn.attend_fused(q_, k_, v_) ** 2)

    want = jax.grad(loss, (0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = attend_diff(tq, tk, tv)
    assert out.grad_fn is not None
    out.pow(2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_attend_diff_skips_gradients_not_needed():
    q, k, v = (_t(a) for a in _qkv((1, 8, 12, 8), 4))
    k.requires_grad_()
    out = AttendFused.apply(q, k, v)
    (dk,) = torch.autograd.grad(out.sum(), [k])
    with torch.enable_grad():
        k2 = k.detach().requires_grad_()
        (want,) = torch.autograd.grad(attend_ref(q, k2, v).sum(), [k2])
    torch.testing.assert_close(dk, want, rtol=1e-6, atol=1e-6)


def test_raw_wrapper_refuses_inputs_that_require_grad():
    q, k, v = (_t(a) for a in _qkv((1, 8, 12, 8), 5))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="attend_diff"):
        attend(q, k, v)
    with torch.no_grad():  # a serving forward may hold parameters
        assert attend(q, k, v).shape == (1, 8, 8)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (_t(a) for a in _qkv((1, 8, 12, 8), 6))
    with pytest.raises(ValueError):
        attend(q[:, :, :6], k[:, :, :6], v[:, :, :6])      # dh % 4
    with pytest.raises(ValueError):
        attend(q.transpose(0, 1), k, v)                    # not contiguous
    with pytest.raises(TypeError):
        attend(q.double(), k.double(), v.double())         # float64
    with pytest.raises(TypeError):
        attend(q.bfloat16(), k.bfloat16(), v)              # bf16 q/k, f32 v
    with pytest.raises(TypeError):
        attend(q, k.bfloat16(), v)                         # q and k differ
    with pytest.raises(ValueError):
        attend(q, k, v[:, :5])                             # v's Lk
    with pytest.raises(ValueError, match="unsupported device"):
        attend(*(torch.zeros(s, device="meta")
                 for s in ((1, 8, 8), (1, 12, 8), (1, 12, 8))))


def test_router_covers_the_tpu_router():
    """Every shape the JAX package sends to its kernel, the port sends to
    K9; so it does the joint-token read (more than 4096 keys), which the
    TPU router leaves to XLA and the port's kernel splits over the keys."""
    for lq in (8, 24, 128, 1024):
        for lk in (8, 129, 152, 1048, 4096):
            for dh in (8, 16, 24, 32, 64, 128, 256):
                if jax_attn.attend_fused_supported((8, lq, dh), (8, lk, dh)):
                    assert attend_routed((8, lq, dh), (8, lk, dh))
    assert attend_routed((8, 100, 32), (8, 1048, 32))   # no Lq % 8 limit
    assert attend_routed((8, 64, 20), (8, 512, 20))     # dh % 4 is enough
    assert not jax_attn.attend_fused_supported((8, 24, 32), (8, 131096, 32))
    assert attend_routed((8, 24, 32), (8, 131096, 32))  # joint read
    assert attend_supported((8, 24, 32), (8, 131096, 32))
    assert not attend_routed((8, 64, 30), (8, 512, 30))
    assert not attend_supported((8, 64, 30), (8, 512, 30))
    assert not attend_supported((8, 64, 260), (8, 512, 260))


# The tolerance chip_smoke.py holds the f32 kernel to against the plain
# version: |got - want| <= atol + rtol * |want|.
ATTN_F32_TOL = dict(rtol=1e-5, atol=2e-6)
EXTREME = ((1, 8, 136, 8), 50.0)


def _attention64(q, k, v):
    q, k, v = (torch.from_numpy(a).double() for a in (q, k, v))
    return (torch.softmax(q @ k.transpose(1, 2), -1) @ v).numpy()


def _emulation_cases():
    return [(s, None) for s in SHAPES] + [EXTREME]


@pytest.mark.parametrize("shape,q_scale", _emulation_cases())
def test_3xtf32_emulation_is_as_close_to_float64_as_plain_f32(shape, q_scale):
    """Three TF32 passes per product: the error against a float64 attention
    is at most twice the plain f32 version's own."""
    q, k, v = _qkv(shape, 7, q_scale=q_scale)
    want = _attention64(q, k, v)
    got = attend_3xtf32_ref(_t(q), _t(k), _t(v)).numpy()
    plain = attend_ref(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(got - want).max() <= 2 * np.abs(plain - want).max()


def _attend_one_tf32_pass(q, k, v):
    """What the kernel must never do: every operand rounded to TF32 once."""
    sim = torch.bmm(tf32_round(q), tf32_round(k.transpose(1, 2).contiguous()))
    p = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
    return torch.bmm(tf32_round(p), tf32_round(v)) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("shape,q_scale", _emulation_cases())
def test_one_tf32_pass_fails_the_float64_check(shape, q_scale):
    """One TF32 pass per product is far outside the limit that the
    three-pass form meets."""
    q, k, v = _qkv(shape, 7, q_scale=q_scale)
    want = _attention64(q, k, v)
    got = _attend_one_tf32_pass(_t(q), _t(k), _t(v)).numpy()
    plain = attend_ref(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(got - want).max() > 2 * np.abs(plain - want).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_emulation_matches_pallas_interpret_f32(shape):
    q, k, v = _qkv(shape, 0)
    got = attend_3xtf32_ref(_t(q), _t(k), _t(v)).numpy()
    pallas = np.asarray(jax_attn._attend_fused_impl(
        _j(q), _j(k), _j(v), interpret=True))
    np.testing.assert_allclose(got, pallas, **ATTN_F32_TOL)


@pytest.mark.parametrize("qk_dtype", [torch.bfloat16, torch.float32])
def test_bf16_v_emulation_within_one_ulp_of_plain(qk_dtype):
    """With a bf16 v the kernel rounds the unnormalised probability (the
    plain version the normalised one): the bf16 outputs differ by at most
    one bf16 ulp, 2^-7 of the value (atol for outputs near zero)."""
    q, k, v = _qkv((2, 64, 200, 32), 1)
    args = _t(q, qk_dtype), _t(k, qk_dtype), _t(v, torch.bfloat16)
    got = attend_3xtf32_ref(*args)
    want = attend_ref(*args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


# (B, Lq, Lk, dh), chunks: one chunk, two, seven, more chunks than keys need
# (a chunk longer than Lk is S = 1; here the last chunks are empty), and a
# last chunk with one key.
SPLIT_CASES = [((2, 24, 300, 32), 1), ((2, 24, 300, 32), 2),
               ((2, 24, 300, 32), 7), ((1, 130, 40, 16), 64),
               ((2, 24, 301, 32), 3), ((1, 1, 129, 8), 2)]


@pytest.mark.parametrize("shape,splits", SPLIT_CASES)
def test_split_over_the_keys_equals_plain(shape, splits):
    q, k, v = _qkv(shape, 8)
    got = attend_split_ref(_t(q), _t(k), _t(v), splits).numpy()
    want = attend_ref(_t(q), _t(k), _t(v)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ATTN_F32_TOL)


def test_split_over_the_keys_extreme_logits_and_bf16_v():
    q, k, v = _qkv(*EXTREME[:1], 9, q_scale=EXTREME[1])
    got = attend_split_ref(_t(q), _t(k), _t(v), 5).numpy()
    np.testing.assert_allclose(got, attend_ref(_t(q), _t(k), _t(v)).numpy(),
                               rtol=1e-5, atol=1e-5)
    vb = _t(v, torch.bfloat16)
    got = attend_split_ref(_t(q), _t(k), vb, 5)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), attend_ref(_t(q), _t(k), vb).float(),
                               rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.parametrize("splits", [3, 65])
def test_split_matches_jax_reference_at_a_joint_token_read_shape(splits):
    """Lq 24 against more keys than the TPU router takes (Lk > 4096)."""
    shape = (2, 24, 4120, 32)
    assert not jax_attn.attend_fused_supported(shape[:2] + shape[3:],
                                               (2, 4120, 32))
    q, k, v = _qkv(shape, 10)
    got = attend_split_ref(_t(q), _t(k), _t(v), splits).numpy()
    want = np.asarray(jax_attn.attend_ref(_j(q), _j(k), _j(v)))
    np.testing.assert_allclose(got, want, **ATTN_F32_TOL)
    np.testing.assert_allclose(attend(_t(q), _t(k), _t(v)).numpy(), want,
                               **ATTN_F32_TOL)


def _attend_tile_loop(q, k, v, chunk, tile=64):
    """The kernel's loop written out: per chunk, ``tile``-key tiles (64
    in the tensor-core form, 8 in the SIMT form), a running max in base-2
    units, acc = acc * 2^(m - n) + round(p) v, then the chunks combined;
    the output before its cast, float32."""
    lk = k.shape[1]
    ms, ls, accs = [], [], []
    for c0 in range(0, lk, chunk):
        m = l = acc = None
        for t0 in range(c0, min(c0 + chunk, lk), tile):
            s = torch.bmm(q.double(), k[:, t0:t0 + tile].double()
                          .transpose(1, 2)).float()
            n = s.amax(-1, keepdim=True) * 1.4426950408889634
            n = n if m is None else torch.maximum(m, n)
            p = torch.exp2(s * 1.4426950408889634 - n)
            part = torch.bmm(p.to(v.dtype).float(),
                             v[:, t0:t0 + tile].float())
            if m is None:
                acc, l = part, p.sum(-1, keepdim=True)
            else:
                sc = torch.exp2(m - n)
                acc, l = acc * sc + part, l * sc + p.sum(-1, keepdim=True)
            m = n
        ms.append(m), ls.append(l), accs.append(acc)
    top = torch.stack(ms).amax(0)
    w = [torch.exp2(m_s - top) for m_s in ms]
    return (sum(w_ * a for w_, a in zip(w, accs))
            / sum(w_ * l_ for w_, l_ in zip(w, ls)))


# (B, Lq, Lk, dh), chunk: one chunk (a ragged last tile), chunks of two
# tiles with a short last chunk, chunks of three tiles at head dim 16
ONLINE_CASES = [((2, 24, 300, 32), None), ((2, 40, 301, 32), 128),
                ((1, 24, 1000, 16), 192)]


@pytest.mark.parametrize("shape,chunk", ONLINE_CASES)
def test_online_order_equals_plain(shape, chunk):
    """The kernel's order is the same function: float32 within the plain
    version's tolerance, a bf16 v within one bf16 ulp of it."""
    q, k, v = (_t(a) for a in _qkv(shape, 11))
    got = attend_online_ref(q, k, v, chunk)
    np.testing.assert_allclose(got.numpy(), attend_ref(q, k, v).numpy(),
                               **ATTN_F32_TOL)
    vb = v.to(torch.bfloat16)
    got = attend_online_ref(q, k, vb, chunk)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), attend_ref(q, k, vb).float(),
                               rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.parametrize("chunk", [None, 128])
def test_online_order_rounds_where_the_kernel_loop_does(chunk):
    """Scores that rise along the keys, so that the running max moves at
    every tile: with a bf16 v the kernel-order version agrees with the
    kernel's loop written out to float32 rounding (the bf16 outputs equal
    at 99% of the elements at least, the rest within one bf16 ulp, as
    the other bf16-v tests hold them), where the final-max form
    (``attend_3xtf32_ref``) rounds p differently at many of them."""
    shape = (2, 32, 512, 32)
    q, k, v = (_t(a) for a in _qkv(shape, 12))
    ramp = torch.linspace(0, 6, shape[2])[None, :, None]
    k = k + ramp * q.mean(dim=1, keepdim=True).sign() / shape[3] ** 0.5
    vb = v.to(torch.bfloat16)
    want = _attend_tile_loop(q, k, vb, chunk or shape[2])
    got = attend_online_ref(q, k, vb, chunk)
    final_max = attend_3xtf32_ref(q, k, vb)
    want = want.to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    same = (got == want).float().mean().item()
    other = (final_max == want).float().mean().item()
    assert same >= 0.99 and other < same, (same, other)


@pytest.mark.parametrize("chunk", [None, 128])
def test_online_order_takes_the_simt_tile_off_head_dim_32(chunk):
    """Off head dim 32 the kernel's SIMT form updates its running max
    every 8 keys: at head dim 8 the kernel-order version follows that
    loop (8-key tiles) as closely as it follows the tensor-core loop
    above, and further from the 64-key loop."""
    shape = (2, 32, 301, 8)
    q, k, v = (_t(a) for a in _qkv(shape, 13))
    ramp = torch.linspace(0, 6, shape[2])[None, :, None]
    k = k + ramp * q.mean(dim=1, keepdim=True).sign() / shape[3] ** 0.5
    vb = v.to(torch.bfloat16)
    want = _attend_tile_loop(q, k, vb, chunk or shape[2], tile=8)
    got = attend_online_ref(q, k, vb, chunk)
    wide = _attend_tile_loop(q, k, vb, chunk or shape[2], tile=64)
    want, wide = want.to(torch.bfloat16), wide.to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    same = (got == want).float().mean().item()
    other = (wide == want).float().mean().item()
    assert same >= 0.99 and other < same, (same, other)


def test_kernel_is_registered():
    wrapper, plain, source, replaces = KERNELS["attend"]
    assert wrapper is attend and plain is attend_ref
    assert source == "hiddenpose_tpu_torch/csrc/attn.cu"
    assert replaces == "hiddenpose_tpu/ops/pallas/attn_vmem.py:101"
