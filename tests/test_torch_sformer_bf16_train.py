"""The Sformer's training in the bfloat16 mode: ``make_simdr_step`` on an
``NlosPoseSformer`` and on a TimeSformer built with ``dtype=bfloat16``
(bf16 Dense layers, f32 parameters, LayerNorm and rotary tables), one
step of the port against one of the JAX package, and the attention
kernel's gradient on the mixed dtypes that this mode gives it.

* ``AttendFused`` on (f32 q, f32 k, bf16 v), the grouped attention's
  operands in the bf16 mode (the f32 rotary tables promote q and k):
  its output and the gradient it returns for each input against
  ``jax.vjp`` of the JAX package's ``attend_ref``, dtypes included (f32
  dq and dk, a bf16 dv); dq and dk within 1e-5 of the largest, dv within
  one bf16 ulp.  The bf16 joint-token read (bf16 q, k and v) likewise.
* One bf16 SimDR step of each package from the same peaked weights and
  batch; the JAX step compiled without XLA's excess precision, so that
  the roundings the program writes take place.  A bf16 step rounds at
  every Dense, so the port's step is held within twice the JAX bf16
  step's own distance from its f32 step: the loss (relative) and the
  parameter updates (relative L2 of new - old); and it must lie from the
  port's f32 step at least a tenth of that distance (an f32 step posing
  as bf16 fails).  No bf16 reduction of a cotangent is held against the
  JAX CPU: its reductions sum in another order.
* Every bf16 Dense receives a bf16 cotangent in the port's backward, and
  every parameter's gradient is float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hiddenpose_tpu.models import sformer as jax_sformer
from hiddenpose_tpu.models import timesformer as jax_timesformer
from hiddenpose_tpu.ops.pallas.attn_vmem import attend_ref as jax_attend_ref
from hiddenpose_tpu.train import alt_steps as jax_alt
from hiddenpose_tpu_torch.config import TrainConfig
from hiddenpose_tpu_torch.models.sformer import Dense, NlosPoseSformer
from hiddenpose_tpu_torch.models.timesformer import TimeSformer
from hiddenpose_tpu_torch.ops.kernels import bf16_ulp_excess
from hiddenpose_tpu_torch.ops.kernels.attn import attend_diff
from hiddenpose_tpu_torch.train import alt_steps
from hiddenpose_tpu_torch.train.optim import make_optimizer
from hiddenpose_tpu_torch.utils.jax_bridge import (
    sformer_params_to_jax,
    sformer_state_dict_from_jax,
)
from hiddenpose_tpu_torch.utils.peaked import peaked_transformer_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

BF16 = jnp.bfloat16
LR = 1e-3
J, K = 4, 16
SF_KW = dict(dim=32, num_frames=2, num_joints=J, image_size=16,
             patch_size=4, channels=1, depth=1, heads=2, dim_head=8,
             out_dim=4 * K)
TS_KW = dict(dim=32, num_frames=2, num_classes=J * 3 * K, image_size=16,
             patch_size=4, channels=1, depth=1, heads=2, dim_head=8)


# ---------------------------------------------------------------- K9's VJP

@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"],
                         ids=["grouped_f32_qk", "joint_read_bf16"])
def test_attend_fused_vjp_on_mixed_dtypes_matches_jax(q_dtype):
    rng = np.random.RandomState(0)
    jdt = {"float32": jnp.float32, "bfloat16": BF16}[q_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[q_dtype]
    q = jnp.asarray(rng.randn(4, 9, 8), jdt)
    k = jnp.asarray(rng.randn(4, 13, 8), jdt)
    v = jnp.asarray(rng.randn(4, 13, 8), BF16)
    g = jnp.asarray(rng.randn(4, 9, 8), BF16)
    out, vjp = jax.vjp(jax_attend_ref, q, k, v)
    want = vjp(g)

    def port(a, dt):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dt)

    tq, tk = port(q, tdt).requires_grad_(), port(k, tdt).requires_grad_()
    tv = port(v, torch.bfloat16).requires_grad_()
    got = attend_diff(tq, tk, tv)
    got.backward(port(g, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and out.dtype == BF16
    assert bf16_ulp_excess(got, port(out, torch.float32), 0.0) <= 0
    for t, w in zip((tq, tk, tv), want):
        assert str(t.grad.dtype).replace("torch.", "") == w.dtype.name
    for t, w in zip((tq, tk), want[:2]):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert bf16_ulp_excess(tv.grad, port(want[2], torch.float32), 0.0) <= 0


# ------------------------------------------------------------- the steps

class _JaxTimeSformerSimDR:
    """The JAX TimeSformer's (B, J * 3 * K) output as SimDR logits (B, J,
    3, K), for ``make_simdr_step``, which reads ``model.apply``."""

    def __init__(self, **kw):
        self.net = jax_timesformer.TimeSformer(**kw)

    def apply(self, variables, video):
        return self.net.apply(variables, video).reshape(-1, J, 3, K)


class _TimeSformerSimDR(torch.nn.Module):
    """The port's TimeSformer under the same reshape."""

    def __init__(self, **kw):
        super().__init__()
        self.net = TimeSformer(**kw)

    def forward(self, video):
        return self.net(video).reshape(-1, J, 3, K)


def _batch():
    rng = np.random.RandomState(0)
    return {"video": rng.rand(2, 2, 1, 16, 16).astype(np.float32),
            "target_bins": rng.randint(0, K, (2, J, 3)).astype(np.int32),
            "target_weight": (rng.rand(2, J) > 0.2).astype(np.float32)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(kind, dtype, params, batch):
    if kind == "sformer":
        model = jax_sformer.NlosPoseSformer(**SF_KW, dtype=dtype)
    else:
        model = _JaxTimeSformerSimDR(**TS_KW, dtype=dtype)
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    step = jax_alt.make_simdr_step(model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = step.lower(params, opt_state, tx, jbatch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    new, _, metrics = compiled(params, opt_state, jbatch)
    return dict(loss=float(metrics["loss"]), params=_flat(new))


def _port_model(kind, dtype):
    if kind == "sformer":
        return NlosPoseSformer(**SF_KW, dtype=dtype)
    return _TimeSformerSimDR(**TS_KW, dtype=dtype)


def _port_step(kind, dtype, sd, batch, seen=None):
    model = _port_model(kind, dtype)
    net = model if kind == "sformer" else model.net
    net.load_state_dict(sd)
    hooks = []
    if seen is not None:
        def keep(m, i, o):
            o.register_hook(lambda g: seen.add(g.dtype))
        hooks = [m.register_forward_hook(keep) for m in model.modules()
                 if isinstance(m, Dense)]
    opt = make_optimizer(TrainConfig(), model.parameters())[0]
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics = alt_steps.make_simdr_step(model)(opt, tbatch)
    for h in hooks:
        h.remove()
    named = dict(net.named_parameters())
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in named.values())
    return dict(loss=float(metrics["loss"]),
                params=_flat(sformer_params_to_jax(named)))


@pytest.fixture(scope="module", params=["sformer", "timesformer"])
def steps(request):
    kind = request.param
    with torch.device("meta"):  # names and shapes only
        template = (NlosPoseSformer(**SF_KW) if kind == "sformer"
                    else TimeSformer(**TS_KW))
    sd = peaked_transformer_state_dict(template, 1)
    params = sformer_params_to_jax(sd)
    batch = _batch()
    seen = set()
    out = dict(params0=_flat(params),
               jax32=_jax_step(kind, jnp.float32, params, batch),
               jax16=_jax_step(kind, BF16, params, batch),
               port32=_port_step(kind, torch.float32,
                                 sformer_state_dict_from_jax(params), batch),
               port16=_port_step(kind, torch.bfloat16,
                                 sformer_state_dict_from_jax(params), batch,
                                 seen))
    out["dense_cotangents"] = seen
    return out


def _distances(a, b, params0):
    """The loss (relative) and the parameter updates (relative L2 of new -
    old over every parameter) of step ``a`` from step ``b``."""
    num = den = 0.0
    for k, p0 in params0.items():
        da = a["params"][k].astype(np.float64) - p0
        db = b["params"][k].astype(np.float64) - p0
        num += np.sum((da - db) ** 2)
        den += np.sum(db ** 2)
    return dict(loss=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                updates=np.sqrt(num / den))


def test_bf16_simdr_step_matches_jax(steps):
    ref = _distances(steps["jax16"], steps["jax32"], steps["params0"])
    got = _distances(steps["port16"], steps["jax16"], steps["params0"])
    own = _distances(steps["port16"], steps["port32"], steps["params0"])
    assert np.isfinite(steps["port16"]["loss"])
    assert steps["port16"]["params"].keys() == steps["jax16"]["params"].keys()
    for k in ref:
        assert ref[k] > 0, k  # bf16 moves the JAX step
        assert got[k] <= 2 * ref[k], (k, got[k], ref[k])
        # the port's bf16 step is not its f32 step
        assert own[k] >= 0.1 * ref[k], (k, own[k], ref[k])


def test_bf16_dense_layers_take_bf16_cotangents(steps):
    assert steps["dense_cotangents"] == {torch.bfloat16}
