"""The port's graft entry points (``hiddenpose_tpu_torch/graft_entry.py``,
the counterpart of the root ``__graft_entry__.py``) on the CPU, when asked
for: ``entry()``'s forward against the JAX package's on the same weights
and measurement, and ``dryrun_multichip(4, device="cpu")``, 4 gloo
ranks as a (data 2, model 2) mesh: the data x tensor-parallel step and
the sharded-LCT step, each with a finite loss, the second within the JAX
dry run's envelope of the first (0.1 x max(1, |loss|), checked by the
ranks; a broken sharded FFT diverges O(1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import default_config as jax_default_config
from hiddenpose_tpu.models.nlospose import build_nlospose as jax_build
from hiddenpose_tpu.train.step import make_forward as jax_make_forward
from hiddenpose_tpu_torch.graft_entry import dryrun_multichip, entry
from hiddenpose_tpu_torch.utils.jax_bridge import to_jax
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 16


def test_entry_runs_on_the_cpu_as_the_jax_forward(monkeypatch):
    """``entry()`` at ``HP_ENTRY_SIZE=16`` on the CPU: joints (1, 72) and
    heatmaps (1, 24, 8, 8, 8), within 1e-5 of the largest logit of the
    JAX package's ``entry`` forward on the same weights (carried through
    ``utils/jax_bridge.py``) and measurement."""
    monkeypatch.setenv("HP_ENTRY_SIZE", str(SIZE))
    fn, args = entry(device="cpu")
    model, meas, lct = args
    joints, hm = fn(*args)
    assert joints.shape == (1, 72) and hm.shape == (1, 24, 8, 8, 8)
    assert torch.isfinite(joints).all()
    variables = {"params": to_jax(dict(model.named_parameters())),
                 "batch_stats": to_jax(dict(model.named_buffers()),
                                       "batch_stats")}
    jmodel, jlct = jax_build(jax_default_config().tiny(SIZE).model)
    want_j, want_hm = jax.jit(jax_make_forward(jmodel))(
        variables, jnp.asarray(meas.numpy()), jlct)
    want_hm = np.asarray(want_hm)
    np.testing.assert_allclose(hm.numpy(), want_hm, rtol=0,
                               atol=1e-5 * np.abs(want_hm).max())
    np.testing.assert_allclose(joints.numpy(), np.asarray(want_j), rtol=0,
                               atol=1e-3)


def test_dryrun_multichip_on_four_gloo_ranks():
    out = dryrun_multichip(4, device="cpu", timeout=300)
    assert out["n_devices"] == 4 and out["mesh"] == [2, 2]
    assert out["device"] == "cpu"
    assert np.isfinite(out["loss"]) and np.isfinite(out["sharded_lct_loss"])
    assert abs(out["sharded_lct_loss"] - out["loss"]) < 0.1 * max(
        1.0, abs(out["loss"]))


def test_dryrun_multichip_never_shrinks_n():
    with pytest.raises(ValueError, match="at least 1"):
        dryrun_multichip(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dryrun_multichip(2)
    else:
        with pytest.raises(ValueError, match="GPUs"):
            dryrun_multichip(torch.cuda.device_count() + 1)
