"""The port's data-parallel x tensor-parallel train step against the port's
own single-process step, which ``tests/test_torch_train_step.py`` holds
against the JAX package's.

One step of the tiny(16) NlosPose (its peaked weights, ``utils/
peaked.py`` seed 1; a seeded batch of 4, the JAX package's
``tests/test_parallel.py`` batch) two ways: on 4 gloo ranks as a (data 2,
model 2) mesh, each rank holding 2 samples and half of every wide weight
and its Adam moments (``tests/torch_parallel_workers.py::dp_step``), and
in one process on the whole batch.  Limits: the JAX package's own for its
DP x TP step against one device (``tests/test_parallel.py``): the loss
within 5e-4 relative, every new parameter within rtol 1e-3 and atol
2.5 x lr.  One Adam step moves an element by about lr either way
whatever its gradient, so the parameters cannot tell a wrong gradient:
the gradients themselves (the first Adam moments, gathered) and the new
BatchNorm statistics are held at ``tests/test_torch_train_step.py``'s
limits.  The gathered state's form (the whole parameters and moments
under the plain names, loadable in one process) is held too, and the
ranks' states agree bit for bit.

The JAX DP(4) x TP(2) step is not run here: the JAX package's own test
of it (``tests/test_parallel.py::test_dp_tp_train_step_matches_single_
device``, which holds it against the single-device step at the limits
above) takes 173 s and 16.8 GB of host memory alone, over a tenth of the
whole test run's time limit.  The port's single-process step is held
against the JAX package's in ``tests/test_torch_train_step.py``.
"""

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.config import default_config
from hiddenpose_tpu_torch.models.nlospose import NlosPose, build_nlospose
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
from torch_gloo import start_ranks
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE, B = 16, 4
LR = 1e-3


def _batch():
    rng = np.random.RandomState(410)
    h = SIZE // 2
    return {"meas": rng.rand(B, 1, SIZE, SIZE, SIZE).astype(np.float32),
            "vol": (rng.rand(B, 1, SIZE, SIZE, SIZE) > 0.5).astype(
                np.float32),
            "joints": (rng.rand(B, 72) * h).astype(np.float32),
            "joints_vis": np.ones((B, 72), np.float32)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_tp")
    cfg = default_config().tiny(SIZE)
    with torch.device("meta"):
        template = NlosPose(cfg.model)
    weights = peaked_state_dict(template, 1)
    torch.save(weights, tmp / "weights.pt")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    join = start_ranks("torch_parallel_workers:dp_step", 4, tmp,
                       args=[2, 2, SIZE, str(tmp / "weights.pt"),
                             str(tmp / "batch.npz")],
                       timeout=300, threads=1)
    model, lct = build_nlospose(cfg.model, device="cpu")
    model.load_state_dict(weights)
    single = TrainState.create(model, cfg.train)
    m = make_train_step(model)(single, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, lct)
    ranks = join()
    for f in ("weights.pt", "batch.npz"):
        (tmp / f).unlink()
    opt = single.optimizer.state
    return {"ranks": ranks, "loss": float(m["loss"]), "model": model,
            "state": single, "params": {n: p.detach().clone() for n, p in
                                        model.named_parameters()},
            "exp_avg": {n: opt[p]["exp_avg"].clone() for n, p in
                        model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def test_dp_tp_step_matches_one_process(steps):
    """Every rank's loss, and rank 0's new parameters (gathered whole),
    against the single-process step on the whole batch."""
    r0 = steps["ranks"][0]
    for r in steps["ranks"]:
        np.testing.assert_allclose(r["metrics"]["loss"], steps["loss"],
                                   rtol=5e-4)
    for n, p in steps["params"].items():
        np.testing.assert_allclose(r0["state_dict"][n].numpy(), p.numpy(),
                                   rtol=1e-3, atol=2.5 * LR, err_msg=n)


def test_dp_tp_checkpoint_is_whole(steps):
    """The gathered state and Adam moments have the plain model's names,
    shapes and parameter order, so they load into the single-process
    model and its optimizer (what a checkpoint of the run restores into),
    and every rank's state is rank 0's bit for bit."""
    model = steps["model"]
    r0 = steps["ranks"][0]
    assert r0["names"] == [n for n, _ in model.named_parameters()]
    model.load_state_dict(r0["state_dict"])  # strict: names and shapes
    for p, m in zip(model.parameters(), r0["exp_avg"]):
        assert m.shape == p.shape
    for r in steps["ranks"][1:]:
        assert r["digest"] == r0["digest"]
    assert steps["state"].optimizer.state  # the reference moved



def _rel_l2(a, b, keys):
    num = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2)
                      for k in keys))
    den = np.sqrt(sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys))
    return num / den


def test_dp_tp_gradients_match_one_process(steps):
    """The step's gradients, read from rank 0's gathered first Adam moments
    (0.1 x the gradient), against the single-process step's, at
    ``tests/test_torch_train_step.py``'s relative-L2 limits: 0.15 over
    all, 0.25 a module, and 0.25 over the weights sharded over 'model'
    (their backward is ``GatherReplicated``'s slice of the whole gradient,
    averaged over 'data' on the slices).  Readings: 0.056 over all,
    0.044-0.061 a module, 0.057 over the sharded weights (the largest
    per-tensor distances are biases that a BatchNorm follows, whose true
    gradient is 0).  A ``GatherReplicated.backward`` that returns zeros,
    always the first slice, or the slice negated reads 0.227 / 0.228 /
    0.445 over all; one that halves the slice fails the sharded weights'
    limit."""
    r0 = steps["ranks"][0]
    got = {n: m.numpy() for n, m in zip(r0["names"], r0["exp_avg"])}
    want = {n: m.numpy() for n, m in steps["exp_avg"].items()}
    assert got.keys() == want.keys()
    assert _rel_l2(got, want, want) < 0.15
    for module in ("feature_extraction", "autoencoder", "pose_net"):
        keys = [k for k in want if k.startswith(f"{module}.")]
        assert _rel_l2(got, want, keys) < 0.25, module
    tp = r0["tp_names"]
    assert len(tp) > 20  # the wide weights were sharded
    assert _rel_l2(got, want, tp) < 0.25


def test_dp_tp_batch_statistics_match_one_process(steps):
    """The new BatchNorm running statistics (the global batch's moments,
    all-reduced over 'data') against the single-process step's, at
    ``tests/test_torch_train_step.py``'s limit: 1e-3 of each tensor's
    largest magnitude."""
    sd, model = steps["ranks"][0]["state_dict"], steps["model"]
    stats = [n for n, _ in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for n in stats:
        want = steps["buffers"][n].numpy()
        np.testing.assert_allclose(sd[n].numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=n)
