"""The port's batched-queue inference server
(``hiddenpose_tpu_torch/serve.py``), held to the JAX server's contract
(``tests/test_serve.py``) at tiny(16) on the CPU: per-request results are
identical to a direct forward however requests pack into batches, partial
batches flush padded, concurrent submitters all resolve, close() drains.
And on the same (bridged) weights the port's server returns the JAX
server's joints, within 1e-4 voxel (f32 on both sides).  These are the
float32 server's contract, so the servers here ask for ``dtype="float32"``
(both servers default to bf16: ``tests/test_torch_bf16_serve.py``).

Both servers run the port's peaked random weights
(``hiddenpose_tpu_torch.utils.peaked``): with the reference init every
joint sits at the volume centre whatever the network computes, so equal
joints would prove nothing.  Each comparison first checks that the joints
differ across requests by far more than its tolerance.
"""

import threading

import numpy as np
import pytest
import torch

from hiddenpose_tpu.config import default_config
from hiddenpose_tpu.serve import InferenceServer as JaxServer
from hiddenpose_tpu.utils.torch_import import convert_state_dict
from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.serve import InferenceServer
from hiddenpose_tpu_torch.train.step import make_forward
from hiddenpose_tpu_torch.utils.jax_bridge import state_dict_from_jax
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 16
CFG = default_config().tiny(SIZE)
# joints must differ across requests by this much, 1000x the tolerances
MIN_SPREAD = 0.1


def _meas(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(1, SIZE, SIZE, SIZE).astype(np.float32)


def _jax_variables():
    """The port's peaked weights in the JAX package's layout."""
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(CFG.model)
    sd = peaked_state_dict(template, seed=1)
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              strict=True)


def _spread(joints):
    """Largest difference of one joint coordinate across requests."""
    return float(np.ptp(np.stack(joints), axis=0).max())


@pytest.fixture(scope="module")
def server():
    srv = InferenceServer(CFG, state_dict_from_jax(_jax_variables()),
                          batch_size=4, dtype="float32", max_wait_ms=20.0,
                          device="cpu")
    yield srv
    srv.close()


def test_results_match_direct_forward(server):
    n = 7  # one full batch + a padded tail
    futs = [server.submit(_meas(i)) for i in range(n)]
    got = [f.result(timeout=300) for f in futs]
    assert _spread([g["joints"] for g in got]) > MIN_SPREAD
    fwd = make_forward(server.model)
    for i in range(n):
        joints, _ = fwd(torch.from_numpy(_meas(i)[None]), server.lct)
        want = joints[0].reshape(-1, 3).numpy()
        assert got[i]["joints"].shape == want.shape == (24, 3)
        np.testing.assert_allclose(got[i]["joints"], want, rtol=1e-5,
                                   atol=1e-5)


def test_partial_batch_flushes_and_pads(server):
    before = server.stats()
    out = server.infer(_meas(100))
    assert np.isfinite(out["joints"]).all()
    after = server.stats()
    assert after["batches"] >= before["batches"] + 1
    assert after["padded"] > before["padded"]
    assert 0.0 < after["mean_fill"] <= 1.0


def test_concurrent_submitters(server):
    results = {}

    def client(i):
        results[i] = server.infer(_meas(200 + i))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert len(results) == 6
    for i in range(6):
        assert np.isfinite(results[i]["joints"]).all()


def test_input_validation(server):
    with pytest.raises(ValueError):
        server.submit(np.zeros((2, SIZE, SIZE), np.float32))
    f = server.submit(np.zeros((SIZE, SIZE, SIZE), np.float32))
    assert f.result(timeout=300)["joints"].shape == (24, 3)


def test_close_drains_and_rejects():
    srv = InferenceServer(CFG, batch_size=2, max_wait_ms=1.0, rng_seed=7,
                          device="cpu")
    futs = [srv.submit(_meas(300 + i)) for i in range(3)]
    srv.close()
    for f in futs:
        assert np.isfinite(f.result(timeout=300)["joints"]).all()
    with pytest.raises(RuntimeError):
        srv.submit(_meas(0))
    srv.close()  # idempotent


def test_matches_jax_server_on_bridged_weights():
    """Peaked JAX weights -> bridge -> port server; both servers answer
    the same captures (5 requests at batch 2: a padded tail on both)."""
    variables = _jax_variables()
    meas = [_meas(400 + i) for i in range(5)]
    jsrv = JaxServer(CFG, variables, batch_size=2, dtype="float32",
                     max_wait_ms=1.0)
    psrv = InferenceServer(CFG, state_dict_from_jax(variables), batch_size=2,
                           dtype="float32", max_wait_ms=1.0, device="cpu")
    try:
        want = [f.result(timeout=300)["joints"]
                for f in [jsrv.submit(m) for m in meas]]
        got = [f.result(timeout=300)["joints"]
               for f in [psrv.submit(m) for m in meas]]
    finally:
        jsrv.close()
        psrv.close()
    assert _spread(want) > MIN_SPREAD
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-4)
