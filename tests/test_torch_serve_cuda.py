"""The serving pump's fence on the GPU: each batch's fetch waits on its own
CUDA event, so the pump resolves batch N while batch N+1 still runs.

The test needs an NVIDIA GPU and skips without one.  It imports torch and
the port only (no jax), so on a GPU host it runs without the JAX
package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py

An f32 server at the t128 preset, batch 2, whose forward is slowed on the
device by ``torch.cuda._sleep``: two full batches are submitted, and the
first batch's futures must resolve while the second batch's event has not
passed.  Its answers match a direct forward within the CPU server test's
limits (cuDNN's transposed conv is not deterministic, so bits may
differ).
"""

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.config import t128_config
from hiddenpose_tpu_torch.models.nlospose import NlosPose
from hiddenpose_tpu_torch.serve import InferenceServer
from hiddenpose_tpu_torch.train.step import make_forward
from hiddenpose_tpu_torch.utils.peaked import peaked_state_dict
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

pytestmark = pytest.mark.cuda

B = 2
# device cycles each forward sleeps first: about a quarter of a second
SLEEP_CYCLES = 500_000_000
# joints must differ across requests by this much (as the CPU test)
MIN_SPREAD = 0.1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _meas(seed, size):
    rng = np.random.RandomState(seed)
    return rng.rand(1, size, size, size).astype(np.float32)


def test_a_batch_resolves_while_the_next_one_runs(dev):
    cfg = t128_config()
    size = cfg.model.time_size
    with torch.device("meta"):  # names and shapes only
        template = NlosPose(cfg.model)
    srv = InferenceServer(cfg, peaked_state_dict(template, seed=1),
                          batch_size=B, dtype="float32", max_wait_ms=1000.0,
                          device=dev)
    try:
        srv.warmup()
        forward, fence = srv._forward, srv._fence
        fences = []

        def slow(x, lct):
            torch.cuda._sleep(SLEEP_CYCLES)
            return forward(x, lct)

        def kept(joints):
            f = fence(joints)
            fences.append(f)
            return f

        srv._forward, srv._fence = slow, kept
        before = srv.stats()
        meas = [_meas(600 + i, size) for i in range(2 * B)]
        # for each answer of the first batch: had the second batch's
        # event passed when it came back?
        second_passed = []
        futs = []
        for i, m in enumerate(meas):
            f = srv.submit(m)
            if i < B:
                f.add_done_callback(
                    lambda _f: second_passed.append(fences[1][1].query()))
            futs.append(f)
        got = [f.result(timeout=300)["joints"] for f in futs]
        after = srv.stats()
    finally:
        srv.close()
    assert len(fences) == 2
    assert second_passed == [False] * B
    assert after["batches"] - before["batches"] == 2
    assert after["overlapped"] - before["overlapped"] >= 1
    assert float(np.ptp(np.stack(got), axis=0).max()) > MIN_SPREAD
    direct = make_forward(srv.model)
    for k in range(2):
        x = torch.from_numpy(np.stack(meas[k * B:(k + 1) * B])).to(dev)
        want = direct(x, srv.lct)[0].reshape(B, -1, 3).cpu().numpy()
        np.testing.assert_allclose(np.stack(got[k * B:(k + 1) * B]), want,
                                   rtol=1e-5, atol=1e-5)
