"""The port's span recorder (``hiddenpose_tpu_torch/utils/tracing.py``) on
the CPU, at tiny(16): off, a served burst and a train step leave no record
and make no CUDA event, and give the same bits as with it on; on, every
request of a burst has its queue span, whose batch has its pump spans and
its device stages, and a train step records its forward, backward and
Adam in order and no stage; a span starts within microseconds of a
``torch.profiler`` event opened with it (the shared clock); device spans
resolve to ms through CUDA events (replaced here by a stand-in)."""

import statistics
import time

import numpy as np
import pytest
import torch

from hiddenpose_tpu_torch.config import Config
from hiddenpose_tpu_torch.data.synthetic import make_batch
from hiddenpose_tpu_torch.models.nlospose import build_nlospose
from hiddenpose_tpu_torch.serve import InferenceServer
from hiddenpose_tpu_torch.train.state import TrainState
from hiddenpose_tpu_torch.train.step import make_train_step
from hiddenpose_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

SIZE = 16
CFG = Config().tiny(SIZE)
BATCH = 4
# one full batch and a padded tail
BURST = 7
PUMP = ("serve.pack", "serve.h2d", "serve.forward", "serve.fetch")
STAGES = ("stage.recon", "stage.unet", "stage.trunk", "stage.head")
STEP = ("step.forward", "step.backward", "step.adam")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


class NoEvent:
    def __init__(self, *a, **k):
        raise AssertionError("a CUDA event was made with tracing off")


class FakeEvent:
    """A CUDA event's stand-in: ``record()`` reads the host clock."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _meas(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(1, SIZE, SIZE, SIZE).astype(np.float32)


@pytest.fixture(scope="module")
def server():
    # a long wait, so the burst packs the same way every time: the first
    # BATCH requests, then the rest padded
    srv = InferenceServer(CFG, batch_size=BATCH, dtype="float32",
                          max_wait_ms=2000.0, rng_seed=3, device="cpu")
    yield srv
    srv.close()


def _burst(server):
    futs = [server.submit(_meas(i)) for i in range(BURST)]
    return np.stack([f.result(timeout=300)["joints"] for f in futs])


def _train_step():
    """Losses and parameters after one step from seeded weights."""
    model, lct = build_nlospose(CFG.model, device="cpu", seed=5)
    state = TrainState.create(model, CFG.train)
    step = make_train_step(model, CFG.train.matmul_precision)
    m = CFG.model
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        [0, 1], m.time_size, m.image_size[0], m.grid_dim,
        m.heatmap_size[0], m.bin_len).items()}
    with torch_threads.fixed(1):
        out = step(state, batch, lct)
    return ({k: v.clone() for k, v in out.items()},
            [p.detach().clone() for p in model.parameters()])


def _assert_same_step(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


def test_off_records_nothing_and_changes_no_bit(server, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", NoEvent)
    joints_off = _burst(server)
    step_off = _train_step()
    assert tracing.take() == []
    monkeypatch.undo()
    tracing.enable()
    joints_on = _burst(server)
    step_on = _train_step()
    tracing.disable()
    recs = tracing.take()
    assert {"serve.queue", "step.adam"} <= {r.name for r in recs}
    assert np.array_equal(joints_off, joints_on)
    _assert_same_step(step_off, step_on)


def test_off_span_sites_make_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", NoEvent)
    a = tracing.span("serve.pack", 1, device=True)
    assert a is tracing.span("step.adam", 2, device=True, stages=True)
    with a:
        tracing.stage("stage.recon")
        tracing.stage(None)
    tracing.record("serve.queue", 0, 1, id=1)
    assert tracing.new_id() == 0 and tracing.take() == []


def test_on_every_request_has_a_queue_span_and_its_batch(server):
    tracing.enable()
    _burst(server)
    tracing.disable()
    recs = tracing.take()
    queue = [r for r in recs if r.name == "serve.queue"]
    assert len(queue) == BURST
    assert len({r.id for r in queue}) == BURST
    batches = {}
    for r in recs:
        if r.name != "serve.queue":
            batches.setdefault(r.id, {}).setdefault(r.name, []).append(r)
    assert len({r.parent for r in queue}) == 2      # a full batch, a tail
    for q in queue:
        spans = batches[q.parent]
        for name in PUMP + STAGES:
            assert len(spans[name]) == 1, (name, spans)
        assert q.end_ns <= spans["serve.pack"][0].start_ns
        assert q.start_ns <= q.end_ns
    for spans in batches.values():
        assert set(spans) == set(PUMP + STAGES)
        order = [spans[n][0] for n in ("serve.pack", "serve.forward",
                                       "serve.fetch")]
        assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
        stages = [spans[n][0] for n in STAGES]
        assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
        fwd = spans["serve.forward"][0]
        assert fwd.start_ns <= stages[0].start_ns
        assert stages[-1].end_ns <= fwd.end_ns
        # a CPU server records host times only
        assert all(s[0].ms is None for s in spans.values())
        assert {s[0].thread for s in spans.values()} == {"hp-serve-pump"}


def test_a_train_step_records_its_three_spans_in_order():
    tracing.enable()
    _train_step()
    tracing.disable()
    recs = tracing.take()
    assert [r.name for r in recs] == list(STEP)
    assert len({r.id for r in recs}) == 1 and recs[0].id > 0
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))
    assert all(r.host_ms > 0 for r in recs)


def test_device_spans_resolve_to_ms(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    FakeEvent.made = 0
    tracing.enable()
    with tracing.span("serve.forward", 7, device=True, stages=True):
        tracing.stage("stage.recon")
        time.sleep(0.002)
        tracing.stage("stage.unet")
        time.sleep(0.002)
        tracing.stage(None)
    # outside a forward's scope a stage records nothing
    tracing.stage("stage.trunk")
    recs = tracing.take()
    assert [r.name for r in recs] == ["stage.recon", "stage.unet",
                                      "serve.forward"]
    # two for the forward, one at each stage boundary
    assert FakeEvent.made == 5
    recon, unet, fwd = recs
    assert recon.ms >= 2.0 and unet.ms >= 2.0
    assert fwd.ms >= recon.ms + unet.ms
    assert all(r.id == 7 and r.events is None for r in recs)


def test_spans_share_the_profilers_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(21):
            with record_function(f"clock.{i}"), tracing.span("clock", i):
                time.sleep(0.005)
    tracing.disable()
    mine = {r.id: r.start_ns for r in tracing.take()}
    theirs = {int(e.name().split(".")[1]): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.name().startswith("clock.")}
    assert set(mine) == set(theirs) == set(range(21))
    # the first pair warms up; the gaps are in ns
    gaps = [abs(mine[i] - theirs[i]) for i in range(1, 21)]
    assert statistics.median(gaps) < 50_000, gaps
    assert max(gaps) < 500_000, gaps
