"""The readers of the program's own spans (``spans.py`` and its
``layer_metrics/``) on the CPU: from a traced run of each cell at a small
size every host span reads a number, and a device span or an idle share
reads None (no GPU); a program without the span recorder reads None
everywhere and raises nothing; the idle-share arithmetic on a trace made
by hand."""

import types

import pytest

from hpbench import harness, spans
from hpbench.tests.conftest import small

SERVE, TRAIN = "serve-sat-nlospose-t128", "train-nlospose-t128"
HOST = {SERVE: ["queue_wait_ms.serve", "pack_ms.serve", "fwd_host_ms.serve",
                "fetch_wait_ms.serve"],
        TRAIN: ["fwd_host_ms.train", "bwd_host_ms.train",
                "adam_host_ms.train"]}
DEVICE = {SERVE: ["h2d_ms.serve", "recon_ms.serve", "unet_ms.serve",
                  "trunk_ms.serve", "head_ms.serve", "idle_in_pack.serve",
                  "idle_in_fwd_host.serve"],
          TRAIN: ["bwd_ms.train", "adam_ms.train"]}
SIZE = {SERVE: 16, TRAIN: 32}
# long enough that some request is both queued and taken inside the window
WINDOW = {SERVE: 1.5, TRAIN: 0.5}
CASES = [(c, n) for c in (SERVE, TRAIN) for n in HOST[c] + DEVICE[c]]


def traced_readings(cell):
    """{reader: value} of a traced CPU run of ``cell``, read after its
    window (the recorder is the program's, one a process: each run is read
    before the next starts)."""
    c = harness.resolve(cell)
    run = harness.Run(c, 2 ** 31 + 11, "cpu", True,
                      small(c.config, SIZE[cell]))
    c.generator.setup(run)
    try:
        for reader in c.readers.values():
            if hasattr(reader, "prepare"):
                reader.prepare(run)
        c.generator.window(run, WINDOW[cell])
        return {n: c.readers[n].read(run) for n in HOST[cell] + DEVICE[cell]}
    finally:
        c.generator.release(run)


@pytest.fixture(scope="module")
def readings():
    return {cell: traced_readings(cell) for cell in (SERVE, TRAIN)}


@pytest.mark.parametrize("cell,name", CASES)
def test_a_reader_reads_host_spans_and_no_device_span_on_the_cpu(
        readings, cell, name):
    v = readings[cell][name]
    if name in HOST[cell]:
        assert isinstance(v, float) and v > 0, (name, v)
    else:
        assert v is None, (name, v)


def test_every_new_reader_is_declared_for_its_cell():
    for cell in (SERVE, TRAIN):
        declared = set(harness.resolve(cell).readers)
        assert set(HOST[cell] + DEVICE[cell]) <= declared


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "trace_spans", lambda on: False)
    monkeypatch.setattr(spans, "take_spans", lambda: None)
    trace = types.SimpleNamespace(t0=0.0, t1=1.0, window_s=1.0, busy_s=0.5,
                                  idle_gaps=lambda: [(0.0, 0.5)])
    for cell, names in HOST.items():
        c = harness.resolve(cell)
        run = types.SimpleNamespace(trace=trace, note=lambda s: None)
        for name in names + DEVICE[cell]:
            reader = c.readers[name]
            reader.prepare(run)
            assert reader.read(run) is None, name


def record(name, start_s, end_s, ms=None):
    return types.SimpleNamespace(
        name=name, start_ns=int(start_s * 1e9), end_ns=int(end_s * 1e9),
        host_ms=(end_s - start_s) * 1e3, ms=ms)


def test_idle_shares_and_device_ms_on_a_trace_made_by_hand():
    # window 0-10 s, idle 1-3 and 6-7; packs 2-4 and 3.5-5, forward 6.5-9
    trace = types.SimpleNamespace(t0=0.0, t1=10.0, window_s=10.0,
                                  busy_s=7.0,
                                  idle_gaps=lambda: [(1.0, 3.0), (6.0, 7.0)])
    notes = []
    run = types.SimpleNamespace(trace=trace, note=notes.append)
    run.span_records = [record("serve.pack", 2, 4),
                        record("serve.pack", 3.5, 5),
                        record("serve.forward", 6.5, 9, ms=3.0),
                        record("serve.forward", 9, 9.5, ms=5.0)]
    assert spans.idle_in(run, ("serve.pack",)) == pytest.approx(10.0)
    assert spans.idle_in(run, ("serve.forward",)) == pytest.approx(5.0)
    assert spans.idle_in(run, spans.PUMP) == pytest.approx(15.0)
    assert spans.host_ms(run, "serve.pack") == pytest.approx(1750.0)
    assert spans.device_ms(run, "serve.forward") == pytest.approx(4.0)
    assert spans.device_ms(run, "serve.pack") is None
    spans.note_pump_idle(run)
    assert "any pump span 1.500000 s (50.00%)" in notes[-1]


def test_only_spans_inside_the_window_are_kept(monkeypatch):
    recs = [record("step.adam", 0.5, 1.5), record("step.adam", 1.0, 2.0),
            record("step.adam", 2.5, 3.5)]
    monkeypatch.setattr(spans, "take_spans", lambda: recs)
    monkeypatch.setattr(spans, "trace_spans", lambda on: True)
    trace = types.SimpleNamespace(t0=1.0, t1=3.0, window_s=2.0, busy_s=0.0)
    run = types.SimpleNamespace(trace=trace, note=lambda s: None)
    assert spans.window_records(run) == [recs[1]]
    assert spans.host_ms(run, "step.adam") == pytest.approx(1000.0)
