"""What the readers of the program's own spans (``layer_metrics/``) share.

The program records spans itself (``hiddenpose_tpu_torch/utils/tracing.py``)
when its recorder is on: ``prepare`` turns it on before the traced window.
Host times are on ``time.time_ns()``'s clock, the one the profiler stamps
its events with, so a span is kept where its host span lies inside the
profiler's window marker.  Each reader returns None where the run holds
nothing to read: a program without the recorder, no span of the name in
the window, or a device span on a run without a GPU.
"""

from __future__ import annotations

import numpy as np


def trace_spans(on: bool) -> bool:
    """Turn the program's span recorder on or off; False where the program
    has none."""
    try:
        from hiddenpose_tpu_torch.utils import tracing
    except ImportError:
        return False
    (tracing.enable if on else tracing.disable)()
    return True


def take_spans():
    """The program's span records, each device span resolved to ms, and
    the recorder emptied; None where the program has no recorder."""
    try:
        from hiddenpose_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.take()


def prepare(run) -> None:
    trace_spans(True)


def window_records(run):
    """The program's records whose host span lies inside the traced
    window, taken from the program once a run and kept on ``run``; None
    where the program keeps none."""
    if not hasattr(run, "span_records"):
        recs = take_spans()
        trace_spans(False)
        if recs is None or run.trace is None:
            run.span_records = None
        else:
            t0, t1 = run.trace.t0 * 1e9, run.trace.t1 * 1e9
            run.span_records = [r for r in recs
                                if t0 <= r.start_ns and r.end_ns <= t1]
            counts = {}
            for r in run.span_records:
                counts[r.name] = counts.get(r.name, 0) + 1
            run.note(f"program spans in the window: {counts} "
                     f"(of {len(recs)} recorded)")
    return run.span_records


def named(run, name: str) -> list:
    return [r for r in window_records(run) or () if r.name == name]


def host_ms(run, name: str):
    """Mean host ms of the window's ``name`` spans."""
    recs = named(run, name)
    return float(np.mean([r.host_ms for r in recs])) if recs else None


def device_ms(run, name: str):
    """Mean device ms of the window's ``name`` spans."""
    ms = [r.ms for r in named(run, name) if r.ms is not None]
    return float(np.mean(ms)) if ms else None


def union(intervals) -> list:
    """The union of [start, end) ``intervals`` as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_s(a, b) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_s(run, names):
    """Seconds of the traced window's idle gaps (no device op) that some
    host span of ``names`` covers; None without device ops or spans."""
    t = run.trace
    recs = [r for n in names for r in named(run, n)]
    if t is None or t.busy_s <= 0 or not recs:
        return None
    spans = union((r.start_ns * 1e-9, r.end_ns * 1e-9) for r in recs)
    return overlap_s(t.idle_gaps(), spans)


def idle_in(run, names):
    """``idle_in_s`` as a share of the window's wall time, %."""
    s = idle_in_s(run, names)
    return None if s is None else 100.0 * s / run.trace.window_s


PUMP = ("serve.pack", "serve.forward", "serve.fetch")


def note_pump_idle(run) -> None:
    """Note what share of the window's idle time each pump span, and any
    of them, covers."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return
    idle = t.window_s - t.busy_s
    parts = {n: idle_in_s(run, (n,)) for n in PUMP}
    parts["any pump span"] = idle_in_s(run, PUMP)
    run.note(f"idle {idle:.6f} s of {t.window_s:.6f}; inside: " + ", ".join(
        f"{n} {v:.6f} s ({100 * v / idle:.2f}%)" for n, v in parts.items()
        if v is not None))
