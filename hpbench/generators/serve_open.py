"""Open-loop serving: captures arrive on a schedule, whatever the server's
state, as from independent capture rigs.

The schedule is the same for every seed: the quantiles (i + 0.5) / n of
an exponential of mean 1 / ``rate_per_s`` (Poisson arrivals) as gaps, in
an order fixed by the mix's ``arrival_seed``; the run's seed draws the
weights, the captures and the order in which they are sent.  Arrivals
start ``lead_s`` before the window; ``serve_p95_ms`` is the 95th
percentile (nearest rank) of the latency of every request due inside the
window, each timed from when it was due to when its answer came back; an
answer that never comes, or fails, counts as infinitely late.  How late
the sender ran is noted.  Traffic file: ``{"generator": "serve_open",
"rate_per_s": r, "lead_s": s, "arrival_seed": n, "pool": n}``.
"""

from __future__ import annotations

import math
import time

import numpy as np

from hpbench.generators import serving

setup = serving.setup
release = serving.release


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival offsets (s) covering ``seconds`` at ``rate`` per second."""
    n = int(math.ceil(rate * seconds * 1.2)) + 16
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(np.random.RandomState(seed).permutation(gaps))


def p95(latencies) -> float:
    xs = sorted(latencies)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def window(run, seconds: float) -> None:
    rate = float(run.traffic["rate_per_s"])
    lead = float(run.traffic["lead_s"])
    offsets = schedule(rate, lead + seconds,
                       int(run.traffic["arrival_seed"]))
    reqs = serving.Requests(run.program, run.pool, run.order)
    # a traced window opens before the lead-in: starting the profiler
    # stalls this thread, which must not delay the sends
    run.open_window()
    start = time.perf_counter() + 0.05
    t0, t1 = start + lead, start + lead + seconds
    opened = False
    late = []
    for off in offsets:
        due = start + off
        if due >= t1:
            break
        if not opened and due >= t0:
            serving.snapshot(run, "open")
            opened = True
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        req = reqs.submit(due)
        late.append(req.sent - due)
    left = t1 - time.perf_counter()
    if left > 0:
        time.sleep(left)
    serving.snapshot(run, "close")
    reqs.wait_all(serving.LATE_S)
    serving.snapshot(run, "end")
    run.close_window()
    due = [r for r in reqs.all if t0 <= r.due < t1]
    lat = [(r.done - r.due) * 1e3 if r.error is None and r.done is not None
           else math.inf for r in due]
    run.requests = reqs.all
    run.note(f"sender late: max {max(late) * 1e3:.3f} ms, mean "
             f"{np.mean(late) * 1e3:.3f} ms over {len(late)} sends; "
             f"{len(due)} requests due in the window")
    run.window.update(
        values={"serve_p95_ms": p95(lat)}, seconds=seconds,
        units=sum(1 for r in reqs.all if r.done is not None
                  and t0 <= r.done < t1 and r.error is None),
        attempted=len(due), failed=sum(math.isinf(x) for x in lat))


def check(run) -> list:
    return serving.check(run, run.requests)
