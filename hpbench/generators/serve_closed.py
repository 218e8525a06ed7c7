"""Closed-loop serving: ``clients`` callers, each sending its next capture
as soon as its last answer comes back, so the server always has work
queued.

The window opens once ``2 x batch`` answers have come back (the pipeline
is full) and lasts ``seconds``.  ``serve_captures_per_s`` is the answers
that came back inside the window over its length.  Every answer of the
run is checked.  Traffic file: ``{"generator": "serve_closed", "clients":
n, "pool": n}``.
"""

from __future__ import annotations

import time

from hpbench.generators import serving

setup = serving.setup
release = serving.release


def window(run, seconds: float) -> None:
    stop = []

    def again(req):
        if not stop:
            reqs.submit()

    reqs = serving.Requests(run.program, run.pool, run.order, again)
    for _ in range(int(run.traffic["clients"])):
        reqs.submit()
    reqs.wait_answered(2 * run.batch_size, 600)
    run.open_window()
    serving.snapshot(run, "open")
    t0 = time.perf_counter()
    time.sleep(seconds)
    t1 = time.perf_counter()
    serving.snapshot(run, "close")
    stop.append(True)
    reqs.wait_all(serving.LATE_S)
    serving.snapshot(run, "end")
    run.close_window()
    done = [r for r in reqs.all if r.done is not None and t0 <= r.done < t1]
    sent = [r for r in reqs.all if t0 <= r.sent < t1]
    run.requests = reqs.all
    run.window.update(
        values={"serve_captures_per_s": len(done) / (t1 - t0)},
        seconds=t1 - t0, units=len(done), attempted=len(sent),
        failed=sum(r.error is not None or r.done is None for r in sent))


def check(run) -> list:
    return serving.check(run, run.requests)
