"""What the per-layer metric readers (``layer_metrics/``) share.  Each
returns None where the run holds nothing to read."""

from __future__ import annotations

import numpy as np
import torch

from hpbench import roofline


def cuda_spans(run, start_module, end_module, key: str) -> None:
    """Record a CUDA event pair on every call, from the start of
    ``start_module``'s forward to the end of ``end_module``'s, into
    ``run.spans[key]``: device time of that stretch of the forward."""
    spans = run.__dict__.setdefault("spans", {}).setdefault(key, [])
    if run.device.type != "cuda":
        return

    def pre(mod, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans.append([ev, None])

    def post(mod, args, out):
        if spans and spans[-1][1] is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[-1][1] = ev

    start_module.register_forward_pre_hook(pre)
    end_module.register_forward_hook(post)


def span_ms(run, key: str):
    """Mean ms of the complete spans ``key`` recorded in the window."""
    spans = [s for s in getattr(run, "spans", {}).get(key, [])
             if s[1] is not None]
    if not spans:
        return None
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in spans]))


def batch_fill(run):
    """Requests over the slots of the batches run in the window, %."""
    a, b = run.window["open"]["stats"], run.window["close"]["stats"]
    batches = b["batches"] - a["batches"]
    if batches <= 0:
        return None
    return 100.0 * (b["requests"] - a["requests"]) / (
        batches * run.batch_size)


def device_idle(run):
    """The traced window's share of wall time with no device op, %."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernels_roofline(run):
    """The program's kernels' summed bound over their summed device time,
    %: every launch of the traced window, bounded by the table of
    ``roofline`` at the configuration's shapes.  None unless the launches
    counted are whole units of that table."""
    t = run.trace
    if t is None or not run.calls_per_unit:
        return None
    per_unit, bound = roofline.per_unit(run.calls_per_unit)
    a, b = run.window["open"]["launches"], run.window["end"]["launches"]
    delta = {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}
    units = {k: delta.get(k, 0) / n for k, n in per_unit.items()}
    if (set(delta) - set(per_unit) or not units
            or max(units.values()) - min(units.values()) > 1.0
            or min(units.values()) <= 0):
        run.note(f"kernel launches {delta} are not whole units of "
                 f"{per_unit}: no roofline")
        return None
    want = sum(delta[k] * bound[k] / per_unit[k] for k in per_unit)
    events = t.launched_inside(roofline.PROGRAM_KERNELS)
    took = sum(e - s for _, s, e, _ in events)
    if took <= 0:
        return None
    run.note(f"kernels: {len(events)} device launches, {took:.6f} s, "
             f"bound {want:.6f} s; launches {delta}")
    return 100.0 * want / took


def mfu(run, flop_per_unit: int):
    """FLOP of the work the window finished over its seconds, as a share
    of the peak of the configuration's type, %."""
    units, secs = run.window.get("units", 0), run.window.get("seconds")
    if not units or not secs:
        return None
    run.note(f"{flop_per_unit} FLOP a unit ({run.peak} peak "
             f"{roofline.PEAK[run.peak]:.3e} FLOP/s), {units} units in "
             f"{secs:.3f} s")
    return 100.0 * flop_per_unit * units / secs / roofline.PEAK[run.peak]
