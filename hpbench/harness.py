"""One run of one benchmark cell: resolve it by name, set up, measure a
window, read the per-layer metrics, check the outputs against the plain
reference, and build the result line.

Everything is found by name.  ``BENCHMARK.json`` (the checkout's root)
names the cell's configuration, its traffic mix and its metrics; then

* ``configs/<config>.json``: the configuration as it is run (the fields
  set on the program's ``ModelConfig`` and ``TrainConfig``, the
  architecture's fixed widths, the server's settings) and the limits of
  its correctness checks;
* ``traffic/<traffic>.json``: the mix's parameters, and the ``generator``
  (``generators/<generator>.py``) that reads them;
* ``layer_metrics/<metric>.py``: one reader per per-layer metric,
  ``read(run) -> value or None`` and optionally ``prepare(run)``, called
  before a traced window (to register hooks).

A generator module provides ``setup(run)``, ``window(run, seconds)``,
``release(run)`` and ``check(run)``; see ``generators/``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from hpbench import roofline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run must never load (the JAX package's name is
# compared whole: the program's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "hiddenpose_tpu")
TOP_OPS = 10
# idle gaps named by the host op beside them, longest first
GAPS_NAMED = 300
NAME_CHARS = 160


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    generator: ModuleType
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, ModuleType]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str) -> ModuleType:
    path = HERE / "layer_metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: "
                                f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"hpbench.layer_metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    generator = importlib.import_module(
        f"hpbench.generators.{traffic['generator']}")

    def listed(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) in (True, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if listed(m) or (listed(m) is None and m["moves"] in reported)]
    return Cell(name, int(w["chips"]), w["config"], config, traffic,
                generator, e2e, layer,
                {m["name"]: load_reader(m["name"]) for m in layer})


class Run:
    """What one run knows: the cell, the seed, the device, the program the
    generator built (``program``, ``model``), the window's readings
    (``window``), the trace (``trace``) and the checks (``checks``)."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool,
                 config: Optional[Dict[str, Any]] = None):
        self.cell, self.seed, self.trace_on = cell, int(seed), bool(trace)
        self.device = torch.device(device)
        self.config = config if config is not None else cell.config
        self.traffic = cell.traffic
        self.program = None
        self.model = None
        self.window: Dict[str, Any] = {}
        self.trace: Optional[Trace] = None
        self.checks: List[tuple] = []
        self.notes: List[str] = []
        self.calls_per_unit: List[roofline.Call] = []
        self.peak = "bf16"
        self._prof = None
        self._marker = None

    # -- the window's edges --------------------------------------------

    def open_window(self) -> None:
        """Start of the measured (or traced) window."""
        if self.trace_on:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._marker = record_function("hpbench.window")
            self._marker.__enter__()

    def close_window(self) -> None:
        """End of the window, after its work has finished on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self._prof is not None:
            self._marker.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.trace = Trace(self._prof)
            self._prof = self._marker = None

    def note(self, text: str) -> None:
        self.notes.append(text)
        print(f"[hpbench] {text}", file=sys.stderr, flush=True)


class Trace:
    """The profiler's events of one traced window, in seconds of the
    profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        self.cpu, self.device = [], []
        marker = None
        for e in events:
            row = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            if e.device_type() == DeviceType.CPU:
                if e.name() == "hpbench.window":
                    marker = row
                else:
                    self.cpu.append(row + (e.correlation_id(),))
            elif not (e.name() == "hpbench.window"
                      or e.is_user_annotation()):
                self.device.append(row + (e.linked_correlation_id(),))
        if marker is None:
            raise RuntimeError("the traced window's marker is missing")
        self.t0, self.t1 = marker[1], marker[2]
        self.window_s = self.t1 - self.t0
        self.device = [(n, max(s, self.t0), min(e, self.t1), c)
                       for n, s, e, c in self.device
                       if e > self.t0 and s < self.t1]
        self.busy_s = roofline.busy_seconds(
            (s, e) for _, s, e, _ in self.device)

    def launched_inside(self, names) -> list:
        """Device events of the kernels ``names`` whose launch the trace
        recorded (none launched before it opened); all of them where the
        trace links no launch to them."""
        mine = [ev for ev in self.device
                if roofline.kernel_name(ev[0]) in names]
        launches = {c for *_, c in self.cpu}
        linked = [ev for ev in mine if ev[3] in launches]
        return linked or mine

    def breakdown(self) -> Dict[str, list]:
        """The device ops that took most time, and the idle time of the
        window by the host op that overlapped most of each of its
        ``GAPS_NAMED`` longest gaps (the rest summed as one entry)."""
        import numpy as np

        by_op: Dict[str, float] = {}
        for n, s, e, _ in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        named: Dict[str, float] = {}
        if self.cpu:
            names = [n for n, *_ in self.cpu]
            start = np.array([s for _, s, _, _ in self.cpu])
            end = np.array([e for _, _, e, _ in self.cpu])
            for a, b in gaps[:GAPS_NAMED]:
                over = np.minimum(b, end) - np.maximum(a, start)
                best = over.max()
                if best <= 0:
                    name = "no host op"
                else:
                    tied = np.flatnonzero(over == best)
                    name = names[tied[np.argmin((end - start)[tied])]]
                named[name] = named.get(name, 0.0) + (b - a)
        rest = gaps[GAPS_NAMED:] if self.cpu else gaps
        if rest:
            named[f"{len(rest)} shorter gaps"] = sum(b - a for a, b in rest)
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": [[n[:NAME_CHARS], v] for n, v in idle]}

    def idle_gaps(self):
        """[start, end) spans of the window in which no device op ran."""
        gaps, cur = [], self.t0
        for s, e in sorted((s, e) for _, s, e, _ in self.device):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        return gaps


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def judge(checks, failed: int = 0) -> bool:
    """``correct``: something was compared, every number ((name, number,
    limit) in ``checks``) is finite and within its limit, and no request
    or step failed."""
    return bool(checks) and failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float,
             config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run; returns the result line's object.  ``config`` replaces the
    cell's configuration (the CPU tests run a small one)."""
    gen = cell.generator
    run = Run(cell, seed, device, trace, config)
    cuda = run.device.type == "cuda"
    gen.setup(run)
    setup_s = time.perf_counter() - t_start
    if trace:
        for reader in cell.readers.values():
            if hasattr(reader, "prepare"):
                reader.prepare(run)
    gen.window(run, seconds)
    peak_bytes = (max(getattr(run, "setup_peak", 0),
                      torch.cuda.max_memory_allocated()) if cuda else 0)
    values = dict(run.window.get("values", {}), setup_s=setup_s)
    if trace:
        layer = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run)
            if v is None:
                run.note(f"{m['name']}: nothing to read in this run")
            else:
                layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
        metrics = layer
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the generator gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    gen.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.checks = gen.check(run)
    correct = judge(run.checks, run.window.get("failed", 0))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak_bytes)}
    if cuda:
        dev["name_power_limit"] = power_limit()
    line = {"correct": correct,
            "attempted": int(run.window.get("attempted", 0)),
            "failed": int(run.window.get("failed", 0)),
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in run.checks}
    return line
