"""Time the four stem probes (``hiddenpose_tpu_torch/csrc/diag_probes.cu``)
of one or more checkouts of the port on one GPU, each checkout in a process
of its own, in the order given.

    python3 scripts/torch_probe_times.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one).  To compare a
parent with a change on one card, unpack the parent into a git-ignored
directory (``git archive PARENT | tar -x -C build/parent``) and give
``build/parent . . build/parent``.  Each probe (A ``hp_probe_im2col``, B
``hp_probe_slice_transpose``, C and C64 ``hp_probe_dot_f32``) is called
through the checkout's own wrapper on the probe script's inputs, and its
launch is timed with the arguments that wrapper gave its entry point
(:func:`recorded_launch`), whatever their form in that checkout.  A run
prints one JSON line with, for each probe:

* ``device_ms``: the kernel's device time, a CUDA graph of 50 launches
  replayed and timed with CUDA events, over 50 (median and range of 20
  replays): the launches' own gaps inside a graph, no host;
* ``launch_us_device`` / ``launch_us_stream``: the host's time a call of
  ``_build.launch`` with ``device=`` (the stream looked up by device
  index) and without it (``torch.cuda.current_stream()``), median of 5
  readings of 200 calls, then one synchronise;
* ``events_ms``: 50 launches back to back timed with CUDA events, over 50
  (what earlier runs of ``chip_smoke.py`` read as "the launch alone");
* ``bound_ms``: the bytes the probe must move over 3.35 TB/s, or its FLOP
  over 67 TFLOP/s (f32 FMA), whichever is larger;
* the largest error against the plain version, and whether two calls
  agree bit for bit;

and the card's name and power limit.  Exits non-zero when a probe
disagrees or a run fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

GRAPH_LAUNCHES = 50
READINGS = 20
HOST_CALLS = 200
HOST_READINGS = 5
BANDWIDTH = 3.35e12  # bytes/s, H100 SXM
PEAK_F32 = 67e12     # FLOP/s outside the tensor cores


def device_ms(launch, n=GRAPH_LAUNCHES, readings=READINGS):
    """(median, min, max) ms a launch: ``n`` launches captured into one
    CUDA graph, each replay timed with CUDA events."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reads = []
    for _ in range(readings):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        reads.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(reads)), min(reads), max(reads)


def host_us(launch, n=HOST_CALLS, readings=HOST_READINGS):
    """Median µs of host time a call over ``readings`` runs of ``n``."""
    import numpy as np
    import torch

    reads = []
    for _ in range(readings):
        launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            launch()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        reads.append((t1 - t0) / n * 1e6)
    return float(np.median(reads))


def events_ms(launch, n=GRAPH_LAUNCHES):
    import torch

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(moved, flop=0):
    """(ms, "bytes" or "operations"): the least time for ``moved`` bytes
    and ``flop`` f32 FMA operations."""
    by_bytes, by_ops = moved / BANDWIDTH * 1e3, flop / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def time_launch(entry, args, dev):
    """The timings above of one entry point's launch on ``args``."""
    from hiddenpose_tpu_torch.ops.kernels import _build

    def with_device():
        _build.launch(entry, *args, device=dev)

    def with_stream():
        _build.launch(entry, *args)

    med, lo, hi = device_ms(with_device)
    return dict(device_ms=med, device_ms_range=[lo, hi],
                launch_us_device=host_us(with_device),
                launch_us_stream=host_us(with_stream),
                events_ms=events_ms(with_device))


def recorded_launch(call):
    """``(entry, args, result)``: the one ``_build.launch`` that ``call()``
    (a probe's wrapper on CUDA inputs) makes, the arguments its wrapper
    gave the entry point, and the wrapper's result, which holds the
    outputs those arguments point to (keep it while they are used)."""
    from hiddenpose_tpu_torch.ops.kernels import _build

    seen = []
    real = _build.launch

    def spy(entry, *args, **kwargs):
        seen.append((entry, args))
        real(entry, *args, **kwargs)

    _build.launch = spy
    try:
        result = call()
    finally:
        _build.launch = real
    (entry, args), = seen
    return entry, args, result


def probe_calls(dev):
    """[(name, call, plain, tol, bytes, flop)] of the four probes on the
    probe script's inputs: the wrapper's call, its plain version, the
    largest error allowed (relative to the plain version's max for C), the
    bytes it must move and its FLOP."""
    import torch_diag_stem_paired as diag
    from hiddenpose_tpu_torch.ops.kernels import probes

    inp = diag.probe_inputs(dev)
    x, xb, a = inp["x_a"], inp["x_b"], inp["a"]
    out = [("PA", lambda: probes.probe_im2col(x),
            lambda: probes.probe_im2col_ref(x), 0.0,
            4 * (x.numel() + probes.ROWS * probes.NC * 128), 0),
           ("PB", lambda: probes.probe_slice_transpose(xb),
            lambda: probes.probe_slice_transpose_ref(xb), 0.0,
            2 * 4 * xb.numel(), 0)]
    for name, b in (("PC", inp["b"]), ("PC64", inp["b64"])):
        m, k = a.shape
        n = b.shape[1]
        out.append((name, lambda b=b: probes.probe_dot_f32(a, b),
                    lambda b=b: probes.probe_dot_f32_ref(a, b), 1e-5,
                    4 * (a.numel() + b.numel() + m * n), 2 * m * k * n))
    return out


def check(call, plain, relative):
    """(largest error against the plain version, over its max where
    ``relative``; two calls bit-identical)."""
    import torch

    want, got, again = plain(), call(), call()
    if isinstance(want, torch.Tensor):
        want, got, again = (want,), (got,), (again,)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if relative:
        err /= max(w.abs().max().item() for w in want)
    return err, all(torch.equal(g, h) for g, h in zip(got, again))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.insert(0, str(Path(root).resolve() / "scripts"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    res = dict(root=root, device=smi_line(), ok=True)
    for name, call, plain, tol, moved, flop in probe_calls(dev):
        err, repeat = check(call, plain, relative=tol > 0)
        entry, args, keep = recorded_launch(call)
        row = dict(max_err=err, tol=tol, two_calls_identical=repeat,
                   **time_launch(entry, args, dev))
        del keep
        row["bound_ms"], row["bound_by"] = bound(moved, flop)
        res[name] = row
        res["ok"] &= err <= tol and repeat
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        res = one(sys.argv[2])
        print(json.dumps(res), flush=True)
        return 0 if res["ok"] else 1
    roots = sys.argv[1:] or ["."]
    rc = 0
    for root in roots:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode:
            sys.stderr.write(p.stderr[-4000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
