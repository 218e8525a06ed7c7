"""Run one benchmark cell once and print its result line.

    python3 -m hpbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program
(``hiddenpose_tpu_torch``) and ``BENCHMARK.json``.  Needs as many CUDA
devices as the cell asks for, and exits non-zero without a result where
there are fewer.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
with its limit; the same numbers are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def finite(x):
    """A number JSON can carry: a non-finite reading reads as 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from hpbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("hpbench: torch.cuda.is_available() is false; the benchmark "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"hpbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    from hpbench import program

    print(f"hpbench: the program's kernel library took "
          f"{program.build_seconds():.1f} s to build (0: it was built "
          "before)", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"hpbench: the run loaded {found}, which the benchmark of the "
              "port must not", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        c["value"], c["limit"] = finite(c["value"]), finite(c["limit"])
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
