"""Where the tier-1 test run spends its time: each test file's summed time
and the slowest fixture setups, largest first.

    python scripts/torch_tier1_times.py               # this checkout
    python scripts/torch_tier1_times.py --root DIR    # another checkout

Runs the tier-1 command (ROADMAP.md: ``-m 'not slow'``, six xdist workers,
``--dist loadfile``, a 1470 s limit) from ``--root`` with
``--durations=0`` and a junit XML, then prints:

* the run's wall, exit code, counts and the load average before and after;
* every test file's summed time (setup, call and teardown of its cases;
  under ``--dist loadfile`` a file runs whole on one worker beside five
  others, so this is its wall under six concurrent pytest processes), its
  case count and its largest setup (where module fixtures are built),
  largest first, with ``OVER`` beside a file over 240 s;
* the 15 slowest setups and calls.

Run it before adding a slow fixture: no ``tests/test_torch_*`` file
should sum to more than 240 s, and the run should end well inside 850 s
on an 8-core machine.  The output stays in a temporary directory, whose
path is printed; the exit code is the run's own.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CEILING = 240.0  # seconds a test file may sum to
TOP = 15

_DURATION = re.compile(r"^\s*([0-9.]+)s\s+(setup|call|teardown)\s+(\S.*)$")


def command(xml: Path) -> list[str]:
    return ["timeout", "-k", "10", "1470", "env", "JAX_PLATFORMS=cpu",
            "ALLOW_MULTIPLE_LIBTPU_LOAD=1", sys.executable, "-m", "pytest",
            "tests/", "-q", "-m", "not slow",
            "--continue-on-collection-errors", "-p", "no:cacheprovider",
            "-p", "xdist", "-n", "6", "--dist", "loadfile",
            f"--junitxml={xml}", "-p", "no:randomly", "--durations=0"]


def test_file(classname: str, root: Path) -> str:
    """``tests.test_x.TestY`` -> ``tests/test_x.py`` (the longest prefix
    that is a file)."""
    parts = classname.split(".")
    for n in range(len(parts), 0, -1):
        path = "/".join(parts[:n]) + ".py"
        if (root / path).is_file():
            return path
    return classname


def read_xml(xml: Path, root: Path):
    """Per file: [summed seconds, cases]; and the suite's counts."""
    per_file = defaultdict(lambda: [0.0, 0])
    suite = ET.parse(xml).getroot()
    if suite.tag == "testsuites":
        suite = suite[0]
    for case in suite.iter("testcase"):
        entry = per_file[test_file(case.get("classname", ""), root)]
        entry[0] += float(case.get("time", 0.0))
        entry[1] += 1
    counts = {k: int(suite.get(k, 0))
              for k in ("tests", "errors", "failures", "skipped")}
    counts["passed"] = max(0, counts["tests"] - counts["errors"]
                           - counts["failures"] - counts["skipped"])
    return per_file, counts


def read_durations(log: Path):
    """``--durations=0`` lines: (seconds, phase, node id)."""
    rows = []
    for line in log.read_text(errors="replace").splitlines():
        m = _DURATION.match(line)
        if m:
            rows.append((float(m[1]), m[2], m[3].strip()))
    return rows


def report(xml: Path, log: Path, root: Path):
    per_file, counts = read_xml(xml, root)
    rows = read_durations(log)
    largest_setup = {}
    for sec, phase, node in rows:
        f = node.split("::")[0]
        if phase == "setup" and sec > largest_setup.get(f, (0.0, ""))[0]:
            largest_setup[f] = (sec, node)
    print(f"counts: {counts}")
    print(f"{'file':<48} {'cases':>5} {'summed s':>9}  largest setup")
    for f, (sec, n) in sorted(per_file.items(), key=lambda kv: -kv[1][0]):
        s_sec, s_node = largest_setup.get(f, (0.0, ""))
        setup = f"{s_sec:7.1f} s {s_node.split('::', 1)[-1]}" if s_node \
            else ""
        mark = "  OVER" if sec > CEILING else ""
        print(f"{f:<48} {n:>5} {sec:>9.1f}  {setup}{mark}")
    total = sum(v[0] for v in per_file.values())
    print(f"sum of all files {total:.1f} s; / 6 workers = {total / 6:.1f} s")
    for phase in ("setup", "call"):
        print(f"slowest {phase}s:")
        for sec, _, node in sorted((r for r in rows if r[1] == phase),
                                   reverse=True)[:TOP]:
            print(f"  {sec:8.2f} s  {node}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout to run in (default: this one)")
    root = ap.parse_args(argv).root.resolve()
    out = Path(tempfile.mkdtemp(prefix="tier1_times_"))
    xml, log = out / "run.xml", out / "run.log"
    print(f"load average before: {os.getloadavg()}; cores: "
          f"{os.cpu_count()}", flush=True)
    start = time.monotonic()
    with open(log, "wb") as fh:
        rc = subprocess.run(command(xml), cwd=root, stdout=fh,
                            stderr=subprocess.STDOUT).returncode
    print(f"wall {time.monotonic() - start:.1f} s, rc {rc}; load average "
          f"after: {os.getloadavg()}; output in {out}", flush=True)
    report(xml, log, root)
    return rc


if __name__ == "__main__":
    sys.exit(main())
