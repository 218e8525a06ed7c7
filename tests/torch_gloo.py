"""Run a function of the port on ``n`` gloo ranks, each a subprocess on
the CPU with a time limit, for the multi-rank tests.

    results = run_ranks("torch_parallel_workers:lct_sharded", 2, tmp_path,
                        args=[...])

(``start_ranks`` starts the job and returns the function that waits for
it.)
Each rank joins a gloo job over localhost, calls ``module:function(*args)``
(``module`` importable from ``tests/``) and saves what it returns with
``torch.save``; ``run_ranks`` returns the n results in rank order and
deletes their files.  A rank
that fails, or a job that outlives ``timeout`` seconds, fails the test
with every rank's output (the ranks left are killed).  The ranks import
torch and the port only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

from hiddenpose_tpu_torch.parallel.distributed import free_port  # noqa: F401

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def rank_env(threads: int = 1) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS), str(REPO)] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def wait_all(procs, timeout: float):
    """Wait for every process; kill them all if any is left at the time
    limit.  Returns their outputs."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rest = [p.communicate()[0].decode(errors="replace") for p in procs]
        raise AssertionError(f"ranks still running after {timeout} s:\n"
                             + "\n".join(rest))
    return outs


def start_ranks(target: str, n: int, tmp_path, args=(),
                timeout: float = 120, threads: int = 1):
    """Start the job; returns a function that waits for it and returns the
    ranks' results (so that the test can work while the ranks run)."""
    import torch

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_gloo.py"), target, str(r),
         str(n), str(port), str(tmp_path), json.dumps(list(args))],
        env=rank_env(threads), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=str(TESTS)) for r in range(n)]
    start = time.monotonic()

    def join():
        outs = wait_all(procs, timeout - (time.monotonic() - start))
        assert all(p.returncode == 0 for p in procs), "\n".join(
            f"--- rank {r} (rc {p.returncode}):\n{o}"
            for r, (p, o) in enumerate(zip(procs, outs)))
        return [load_and_delete(Path(tmp_path) / f"rank{r}.pt")
                for r in range(n)]

    return join


def load_and_delete(path):
    """A rank's result, its file deleted (a full-width model's state is
    hundreds of MB, and the test runs share one disk)."""
    import torch

    try:
        return torch.load(path, weights_only=False)
    finally:
        Path(path).unlink()


def run_ranks(target: str, n: int, tmp_path, args=(), timeout: float = 120,
              threads: int = 1):
    return start_ranks(target, n, tmp_path, args, timeout, threads)()


def _main(target, rank, world, port, outdir, args):
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        module, fn = target.split(":")
        result = getattr(importlib.import_module(module), fn)(*args)
        torch.save(result, Path(outdir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
          sys.argv[5], json.loads(sys.argv[6]))
