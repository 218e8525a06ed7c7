"""Cap the CPU threads of a pytest process that runs the port's tests.

The tier-1 command runs six pytest-xdist workers on one machine.  Left at
torch's default, each worker's OpenMP pool is as wide as the machine, and
six such pools spin against each other: a tiny(16) train step that ends
in about 25 s with one thread a worker did not end in 300 s with eight.
So every ``tests/test_torch_*.py`` module imports this one, whose first
import calls ``cap()``.  pytest-xdist imports every test module on every
worker when it collects, so the cap holds for the whole worker process,
whichever files it then runs (the JAX package's included).

The cap is the worker's share of the cores, ``os.cpu_count() //
PYTEST_XDIST_WORKER_COUNT`` (one process without xdist keeps them all),
and never more than the process already had.  It is also written to
``OMP_NUM_THREADS``, so that the commands a test starts as processes
inherit it (gloo ranks set their own, ``tests/torch_gloo.py``).
"""

from __future__ import annotations

import contextlib
import os

import torch


# torch's intra-op threads before the cap (its default: the OpenMP
# pool's width, or OMP_NUM_THREADS)
BEFORE = torch.get_num_threads()


def cap():
    """Cap torch's intra-op threads, and the children's, at this worker's
    share of the cores."""
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    n = min(max(1, (os.cpu_count() or 1) // workers), BEFORE)
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)


@contextlib.contextmanager
def fixed(n: int):
    """Run a block at ``n`` intra-op threads, whatever the worker count.
    torch's CPU sums take an order, and some kernels a path, that depend
    on the thread count; a reading that must not move with the number of
    workers takes a fixed count (``BEFORE``: the arithmetic of a process
    without the cap)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


cap()
