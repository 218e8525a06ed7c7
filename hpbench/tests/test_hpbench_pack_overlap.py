"""``pack_overlap.serve`` on the CPU: the reader's arithmetic on window
snapshots made by hand, None for a server without the ``overlapped``
counter or a window without batches, and a closed-loop window at a small
size: 0% on a CPU server (no fence), and every batch of the window
counted where stand-in fences report that the previous batch still
runs."""

import pytest

from hpbench import harness
from hpbench.tests.conftest import small

SERVE = "serve-sat-nlospose-t128"
NAME = "pack_overlap.serve"


def reader():
    return harness.resolve(SERVE).readers[NAME]


class Snap:
    def __init__(self, open_stats, close_stats):
        self.window = {"open": {"stats": open_stats},
                       "close": {"stats": close_stats}}


@pytest.mark.parametrize("open_stats,close_stats,want", [
    (dict(batches=2, overlapped=1), dict(batches=102, overlapped=91), 90.0),
    (dict(batches=5, overlapped=4), dict(batches=9, overlapped=8), 100.0),
    (dict(batches=2, overlapped=0), dict(batches=12, overlapped=0), 0.0),
    # the parent's server keeps no such counter
    (dict(batches=2), dict(batches=12), None),
    (dict(batches=7, overlapped=6), dict(batches=7, overlapped=6), None),
])
def test_the_share_over_the_windows_batches(open_stats, close_stats, want):
    got = reader().read(Snap(open_stats, close_stats))
    assert got == (None if want is None else pytest.approx(want))


def closed_loop_reading(seconds=1.5):
    c = harness.resolve(SERVE)
    run = harness.Run(c, 2 ** 31 + 13, "cpu", False, small(c.config, 16))
    c.generator.setup(run)
    try:
        c.generator.window(run, seconds)
        return c.readers[NAME].read(run), run.window
    finally:
        c.generator.release(run)


def test_a_cpu_server_overlaps_nothing():
    got, window = closed_loop_reading()
    assert window["close"]["stats"]["batches"] > \
        window["open"]["stats"]["batches"]
    assert got == 0.0


def test_stand_in_fences_that_have_not_passed_read_every_batch(monkeypatch):
    from hiddenpose_tpu_torch.serve import InferenceServer

    class Running:
        def query(self):
            return False

        def synchronize(self):
            pass

    monkeypatch.setattr(InferenceServer, "_fence",
                        lambda self, joints: (joints.clone(), Running()))
    got, _ = closed_loop_reading()
    assert got == pytest.approx(100.0)
