"""Host ms of a train step's forward and losses (``step.forward``), mean
over the window's steps."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "step.forward")
