"""Host ms of a train step's ``loss.backward()`` (``step.backward``), mean
over the window's steps."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "step.backward")
