"""Host ms the pump takes to enqueue a batch's forward (``serve.forward``),
mean over the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "serve.forward")
