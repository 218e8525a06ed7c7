"""Host ms a request waits in the server's queue, from ``submit()`` until the
pump takes it into a batch (``serve.queue``), mean over the window's
requests."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "serve.queue")
