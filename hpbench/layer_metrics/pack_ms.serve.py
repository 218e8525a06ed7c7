"""Host ms the pump takes to pack a batch: stack, cast, pin and the enqueue
of the host-to-device copy (``serve.pack``), mean over the window's
batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "serve.pack")
