"""Device ms of a batch's host-to-device copy (``serve.h2d``), mean over
the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.device_ms(run, "serve.h2d")
