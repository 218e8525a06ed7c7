"""Host ms the pump blocks on a batch's joints coming back to the host
(``serve.fetch``), mean over the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.host_ms(run, "serve.fetch")
