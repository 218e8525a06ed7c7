"""Share of the traced window that the device is idle while the pump
enqueues a batch's forward (idle gaps inside some ``serve.forward``
span), %."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.idle_in(run, ("serve.forward",))
