"""Share of the traced window that the device is idle while the pump packs
a batch (idle gaps inside some ``serve.pack`` span), %."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    spans.note_pump_idle(run)
    return spans.idle_in(run, ("serve.pack",))
