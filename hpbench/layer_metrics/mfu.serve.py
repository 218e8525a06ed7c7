"""The captures the window answered, at the plain reference's FLOP a
capture, over the window's seconds, as a share of the bf16 peak, %."""
from hpbench import readers
from hpbench.generators import serving


def read(run):
    return readers.mfu(run, serving.flop_per_capture(run))
