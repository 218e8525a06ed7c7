"""The steps the window ran, at the plain reference's FLOP a step, over
the window's seconds, as a share of the TF32 peak, %."""
from hpbench import readers
from hpbench.generators import train_steps


def read(run):
    return readers.mfu(run, train_steps.flop_per_step(run))
