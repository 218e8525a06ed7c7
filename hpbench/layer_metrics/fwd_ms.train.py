"""Device ms of a train step's forward (the whole model's call; a
recompute in the backward calls only its parts)."""
from hpbench import readers


def prepare(run):
    readers.cuda_spans(run, run.model, run.model, "forward")


def read(run):
    return readers.span_ms(run, "forward")
