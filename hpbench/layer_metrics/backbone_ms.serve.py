"""Device ms a batch in the pose backbone (``model.pose_net``)."""
from hpbench import readers


def prepare(run):
    readers.cuda_spans(run, run.model.pose_net, run.model.pose_net,
                       "backbone")


def read(run):
    return readers.span_ms(run, "backbone")
