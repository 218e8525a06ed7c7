"""Device ms a batch in the deconv head through the soft-argmax's joints
(``stage.head``), mean over the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.device_ms(run, "stage.head")
