"""Device ms a batch in PoseNet3D's stem and layer1-4 (``stage.trunk``),
mean over the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.device_ms(run, "stage.trunk")
