"""Device ms a batch in FeatureExtraction, the LCT and normalisation
(``stage.recon``), mean over the window's batches."""
from hpbench import spans
from hpbench.spans import prepare  # noqa: F401


def read(run):
    return spans.device_ms(run, "stage.recon")
