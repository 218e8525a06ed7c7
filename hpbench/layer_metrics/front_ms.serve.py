"""Device ms a batch from FeatureExtraction's start to the UNet's end
(FeatureExtraction, the LCT, normalisation, the UNet)."""
from hpbench import readers


def prepare(run):
    readers.cuda_spans(run, run.model.feature_extraction,
                       run.model.autoencoder, "front")


def read(run):
    return readers.span_ms(run, "front")
