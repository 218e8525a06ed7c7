"""Physics layer, normalisation, soft-argmax and the CUDA kernels."""
