"""hiddenpose_tpu_torch: the HiddenPose inference path in PyTorch and CUDA.

A port of ``hiddenpose_tpu`` (JAX, the reference) for one NVIDIA H100:
measurement -> FeatureExtraction -> LCT -> normalize -> UNet3d ->
PoseNet3D -> soft-argmax joints, served through
:class:`hiddenpose_tpu_torch.serve.InferenceServer`.  Imports torch, never
jax; the four hot kernels are hand-written CUDA under ``csrc/``.
"""
