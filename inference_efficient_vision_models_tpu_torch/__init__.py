"""PyTorch/CUDA port of the inference-efficient vision models package.

The JAX package ``inference_efficient_vision_models_tpu`` stays the
reference; this package serves its static-INT8 ResNet artifacts on an NVIDIA
H100 with hand-written CUDA kernels (``ops/``, sources in ``csrc/``) and runs
every function on the CPU through the kernels' plain PyTorch versions.
It imports neither JAX nor the JAX package.
"""
