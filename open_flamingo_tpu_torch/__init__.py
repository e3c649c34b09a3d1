"""PyTorch + CUDA port of open_flamingo_tpu for NVIDIA Hopper.

The JAX package `open_flamingo_tpu` is the reference; this package mirrors
its module names and imports nothing from it. Attention on the serving
path runs through hand-written CUDA kernels (`ops/`, sources in `csrc/`)
on CUDA tensors and through their plain PyTorch versions on CPU tensors.
"""
