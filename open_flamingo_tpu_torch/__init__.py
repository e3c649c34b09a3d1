"""PyTorch + CUDA port of open_flamingo_tpu for NVIDIA Hopper.

The JAX package `open_flamingo_tpu` is the reference; this package mirrors
its module names and imports nothing from it. Attention on the serving
path runs through hand-written CUDA kernels (`ops/`, sources in `csrc/`)
on CUDA tensors and through their plain PyTorch versions on CPU tensors.
`create_model_and_transforms` (the reference's entry point) is imported on
first use, so that importing the package stays cheap.
"""


def __getattr__(name):
    if name == "create_model_and_transforms":
        from .factory import create_model_and_transforms

        return create_model_and_transforms
    raise AttributeError(name)
