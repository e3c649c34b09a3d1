"""PyTorch + CUDA port of open_flamingo_tpu for NVIDIA Hopper.

The JAX package `open_flamingo_tpu` is the reference; this package mirrors
its module names and imports nothing from it. Attention on the serving
path runs through hand-written CUDA kernels (`ops/`, sources in `csrc/`)
on CUDA tensors and through their plain PyTorch versions on CPU tensors.
`create_model_and_transforms` (the reference's entry point), the serving
engine `ServingEngine` and `speculative_generate` are imported on first use,
so that importing the package stays cheap.
"""

_LAZY = {"create_model_and_transforms": "factory", "ServingEngine": "serving",
         "speculative_generate": "speculative"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(name)
