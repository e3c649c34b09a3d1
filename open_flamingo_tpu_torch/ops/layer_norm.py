"""K10: the one-pass LayerNorm of the ViT blocks.

Replaces `open_flamingo_tpu/ops/layer_norm.py` `layer_norm` (kernel
`_ln_kernel`) and `layer_norm_vjp`. The CUDA kernel is
`csrc/layer_norm.cu` `layer_norm_fwd`: one warp per row, the row held in
registers, fp32 statistics with flax's fast variance max(0, E[x^2] -
E[x]^2), scale and optional bias in fp32, the result in x's dtype. It is
bound by bytes on the card (see the source's note). The JAX kernel's
`block_m` is a TPU tile size and has no counterpart here.

The plain version is the port's flax-semantics LayerNorm
(`models.layers.layer_norm`), re-exported as `reference_layer_norm`.
`layer_norm` goes through `LayerNormFn` when autograd needs its result; its
backward recomputes through the plain version, as the JAX `_bwd` does (the
JAX package has no backward kernel here). CUDA tensors launch the kernel,
CPU tensors run the plain version, any other device raises.

Route (`use_ln_kernel`): the ViT blocks' `layer_norm1` and `layer_norm2` take
this wrapper for CUDA tensors unless inside `ops.attention.plain_path()`.
The JAX package's test hooks keep their meaning: `DISABLE` keeps the plain
LayerNorm on the card (the A/B), `FORCE` takes the wrapper on CPU tensors
too, where it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.layers import LN_EPS
from ..models.layers import layer_norm as reference_layer_norm
from . import build
from .attention import use_kernels
from .flash_attention import _DTYPES, needs_grad

FORCE = False
DISABLE = False
MAX_D = 4096      # csrc/layer_norm.cu kMaxD
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("layer_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.layer_norm_fwd.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, p]
        lib.layer_norm_fwd.restype = i
        _lib = lib
    return _lib


def use_ln_kernel(x: torch.Tensor) -> bool:
    """Whether a ViT block's LayerNorm on `x` takes `layer_norm`: a CUDA
    tensor outside `plain_path()`, any tensor under FORCE; never under
    DISABLE."""
    return not DISABLE and (FORCE or use_kernels(x))


def _check(x, scale, bias):
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (d,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"layer_norm: {name} must be ({d},) in x's dtype on x's device")
    if d % 8 or d > MAX_D:
        raise ValueError(f"layer_norm: the kernel takes a width that is a multiple of 8 up to {MAX_D}, got {d}")


def layer_norm_forward(x, scale, bias, eps):
    """The forward on x's device: the kernel for CUDA, the plain version for
    the CPU."""
    if x.device.type == "cpu":
        return reference_layer_norm(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    _check(x, scale, bias)
    xc, sc = x.contiguous(), scale.contiguous()
    bc = None if bias is None else bias.contiguous()
    if any(t.data_ptr() % 16 for t in (xc, sc) + (() if bc is None else (bc,))):
        raise ValueError("layer_norm: operands must be 16-byte aligned")
    out = torch.empty_like(xc)
    status = _kernel().layer_norm_fwd(
        xc.data_ptr(), sc.data_ptr(), None if bc is None else bc.data_ptr(), out.data_ptr(),
        xc.numel() // x.shape[-1], x.shape[-1], float(eps), _DTYPES[x.dtype], build.current_stream(x.device))
    build.check(status, "layer_norm_fwd")
    layer_norm.launches += 1
    return out


class LayerNormFn(torch.autograd.Function):
    """layer_norm under autograd, `layer_norm_vjp`'s counterpart: the forward
    on x's device, the backward through the plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return layer_norm_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, scale, bias), ctx.needs_input_grad)]
        with torch.enable_grad():
            y = reference_layer_norm(inputs[0], inputs[1], inputs[2], ctx.eps)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs) + (None,)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float = LN_EPS):
    """x (..., D) normalised over D; scale (D,), bias (D,) or None, in x's
    dtype. Returns x's shape and dtype, differentiable in x, scale and bias."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if needs_grad(x, scale, *(() if bias is None else (bias,))):
        return LayerNormFn.apply(x, scale, bias, eps)
    return layer_norm_forward(x, scale, bias, eps)


layer_norm.launches = 0
