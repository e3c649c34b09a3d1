"""K9: batched whole-sequence attention of the ViT, and K8, the same on the
absorbed ViT's flat workspace.

Replaces `open_flamingo_tpu/ops/vit_attention.py` `vit_attention` (kernel
`_vit_attn_kernel` via `_vit_attention_fwd_impl`; the backward `_bwd`
recomputes through `_reference`). The CUDA kernel is
`csrc/vit_attention.cu` `vit_attention_fwd`. In bf16 a persistent kernel
(the C entry plans it): one block per SM, up to one per instance, walks
over the (image, head) instances; its producer warpgroup stages each
instance's K and V once by TMA into a ring of two instance stages, and its
two consumer warpgroups take the instance's 64-row query tiles in turns on
`wgmma` over all 272 keys whatever S, the fp32 scores in registers, never
in device memory. fp32 runs on CUDA cores, one block per (instance, block
of query rows). It takes S up to 272 (ViT-L/14: 257)
and Dh 16, 32 or 64 (ViT-L/14: 64). The JAX kernel's `block_bh` is a TPU
grid knob and has no counterpart here.

Semantics, the TPU kernel's: q times `scale` in fp32, rounded to q's dtype;
fp32 scores and softmax, P normalised and then rounded to v's dtype; P.V
summed in fp32. The plain version `reference_vit_attention` is the ViT's
einsum core (`models.layers.attend`) on the same rounded q, so the hooks-off
ViT and the plain version agree exactly.

Two entry points: `vit_attention` on (BH, S, Dh), the JAX signature, and
`vit_attention_heads` on (B, S, H, Dh), which the ViT block calls with
strided views of its q/k/v projections (no head transpose, no copy); both
return their input's layout. They go through `VitAttentionFn` when autograd
needs the result; its backward recomputes through the plain version. CUDA
tensors launch the kernel, CPU tensors run the plain version, any other
device raises.

Route (`use_vit_kernel`): the ViT blocks take this wrapper for CUDA tensors
unless inside `ops.attention.plain_path()`; `DISABLE` keeps the einsum core
on the card (the A/B), `FORCE` takes the wrapper on CPU tensors too, where
it runs the plain version.

K8 `flat_vit_attention` replaces the JAX package's `flat_vit_attention`
(kernel `_flat_attn_kernel`), the attention glue of the absorbed next-batch
ViT (`models/absorb_vit.py`): q, k, v and the result are the flat
(B, S_pad, H*Dh) workspace, keys at positions >= s_real are masked, and
every query row, pad rows too, gets the softmax over the real keys (finite
values, as the TPU kernel's). The math is fp32: scores q.k^T times `scale`,
P, and P.V, with one rounding of the result. The kernel is the
`flat_vit_attention_fwd` instance of `csrc/vit_attention.cu` (bf16 P as a
hi/lo pair on the tensor cores, two products per key step; fp32 on CUDA
cores); the plain version is
`reference_flat_vit_attention`. The absorbed schedule picks the kernel
for CUDA tensors outside `plain_path()`; the wrapper launches it for a CUDA
tensor, runs the plain version for a CPU one and raises for any other
device. No autograd: the absorbed ViT runs in decode, under no_grad.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import attend
from . import build
from .attention import use_kernels
from .flash_attention import _DTYPES, needs_grad

FORCE = False
DISABLE = False
MAX_S = 272                    # csrc/vit_attention.cu kMaxS
HEAD_DIMS = (16, 32, 64)
MAX_INSTANCES = 65535          # images x heads a launch takes (the fp32 grid's second axis)
_lib = None


def bind(lib):
    """`lib` (csrc/vit_attention.cu built) with its C entries' argument types."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vit_attention_fwd.argtypes = [p, p, p, p, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, p]
    lib.vit_attention_fwd.restype = i
    lib.flat_vit_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i] + [ll] * 12 + [ctypes.c_float, i, p]
    lib.flat_vit_attention_fwd.restype = i
    return lib


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(build.library("vit_attention"))
    return _lib


def use_vit_kernel(x: torch.Tensor) -> bool:
    """Whether a ViT block's attention on `x` takes `vit_attention_heads`: a
    CUDA tensor outside `plain_path()`, any tensor under FORCE; never under
    DISABLE."""
    return not DISABLE and (FORCE or use_kernels(x))


def reference_heads(q, k, v, scale):
    """Plain version on (B, S, H, Dh): q scaled in fp32 and rounded to its
    dtype, then the einsum core. Returns (B, S, H, Dh)."""
    return attend((q.float() * scale).to(q.dtype), k, v)


def reference_vit_attention(q, k, v, scale):
    """Plain version on (BH, S, Dh), `_reference`'s counterpart."""
    return reference_heads(q[:, :, None], k[:, :, None], v[:, :, None], scale)[:, :, 0]


def _check(q, k, v, fn="vit_attention"):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{fn}: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: q, k, v must share dtype float32 or bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{fn}: q, k, v must share one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS or not 1 <= s <= MAX_S:
        raise ValueError(f"{fn}: the kernel takes Dh in {HEAD_DIMS} and S in [1, {MAX_S}], got Dh {d}, S {s}")
    if b * h > MAX_INSTANCES:
        raise ValueError(f"{fn}: the kernel takes up to {MAX_INSTANCES} (image, head) instances, got {b * h}")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{fn}: q, k, v need a contiguous head dim, strides that are multiples of 8 "
                             "and 16-byte aligned data")


def _strides(t):
    """(batch, head, row) element strides of a (B, S, H, Dh) tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def vit_attention_forward(q, k, v, scale):
    """The forward on (B, S, H, Dh) on q's device: the kernel for CUDA (its
    result contiguous), the plain version for the CPU."""
    if q.device.type == "cpu":
        return reference_heads(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    status = _kernel().vit_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d, *_strides(q), *_strides(k),
        *_strides(v), *_strides(out), float(scale), _DTYPES[q.dtype], build.current_stream(q.device))
    build.check(status, "vit_attention_fwd")
    vit_attention.launches += 1
    return out


class VitAttentionFn(torch.autograd.Function):
    """The attention on (B, S, H, Dh) under autograd: the forward on q's
    device, the backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return vit_attention_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = reference_heads(*inputs, ctx.scale)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def vit_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Bidirectional attention over whole sequences. q, k, v: (B, S, H, Dh),
    any strides with Dh contiguous (the ViT's split-head views). Returns
    (B, S, H, Dh), differentiable in q, k and v."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    if needs_grad(q, k, v):
        return VitAttentionFn.apply(q, k, v, scale)
    return vit_attention_forward(q, k, v, scale)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q, k, v: (BH, S, Dh). Returns (BH, S, Dh)."""
    return vit_attention_heads(q[:, :, None], k[:, :, None], v[:, :, None], scale)[:, :, 0]


vit_attention.launches = 0


def reference_flat_vit_attention(q, k, v, scale, *, heads: int, s_real: int):
    """Plain version of flat_vit_attention, `_flat_attn_kernel`'s math: fp32
    scores times `scale`, keys >= s_real masked, fp32 softmax and P.V, one
    rounding to q's dtype."""
    b, s_pad, d = q.shape
    q4, k4, v4 = (t.float().reshape(b, s_pad, heads, d // heads).transpose(1, 2) for t in (q, k, v))
    scores = (q4 @ k4.transpose(-1, -2)) * scale
    scores = scores.masked_fill(torch.arange(s_pad, device=q.device) >= s_real, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v4
    return out.transpose(1, 2).reshape(b, s_pad, d).to(q.dtype)


def flat_vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, heads: int,
                       s_real: int) -> torch.Tensor:
    """Bidirectional attention on the flat workspace: q, k, v (B, S_pad,
    H*Dh) contiguous, the first s_real rows of each sequence its keys.
    Returns (B, S_pad, H*Dh) in q's dtype."""
    b, s_pad, d = q.shape
    if d % heads or not 1 <= s_real <= s_pad:
        raise ValueError(f"flat_vit_attention: D {d} over {heads} heads, s_real {s_real} of S_pad {s_pad}")
    if q.device.type == "cpu":
        return reference_flat_vit_attention(q, k, v, scale, heads=heads, s_real=s_real)
    if q.device.type != "cuda":
        raise ValueError(f"flat_vit_attention: unsupported device {q.device}")
    q4, k4, v4 = (t.view(b, s_pad, heads, d // heads) for t in (q, k, v))
    _check(q4, k4, v4, "flat_vit_attention")
    out = torch.empty_like(q4)
    status = _kernel().flat_vit_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, s_pad, s_real, d // heads,
        *_strides(q4), *_strides(k4), *_strides(v4), *_strides(out), float(scale), _DTYPES[q.dtype],
        build.current_stream(q.device))
    build.check(status, "flat_vit_attention_fwd")
    flat_vit_attention.launches += 1
    return out.view(b, s_pad, d)


flat_vit_attention.launches = 0
