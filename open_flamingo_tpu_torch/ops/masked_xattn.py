"""K5: media-masked cross-attention (prefill and training), and K5b, its
backward.

Replaces `open_flamingo_tpu/ops/masked_xattn.py` `masked_xattn`: the
forward `_xattn_kernel` via `_xattn_forward` (with `with_lse`) and the
backward `_xattn_dq_kernel` / `_xattn_dkv_kernel` via `_xattn_backward`.
The CUDA kernels are `csrc/prefill_attention.cu` `masked_xattn_fwd` (K4's
bodies with the immediate-media mask `text_time[i] == j // n_latents + 1`
computed from the key index; rows with text_time 0, text before the first
image, come out as exact zeros; the bf16 tensor-core body loads only the
key tiles of the images its query rows see) and
`csrc/attention_backward.cu` `masked_xattn_bwd_dq` / `_dkv` (K4b's kernels
under the media mask; those rows get exactly zero dq; the bf16 tensor-core
body walks only the key tiles of the images a query tile sees, and only the
queries that see a key block's images). At the path's shapes they are bound
by bytes on the card. `masked_xattn_fma` and `masked_xattn_backward_fma`
launch the CUDA-core bodies in either dtype, the yardsticks of the card's
timings; the port never calls them.

`masked_xattn` goes through `MaskedXattnFn` when autograd needs its
result; gradients flow to q, k and v (text_time is not differentiated). CUDA
tensors launch the kernels; CPU tensors run the plain versions
`reference_masked_xattn` and `reference_masked_xattn_backward`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import (
    _DTYPES, _bwd_kernel, check_grad_operands, check_qkv, masked_softmax_v, masked_softmax_v_backward, needs_grad)

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("prefill_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("masked_xattn_fwd", "masked_xattn_fwd_fma"):
            getattr(lib, fn).argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


def _scores(q, k, text_time, n_latents, scale):
    s = k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    media_time = torch.arange(s, device=q.device) // n_latents + 1
    return logits, text_time[:, :, None] == media_time[None, None, :]


def reference_masked_xattn(q, k, v, text_time, n_latents: int, scale: float = 1.0, with_lse: bool = False):
    """Plain version: immediate-mode semantics with exact zeros for rows
    that see no media; with_lse also returns the logsumexp (BH, Tq) fp32."""
    logits, mask = _scores(q, k, text_time, n_latents, scale)
    return masked_softmax_v(logits, mask, v, q.dtype, with_lse)


def reference_masked_xattn_backward(q, k, v, text_time, n_latents: int, out, lse, dout, scale: float = 1.0):
    """Plain version of K5b: (dq, dk, dv) from the forward's out and lse."""
    logits, mask = _scores(q, k, text_time, n_latents, scale)
    return masked_softmax_v_backward(q, k, v, logits, mask, out, lse, dout, scale)


def _cuda_text_time(q, k, v, text_time, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_qkv(q, k, v, name)
    if text_time.device != q.device:
        raise ValueError(f"{name}: text_time on another device")
    return text_time.to(torch.int32).contiguous()


def _launch_forward(entry, q, k, v, text_time, n_latents, scale, with_lse):
    tt = _cuda_text_time(q, k, v, text_time, "masked_xattn")
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=q.device) if with_lse else None
    status = getattr(_kernel(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, tq, k.shape[1], d, int(n_latents), float(scale),
        _DTYPES[q.dtype], build.current_stream(q.device),
    )
    build.check(status, entry)
    return (out, lse) if with_lse else out


def masked_xattn_forward(q, k, v, text_time, n_latents, scale, with_lse):
    if q.device.type == "cpu":
        return reference_masked_xattn(q, k, v, text_time, n_latents, scale, with_lse)
    result = _launch_forward("masked_xattn_fwd", q, k, v, text_time, n_latents, scale, with_lse)
    masked_xattn.launches += 1
    return result


def masked_xattn_fma(q, k, v, text_time, n_latents: int, scale: float = 1.0, with_lse: bool = False):
    """The forward's CUDA-core FMA body on CUDA tensors, in fp32 or bf16:
    the yardstick the bf16 tensor-core body replaced. Counts no launch."""
    return _launch_forward("masked_xattn_fwd_fma", q, k, v, text_time, n_latents, scale, with_lse)


def _launch_backward(body, q, k, v, text_time, n_latents, out, lse, dout, scale):
    """`masked_xattn_bwd_dq{body}` then `_dkv{body}` on CUDA tensors."""
    name = "masked_xattn_backward" + body
    tt = _cuda_text_time(q, k, v, text_time, name)
    if n_latents < 1:
        raise ValueError(f"{name}: n_latents must be positive")
    check_grad_operands(q, out, lse, dout, name)
    bh, tq, d = q.shape
    delta = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_kernel()
    common = (bh, tq, k.shape[1], d, int(n_latents), float(scale), _DTYPES[q.dtype], build.current_stream(q.device))
    build.check(getattr(lib, f"masked_xattn_bwd_dq{body}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common), f"masked_xattn_bwd_dq{body}")
    build.check(getattr(lib, f"masked_xattn_bwd_dkv{body}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common), f"masked_xattn_bwd_dkv{body}")
    return dq, dk, dv


def masked_xattn_backward(q, k, v, text_time, n_latents: int, out, lse, dout, scale: float = 1.0):
    """K5b: (dq, dk, dv) from the forward's out and lse (BH, Tq) fp32, for
    dout (BH, Tq, D). One call is two launches, dq (which also writes
    delta) then dkv."""
    if q.device.type == "cpu":
        return reference_masked_xattn_backward(q, k, v, text_time, n_latents, out, lse, dout, scale)
    grads = _launch_backward("", q, k, v, text_time, n_latents, out, lse, dout, scale)
    masked_xattn_backward.launches += 1
    return grads


def masked_xattn_backward_fma(q, k, v, text_time, n_latents: int, out, lse, dout, scale: float = 1.0):
    """K5b's CUDA-core FMA body on CUDA tensors, in fp32 or bf16: the
    yardstick the bf16 tensor-core body replaced. Counts no launch."""
    return _launch_backward("_fma", q, k, v, text_time, n_latents, out, lse, dout, scale)


class MaskedXattnFn(torch.autograd.Function):
    """masked_xattn under autograd: the forward keeps its logsumexp, the
    backward is K5b (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, text_time, n_latents, scale):
        out, lse = masked_xattn_forward(q, k, v, text_time, n_latents, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, text_time, out, lse)
        ctx.attrs = (n_latents, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, text_time, out, lse = ctx.saved_tensors
        n_latents, scale = ctx.attrs
        dq, dk, dv = masked_xattn_backward(q, k, v, text_time, n_latents, out, lse, dout.contiguous(), scale)
        return dq, dk, dv, None, None, None


def masked_xattn(q, k, v, text_time, n_latents: int, scale: float = 1.0):
    """q: (BH, Tq, D); k/v: (BH, T_img * n_latents, D); text_time: (BH, Tq)
    int. Returns (BH, Tq, D), differentiable in q, k and v."""
    bh, tq, d = q.shape
    s = k.shape[1]
    if k.shape != (bh, s, d) or v.shape != k.shape or text_time.shape != (bh, tq):
        raise ValueError("masked_xattn: expected k/v (BH, S, D) and text_time (BH, Tq)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_xattn: unsupported device {q.device}")
    if needs_grad(q, k, v):
        return MaskedXattnFn.apply(q, k, v, text_time, n_latents, scale)
    return masked_xattn_forward(q, k, v, text_time, n_latents, scale, with_lse=False)


masked_xattn.launches = 0
masked_xattn_backward.launches = 0
