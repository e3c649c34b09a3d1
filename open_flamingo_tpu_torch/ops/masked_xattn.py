"""K5: media-masked cross-attention forward (prefill).

Replaces `open_flamingo_tpu/ops/masked_xattn.py` `masked_xattn` (forward
`_xattn_kernel` via `_xattn_forward`). The CUDA kernel is
`csrc/prefill_attention.cu` `masked_xattn_fwd`, K4's skeleton with the
immediate-media mask `text_time[i] == j // n_latents + 1` computed from the
key index; rows with text_time 0 (text before the first image) come out as
exact zeros. At the serving path's shapes it is bound by bytes on the card;
this first version uses fp32 FMA, not tensor cores.

`masked_xattn` launches the kernel for CUDA tensors and runs the plain
version `reference_masked_xattn` for CPU tensors. The backward (K5b) is
not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import _DTYPES, check_qkv

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("prefill_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.masked_xattn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        lib.masked_xattn_fwd.restype = i
        _lib = lib
    return _lib


def reference_masked_xattn(q, k, v, text_time, n_latents: int, scale: float = 1.0):
    """Plain version: immediate-mode semantics with exact zeros for rows
    that see no media."""
    s = k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    media_time = torch.arange(s, device=q.device) // n_latents + 1
    mask = text_time[:, :, None] == media_time[None, None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)).masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bqk,bkd->bqd", p / denom, v.float()).to(q.dtype)


def masked_xattn(q, k, v, text_time, n_latents: int, scale: float = 1.0):
    """q: (BH, Tq, D); k/v: (BH, T_img * n_latents, D); text_time: (BH, Tq)
    int. Returns (BH, Tq, D)."""
    bh, tq, d = q.shape
    s = k.shape[1]
    if k.shape != (bh, s, d) or v.shape != k.shape or text_time.shape != (bh, tq):
        raise ValueError("masked_xattn: expected k/v (BH, S, D) and text_time (BH, Tq)")
    if q.device.type == "cpu":
        return reference_masked_xattn(q, k, v, text_time, n_latents, scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_xattn: unsupported device {q.device}")
    check_qkv(q, k, v, "masked_xattn")
    if text_time.device != q.device:
        raise ValueError("masked_xattn: text_time on another device")
    tt = text_time.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    status = _kernel().masked_xattn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(), out.data_ptr(),
        bh, tq, s, d, int(n_latents), float(scale), _DTYPES[q.dtype],
        build.current_stream(q.device),
    )
    build.check(status, "masked_xattn_fwd")
    masked_xattn.launches += 1
    return out


masked_xattn.launches = 0
