"""K4: causal streaming-softmax attention forward (prefill).

Replaces `open_flamingo_tpu/ops/flash_attention.py` `flash_attention`
(forward `_attention_kernel` via `_flash_forward`). The CUDA kernel is
`csrc/prefill_attention.cu` `flash_attention_fwd`: one block per (bh,
16-query tile) walking 32-key tiles in shared memory with an online
softmax; causal against `q_offset + i`, key pad mask, in-kernel ALiBi,
exact zeros for rows with no valid key. At the serving path's shapes it is
bound by bytes on the card (see the source's note); this first version
uses fp32 FMA, not tensor cores.

`flash_attention` launches the kernel for CUDA tensors and runs the plain
PyTorch version `reference_attention` for CPU tensors. The backward (K4b)
is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("prefill_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_fwd.restype = i
        _lib = lib
    return _lib


def reference_attention(q, k, v, pad_mask, slopes, q_offset, causal=True, scale=1.0):
    """Plain version, same semantics as the kernel. Shapes as flash_attention."""
    bh, tq, d = q.shape
    s = k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    k_pos = torch.arange(s, device=q.device)[None, None, :]
    logits = logits + slopes.float()[:, :, None] * (k_pos - (s - 1)).float()
    mask = (pad_mask != 0)[:, None, :]
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[None, :, None]
        mask = mask & (k_pos <= q_pos)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)).masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bqk,bkd->bqd", p / denom, v.float())
    return out.to(q.dtype)


def check_qkv(q, k, v, name):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share dtype float32 or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if q.shape[-1] > 128:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > 128")


def flash_attention(q, k, v, pad_mask, slopes, q_offset: int, causal: bool = True, scale: float = 1.0):
    """q: (BH, Tq, D); k/v: (BH, S, D); pad_mask: (BH, S) bool or int,
    nonzero = valid; slopes: (BH, 1) fp32 (0 disables ALiBi); q_offset:
    position of the first query in the key axis. Returns (BH, Tq, D)."""
    bh, tq, d = q.shape
    s = k.shape[1]
    if k.shape != (bh, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad k/v shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if pad_mask.shape != (bh, s) or slopes.shape != (bh, 1):
        raise ValueError("flash_attention: pad_mask must be (BH, S) and slopes (BH, 1)")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, pad_mask, slopes, q_offset, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_qkv(q, k, v, "flash_attention")
    if pad_mask.device != q.device or slopes.device != q.device:
        raise ValueError("flash_attention: pad_mask/slopes on another device")
    pad = (pad_mask != 0).to(torch.uint8).contiguous()
    slopes = slopes.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    status = _kernel().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), slopes.data_ptr(),
        out.data_ptr(), bh, tq, s, d, int(q_offset), int(causal), float(scale),
        _DTYPES[q.dtype], build.current_stream(q.device),
    )
    build.check(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
