"""K3 attn_block_decode: the whole attention half of a decode layer for one
new token per sequence.

Replaces `open_flamingo_tpu/ops/decode_layer.py` `attn_block_decode`
(kernel `_attn_block_kernel`). The CUDA kernel is `csrc/decode_layer.cu`:
the q[/k/v] projection and the out-projection run as the row GEMV of
`csrc/rows_gemv.cuh`, the masked softmax as one block per (b, h) between
them; bound by the weight and cache bytes on the card (see the source).

Two forms, as on the decode path:
  * `fused_qkv=True` (MPT self-attention): `wq` is the fused (3*H*Dh, D)
    Wqkv, [q|k|v] row blocks, read in place. The new token's K/V are
    written into the cache at `slot` IN PLACE (the TPU kernel aliases its
    cache inputs to its outputs) and the caches are returned; this step
    attends to the unrounded fp32 K/V, the cache keeps them rounded.
    `clip` (clip_qkv) applies after the projection; `slopes` adds ALiBi
    slope_h * (j - (S_max - 1)).
  * q only (gated cross-attention): `wq` is (H*Dh, D); the K/V are the media
    K/V cached at prefill; `gate` scales the out-projection by tanh(gate).
The result is x + tanh(gate) * out_proj(attention) in fp32, cast to x's
dtype. A row whose mask has no valid key attends to nothing: exact zeros
before the out-projection. `slot` is a (1,) int32 tensor on the device, the
counterpart of the TPU kernel's scalar-prefetch operand: no host read, so
the step can be captured in a CUDA graph.

`attn_block_decode` launches the kernel for CUDA tensors and runs the plain
version `reference_attn_block` (written from the kernel body: the JAX
package has none) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import layer_norm
from . import build
from .decode_attention import reference_decode_attention
from .dense_stream import check_operands, ptr, refuse, refuse_autograd
from .flash_attention import _DTYPES

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("decode_layer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_block_decode_fwd.argtypes = [p] * 14 + [i] * 7 + [f, f, f, i, p]
        lib.attn_block_decode_fwd.restype = i
        _lib = lib
    return _lib


def reference_attn_block(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, *, heads, head_dim, scale,
                         fused_qkv=False, slot=None, slopes=None, clip=None, gate=None, eps=1e-5):
    """Plain version of attn_block_decode, at the kernel's rounding points."""
    refuse_autograd("attn_block_decode", x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, slopes, gate)
    b = x.shape[0]
    inner = heads * head_dim
    proj = layer_norm(x, ln_scale, ln_bias, eps).float() @ wq.float().t()
    if clip is not None:
        proj = proj.clamp(-clip, clip)
    q = proj[:, :inner].reshape(b, heads, head_dim)
    k, v = k_cache, v_cache
    if fused_qkv:
        idx = slot.long()
        kn = proj[:, inner:2 * inner].reshape(b, heads, 1, head_dim)
        vn = proj[:, 2 * inner:].reshape(b, heads, 1, head_dim)
        k_cache.index_copy_(2, idx, kn.to(k_cache.dtype))
        v_cache.index_copy_(2, idx, vn.to(v_cache.dtype))
        k = k_cache.float().index_copy(2, idx, kn)
        v = v_cache.float().index_copy(2, idx, vn)
    a = reference_decode_attention(q, k, v, mask, scale, slopes)
    y = a.reshape(b, inner).to(x.dtype).float() @ wout.float().t()
    if gate is not None:
        y = y * torch.tanh(gate.float())
    y = (y + x.float()).to(x.dtype)
    return (y, k_cache, v_cache) if fused_qkv else y


def attn_block_decode(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, *, heads, head_dim, scale,
                      fused_qkv=False, slot=None, slopes=None, clip=None, gate=None, wq_scale=None,
                      wout_scale=None, k_scale=None, v_scale=None, eps=1e-5, side_x=None, side_w=None):
    """x (B, D); ln_scale/ln_bias (D,); wq (3*H*Dh or H*Dh, D); wout
    (D, H*Dh); k_cache/v_cache (B, H, S, Dh); mask (B, S), nonzero =
    attend; slot (1,) int32 (fused_qkv); slopes (H,) fp32; gate (1,).
    Returns y (B, D), or (y, k_cache, v_cache) with fused_qkv."""
    refuse("attn_block_decode", "int8/int4 weights, item 9", wq_scale=wq_scale, wout_scale=wout_scale)
    refuse("attn_block_decode", "int8 KV cache, item 9", k_scale=k_scale, v_scale=v_scale)
    refuse("attn_block_decode", "K2b side tiles, item 14", side_x=side_x, side_w=side_w)
    refuse_autograd("attn_block_decode", x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, slopes, gate)
    b, dm = x.shape
    inner = heads * head_dim
    p = 3 * inner if fused_qkv else inner
    s = k_cache.shape[2]
    if (wq.shape != (p, dm) or wout.shape != (dm, inner) or k_cache.shape != (b, heads, s, head_dim)
            or v_cache.shape != k_cache.shape or mask.shape != (b, s)):
        raise ValueError(
            f"attn_block_decode: expected x (B, D), wq ({p}, D), wout (D, {inner}), caches (B, H, S, Dh), "
            f"mask (B, S); got {tuple(x.shape)}, {tuple(wq.shape)}, {tuple(wout.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(mask.shape)}")
    if fused_qkv and (slot is None or slot.shape != (1,) or slot.dtype != torch.int32):
        raise ValueError("attn_block_decode: fused_qkv needs slot, a (1,) int32 tensor")
    if slopes is not None and slopes.shape != (heads,):
        raise ValueError("attn_block_decode: slopes must be (H,)")
    if x.device.type == "cpu":
        return reference_attn_block(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, heads=heads,
                                    head_dim=head_dim, scale=scale, fused_qkv=fused_qkv, slot=slot,
                                    slopes=slopes, clip=clip, gate=gate, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"attn_block_decode: unsupported device {x.device}")
    check_operands("attn_block_decode", x, dm, ln_scale=ln_scale, ln_bias=ln_bias, wq=wq, wout=wout,
                   k_cache=k_cache, v_cache=v_cache, gate=gate)
    if head_dim % 8 or head_dim > 128 or s > 8192:
        raise ValueError(f"attn_block_decode: Dh = {head_dim} must be a multiple of 8 and <= 128, "
                         f"and the cache at most 8192 slots (got {s})")
    for name, t in (("mask", mask), ("slot", slot), ("slopes", slopes)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"attn_block_decode: {name} must be contiguous on {x.device}")
    m = mask if mask.dtype in (torch.bool, torch.uint8) else (mask != 0).to(torch.uint8)
    sl = None if slopes is None else slopes.to(torch.float32)
    proj = torch.empty(b, p, dtype=torch.float32, device=x.device)
    attn = torch.empty(b, inner, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    status = _kernel().attn_block_decode_fwd(
        ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(wq), ptr(wout), ptr(k_cache), ptr(v_cache), ptr(m), ptr(sl),
        ptr(gate), ptr(slot) if fused_qkv else None, ptr(proj), ptr(attn), ptr(out),
        b, dm, heads, head_dim, s, int(fused_qkv), int(clip is not None),
        float(clip or 0.0), float(scale), float(eps), _DTYPES[x.dtype], build.current_stream(x.device),
    )
    build.check(status, "attn_block_decode_fwd")
    attn_block_decode.launches += 1
    return (out, k_cache, v_cache) if fused_qkv else out


attn_block_decode.launches = 0
