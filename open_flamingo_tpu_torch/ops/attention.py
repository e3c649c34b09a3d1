"""Self-attention dispatcher, the JAX package's `ops/attention.py`.

Three regimes, selected by query length, cache state and the tensors'
device (`use_kernels`; the JAX package tests for a TPU backend at the same
places):
  * multi-token (>= 8 queries, pad mask given) -> K4 flash kernel (prefill,
    and the cache-free training forward, whose backward is K4b);
  * one query against a cache -> K7 decode kernel (writing the new K/V
    into the cache inside the launch);
  * otherwise -> the einsum path, whose fully-masked rows are uniform
    where the kernels give zeros (only left-pad query rows differ).

K/V layout: (B, T, H, D) for cache-free calls, head-major (B, H, S, D)
when they come from a KVCache (attn.cached). q is always (B, Tq, H, D)
and so is the result.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..models.decoders.common import LayerKV, alibi_bias, repeat_kv, update_layer_kv
from ..models.layers import attend, attend_cached


_PLAIN = False


def use_kernels(x: torch.Tensor) -> bool:
    """Whether work on `x` runs the CUDA kernels: yes for a CUDA tensor,
    unless inside `plain_path()`. The fused decode route (K1-K3, chosen by
    `ops.dense_stream.use_fused_decode`) asks it to pick each kernel or its
    plain version."""
    return x.is_cuda and not _PLAIN


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Run the plain reference on CUDA tensors too, the one the kernels are
    held against on the card: attention takes the einsum path, and the
    fused decode route stays fused but calls each kernel's plain version."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def _use_flash(q, attn) -> bool:
    return q.shape[1] >= 8 and attn.pad_mask is not None and use_kernels(q)


def cached_self_attention(
    q: torch.Tensor,      # (B, T, H, Dh)
    k: torch.Tensor,      # (B, T, H, Dh)
    v: torch.Tensor,
    attn,                 # AttnInputs
    layer_kv: Optional[LayerKV],
    *,
    scale: float,
    alibi_slopes: Optional[torch.Tensor] = None,  # (H,) fp32 on q's device
    n_rep: int = 1,       # grouped-query attention: H = n_rep * H_kv
):
    """Cache update + attention. For one decode token on the kernel path
    the cache write happens inside the K7 launch (MHA only, as in the JAX
    package). Returns (out (B, T, H, Dh), LayerKV or None); the cache
    tensors are updated in place. An int8 cache (which generate makes only
    for the fused route) takes the einsum path over its dequantized rows, as
    in the JAX package. With n_rep > 1 k/v are (..., H_kv, Dh): the written
    K/V are repeated head by head (`repeat_kv`) before the attention."""
    if (layer_kv is not None and not layer_kv.int8 and n_rep == 1 and q.shape[1] == 1
            and attn.pad_mask is not None and use_kernels(q)):
        from .decode_attention import decode_attention_update

        out, kc, vc = decode_attention_update(
            q[:, 0].contiguous(), layer_kv.k, layer_kv.v,
            k[:, 0].contiguous(), v[:, 0].contiguous(),
            attn.pad_mask, attn.kv_slot, scale=scale, slopes=alibi_slopes,
        )
        return out[:, None], LayerKV(k=kc, v=vc)

    k_full, v_full, new_kv = update_layer_kv(layer_kv, k, v, attn)
    head_axis = 1 if attn.cached else 2
    k_full, v_full = repeat_kv(k_full, n_rep, head_axis), repeat_kv(v_full, n_rep, head_axis)
    out = self_attention(q, k_full, v_full, attn, scale=scale, alibi_slopes=alibi_slopes)
    return out, new_kv


def self_attention(
    q: torch.Tensor,      # (B, Tq, H, Dh)
    k: torch.Tensor,      # (B, Tq, H, Dh) or (B, H, S, Dh) when attn.cached
    v: torch.Tensor,
    attn,
    *,
    scale: float,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (B, Tq, H, Dh)."""
    b, tq, h, d = q.shape
    s = attn.kv_len

    if _use_flash(q, attn):
        from .flash_attention import flash_attention

        # (B*H, T, D) contiguous operands: a copy of the transposed q/k/v
        # views (where reshape cannot merge B and H as a view it copies
        # already, and .contiguous() is then a no-op)
        qf = q.transpose(1, 2).reshape(b * h, tq, d).contiguous()
        if attn.cached:
            kf, vf = k.reshape(b * h, s, d), v.reshape(b * h, s, d)  # head-major: a view
        else:
            kf = k.transpose(1, 2).reshape(b * h, s, d).contiguous()
            vf = v.transpose(1, 2).reshape(b * h, s, d).contiguous()
        pad = attn.pad_mask.repeat_interleave(h, dim=0)
        if alibi_slopes is None:
            slopes = torch.zeros(b * h, 1, dtype=torch.float32, device=q.device)
        else:
            slopes = alibi_slopes.float().repeat(b)[:, None]
        out = flash_attention(qf, kf, vf, pad, slopes, attn.kv_slot, True, scale)
        return out.reshape(b, h, tq, d).transpose(1, 2)

    if attn.cached and tq == 1 and attn.pad_mask is not None and use_kernels(q):
        # one query: causality is implied by the cache pad mask (only
        # written, non-pad slots are valid)
        from .decode_attention import decode_attention

        out = decode_attention(q[:, 0].contiguous(), k, v, attn.pad_mask, scale=scale, slopes=alibi_slopes)
        return out[:, None]

    bias = None if alibi_slopes is None else alibi_bias(alibi_slopes, s)
    if attn.cached:
        return attend_cached(q * scale, k, v, bias=bias, mask=attn.mask)
    return attend(q * scale, k, v, bias=bias, mask=attn.mask)
