"""Decoder infrastructure: KV cache, attention context, ALiBi, rotary.

The cache keeps the JAX package's contract so token streams line up:
head-major (B, H, S, Dh) K/V, one shared slot index, a per-row pad mask.
Unlike the JAX package's pytrees, the cache tensors are updated IN PLACE:
prefill writes its K/V into the cache slices, and the decode kernel
writes the new token's K/V into its slot inside the attention launch.

The int8 cache (`KVCache.create(..., int8=True)`, JAX `LayerKV` with
`k_s`/`v_s`) holds int8 K/V with one fp32 scale per (b, h, s) row. The JAX
package keeps its scales head-leading (H_kv, B, S) for a TPU block rule; the
port keeps them (B, H_kv, S), the cache's own leading layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class LayerKV:
    k: torch.Tensor  # (B, H_kv, S, Dh); int8 when quantized
    v: torch.Tensor
    k_s: Optional[torch.Tensor] = None  # (B, H_kv, S) fp32 row scales of an int8 cache
    v_s: Optional[torch.Tensor] = None

    @property
    def int8(self) -> bool:
        return self.k_s is not None


@dataclasses.dataclass
class KVCache:
    """`index` is the number of slots already written (a Python int: the
    host knows it, so no device sync); `slot` holds the same number as a
    (1,) int32 tensor on the cache's device, which the fused decode kernel
    K3 reads where the host's int would be baked into a captured launch;
    `pad_mask` (B, S) bool marks written non-pad slots. `media` holds each
    xattn layer's projected media K/V, captured at prefill and reused by
    every decode step."""

    layers: Tuple[LayerKV, ...]
    index: int
    slot: torch.Tensor
    pad_mask: torch.Tensor
    media: Optional[Tuple[LayerKV, ...]] = None

    @property
    def max_length(self) -> int:
        return self.layers[0].k.shape[2]

    @staticmethod
    def create(cfg, batch: int, max_length: int, dtype, device, int8: bool = False) -> "KVCache":
        """int8: int8 K/V with (B, H_kv, S) fp32 scales, empty slots at
        scale 1 (they stay masked)."""
        shape = (batch, cfg.kv_heads, max_length, cfg.head_dim)

        def layer():
            if not int8:
                return LayerKV(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device))
            return LayerKV(k=torch.zeros(shape, dtype=torch.int8, device=device),
                           v=torch.zeros(shape, dtype=torch.int8, device=device),
                           k_s=torch.ones(shape[:-1], dtype=torch.float32, device=device),
                           v_s=torch.ones(shape[:-1], dtype=torch.float32, device=device))

        return KVCache(
            layers=tuple(layer() for _ in range(cfg.num_layers)),
            index=0,
            slot=torch.zeros(1, dtype=torch.int32, device=device),
            pad_mask=torch.zeros(batch, max_length, dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class AttnInputs:
    """Per-forward attention context shared by every layer.

    mask:         (B, 1, Tq, Tk) bool, True = attend (einsum path).
    position_ids: (B, Tq) absolute positions.
    kv_slot:      slot where this call's K/V are written (0 without cache).
    kv_len:       length of the key axis for this call.
    pad_mask:     (B, Tk) validity of each key slot.
    cached:       K/V come from a KVCache (head-major layout).
    slot:         kv_slot as the cache's (1,) int32 device tensor (K3).
    """

    mask: torch.Tensor
    position_ids: torch.Tensor
    kv_slot: int
    kv_len: int
    pad_mask: Optional[torch.Tensor] = None
    cached: bool = False
    slot: Optional[torch.Tensor] = None


def position_ids_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Left-padding-safe absolute positions: cumsum(mask) - 1, clipped at 0."""
    pos = torch.cumsum(attention_mask.long(), dim=-1) - 1
    return torch.clamp(pos, min=0)


def make_attn_inputs(
    attention_mask: torch.Tensor,
    *,
    cache: Optional[KVCache] = None,
) -> Tuple[AttnInputs, Optional[KVCache]]:
    """Attention context for a forward call. attention_mask: (B, Tq) 1/0
    over the current tokens; with a cache they go to slots
    [index, index + Tq) and the returned cache carries the new pad mask."""
    b, tq = attention_mask.shape
    dev = attention_mask.device
    am = attention_mask.bool()
    if cache is None:
        causal = torch.ones(tq, tq, dtype=torch.bool, device=dev).tril()
        return (
            AttnInputs(
                mask=causal[None, None] & am[:, None, None, :],
                position_ids=position_ids_from_mask(attention_mask),
                kv_slot=0,
                kv_len=tq,
                pad_mask=am,
            ),
            None,
        )

    s_max, idx = cache.max_length, cache.index
    if idx + tq > s_max:
        raise ValueError(f"cache holds {s_max} slots; writing {tq} at {idx} overflows it")
    new_pad_mask = cache.pad_mask.clone()
    new_pad_mask[:, idx:idx + tq] = am
    prev_valid = cache.pad_mask.long().sum(-1, keepdim=True)
    q_pos = torch.clamp(prev_valid + torch.cumsum(attention_mask.long(), -1) - 1, min=0)
    # key slot j is visible to query i iff j <= idx + i
    q_slot = idx + torch.arange(tq, device=dev)[:, None]
    causal = torch.arange(s_max, device=dev)[None, :] <= q_slot
    return (
        AttnInputs(
            mask=causal[None, None] & new_pad_mask[:, None, None, :],
            position_ids=q_pos,
            kv_slot=idx,
            kv_len=s_max,
            pad_mask=new_pad_mask,
            cached=True,
            slot=cache.slot,
        ),
        dataclasses.replace(cache, pad_mask=new_pad_mask),
    )


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last (Dh) axis, JAX `quantize_kv`:
    scale = amax / 127 (1 where amax is 0), q = clip(round(x / scale)), both
    true divisions (127 as a tensor: see `quantize.quantize_weight`), as the
    decode kernels quantize a new token. Returns (q int8, scale fp32 with
    Dh removed)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))
    return torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8), scale


def quantize_layer_kv(layer: LayerKV) -> LayerKV:
    """A model-dtype LayerKV as an int8 one (JAX generate's media K/V)."""
    (kq, ks), (vq, vs) = quantize_kv(layer.k), quantize_kv(layer.v)
    return LayerKV(kq, vq, ks, vs)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 cache (..., S, Dh) with its (..., S) scales, in `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def update_layer_kv(
    layer_kv: Optional[LayerKV], k: torch.Tensor, v: torch.Tensor, attn: AttnInputs
):
    """Write new K/V (B, T, H, D) at the cache slot, in place; return the
    full key/value tensors. Without a cache they pass through unchanged;
    with one the full tensors are the head-major (B, H, S, D) cache. An int8
    cache quantizes the new rows into its slots and returns the whole cache
    DEQUANTIZED in k's dtype, so this call attends to exactly what later
    decode steps read back (JAX `update_layer_kv`)."""
    if layer_kv is None:
        return k, v, None
    t = k.shape[1]
    sl = slice(attn.kv_slot, attn.kv_slot + t)
    if layer_kv.int8:
        for new, cache, scales in ((k, layer_kv.k, layer_kv.k_s), (v, layer_kv.v, layer_kv.v_s)):
            q, s = quantize_kv(new.transpose(1, 2))
            cache[:, :, sl] = q
            scales[:, :, sl] = s
        return (dequantize_kv(layer_kv.k, layer_kv.k_s, k.dtype), dequantize_kv(layer_kv.v, layer_kv.v_s, v.dtype),
                layer_kv)
    layer_kv.k[:, :, sl] = k.transpose(1, 2).to(layer_kv.k.dtype)
    layer_kv.v[:, :, sl] = v.transpose(1, 2).to(layer_kv.v.dtype)
    return layer_kv.k, layer_kv.v, layer_kv


# --- in-place row surgery (the serving engine, speculative decoding) --------


def _kv_fields(layer: LayerKV):
    return (layer.k, layer.v, layer.k_s, layer.v_s)


@torch.no_grad()
def admit_rows(cache: KVCache, pre: KVCache, rows: torch.Tensor, src: torch.Tensor) -> KVCache:
    """Write prefill cache `pre` (R rows of P slots, its media K/V captured)
    into rows `rows` of `cache`, in place: row src[i] of `pre` into row
    rows[i], its P slots right-aligned at [index - P, index) so the prompt's
    last token sits just before the next write. K/V (B, H, S, Dh) and an int8
    cache's (B, H_kv, S) scales on their slot axis; the row's pad_mask is the
    prompt's window and zeros elsewhere; the media K/V (and scales) of the
    row whole. `cache.media` must already hold B rows (JAX serving `_admit`,
    `_admit_batch`)."""
    p = pre.max_length
    win = slice(cache.index - p, cache.index)
    if win.start < 0:
        raise ValueError(f"admit_rows: a {p}-slot prompt does not fit before slot {cache.index}")
    for big, small in zip(cache.layers, pre.layers):
        for x, y in zip(_kv_fields(big), _kv_fields(small)):
            if x is not None:
                x[rows, :, win] = y[src].to(x.dtype)
    cache.pad_mask[rows] = False
    cache.pad_mask[rows, win] = pre.pad_mask[src]
    for big, small in zip(cache.media or (), pre.media or ()):
        for x, y in zip(_kv_fields(big), _kv_fields(small)):
            if x is not None:
                x[rows] = y[src].to(x.dtype)
    return cache


@torch.no_grad()
def rollback(cache: KVCache, start: int, keep: int, window: int) -> KVCache:
    """Keep the first `keep` of the `window` slots written from `start`, in
    place: `index` and the device `slot` (which K3 writes at) both become
    start + keep, and pad_mask is cleared on [start + keep, start + window);
    the rejected slots are overwritten by the next writes (JAX speculative
    `_rollback`)."""
    cache.index = start + keep
    cache.slot.fill_(start + keep)
    cache.pad_mask[:, start + keep:start + window] = False
    return cache


@torch.no_grad()
def reset_cache(cache: KVCache, index: int) -> KVCache:
    """A new epoch in place: every K/V (and media K/V) zero, int8 scales 1,
    pad_mask cleared, `index` and `slot` at `index`."""
    for layer in cache.layers + (cache.media or ()):
        layer.k.zero_()
        layer.v.zero_()
        if layer.int8:
            layer.k_s.fill_(1.0)
            layer.v_s.fill_(1.0)
    cache.pad_mask.zero_()
    cache.index = index
    cache.slot.fill_(index)
    return cache


def repeat_kv(x: torch.Tensor, n_rep: int, head_axis: int = 2) -> torch.Tensor:
    """Grouped-query expansion along the head axis (head_axis 2 for the
    blocks' (B, T, H_kv, Dh), 1 for the cache's (B, H_kv, S, Dh)): each KV
    head repeated n_rep times in place, so query head h reads KV head
    h // n_rep (JAX `repeat_kv`)."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=head_axis)


def alibi_slopes(num_heads: int, bias_max: float = 8.0) -> np.ndarray:
    """MPT ALiBi slopes (HF build_mpt_alibi_tensor semantics), float32."""
    p = 2 ** math.ceil(math.log2(num_heads))
    base = np.arange(1, p + 1, dtype=np.float32) * (bias_max / p)
    slopes = 1.0 / np.power(2.0, base)
    if p != num_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:num_heads]
    return slopes.astype(np.float32)


def alibi_bias(slopes: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(1, H, 1, kv_len) additive bias slope_h * (j - (kv_len - 1)) from
    (H,) fp32 slopes: the key-position-only form, equal to HF MPT's up to
    softmax translation."""
    dist = torch.arange(1 - kv_len, 1, dtype=torch.float32, device=slopes.device)
    return (slopes[:, None, None] * dist[None, None, :])[None]


# --- rotary embeddings (HF layout) ------------------------------------------


def rope_cos_sin(position_ids: torch.Tensor, rotary_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B, T, rotary_dim) fp32 from position_ids (B, T), HF
    layout: emb = concat(freqs, freqs)."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=position_ids.device) / rotary_dim
    inv_freq = 1.0 / theta**exponent
    freqs = position_ids[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the first rotary_dim channels of q/k (B, T, H, Dh) by cos/sin
    (B, T, rotary_dim); the rest pass through (HF apply_rotary_pos_emb).
    cos/sin are cast to q's dtype before the products, as the JAX package
    does, so bf16 streams round at the same places."""
    rd = cos.shape[-1]
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)

    def rot(x):
        x_rot = x[..., :rd] * cos + _rotate_half(x[..., :rd]) * sin
        return torch.cat([x_rot, x[..., rd:]], dim=-1) if x.shape[-1] > rd else x_rot

    return rot(q), rot(k)
