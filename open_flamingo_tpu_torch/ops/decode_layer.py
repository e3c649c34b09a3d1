"""K3 attn_block_decode, the whole attention half of a decode layer for one
new token per sequence, and K6 attend_out_decode, its tail alone.

Replaces `open_flamingo_tpu/ops/decode_layer.py` `attn_block_decode`
(kernel `_attn_block_kernel`) and `attend_out_decode` (`_attend_out_kernel`).
The CUDA kernels are in `csrc/decode_layer.cu`: the masked softmax runs as
one block per (b, h); the projections in bf16 as the weight-streaming row
GEMV of `csrc/rows_stream.cuh` (every row up to 64 in one pass of the
weight), on the plans `dense_stream.stream_args` computes here for each
launch's (N, K) (`attn_block_launches`, `attend_out_launches`), with the
scratch and counters K1 and K2 use; in fp32 as the CUDA-core row GEMV of
`csrc/rows_gemv.cuh`. Bound by the weight and cache bytes on the card (see
the source).

K3, two forms, as on the decode path:
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

K6 is the tail that decoder families with their own q/k/v call (GPT-NeoX:
projection by K1, then RoPE): the in-place slot write of the new K/V, the
masked attend (GQA, optional ALiBi), the per-head out-projection summed
over heads, then bias, gate and residual. Its rounding points are the TPU
kernel's, not K3's: q is scaled and rounded to its dtype first, the new
K/V arrive in the cache dtype and this step attends to those rounded
values, the head outputs are rounded to the weight dtype before the fp32
out-projection.

Quantized decode (both kernels): `wq`/`wout` may be int8 or packed int4
(`torch.uint8`, last dim halved) with per-out-channel fp32 scales
`wq_scale`/`wout_scale`; K3's projection is scaled before `clip`, each
out-projection's scale multiplies its fp32 sum before the gate, bias and
residual. K6's head outputs round to q's dtype when its weight is an int
type (the TPU kernel's `mm_dtype`). The caches may be int8 with fp32 row
scales `k_scale`/`v_scale` (B, H_kv, S): the kernel quantizes the new
token per (b, h) row over Dh (amax / 127, round half to even, true
division), writes the int8 row and its scale in place, and attends to the
quantized value, the one later steps read back; logits dequantize after the
dot product, softmax weights before the sum over values. The q-only form
reads an int8 media cache and writes nothing.

K3 as a carrier (K2b-attn, the TPU kernel's side_x / side_w): with side
operands (those of `dense_stream.fused_mlp`, in x's dtype or the W8A8 tile
with side_w_scale) a K2b side tile of the absorbed next-batch ViT rides the
out-projection launch, and the return gains side_out last, as the JAX
package's does: (y, side_out), or (y, k_cache, v_cache, side_out) with
fused_qkv. y and the caches are bit for bit those of the call without it.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`reference_attn_block`, `reference_attend_out`, written from the
kernel bodies) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.decoders.common import quantize_kv
from ..models.layers import layer_norm
from ..quantize import weight_values
from . import build
from .decode_attention import reference_decode_attention
from .dense_stream import (_WTYPES, check_operands, check_side, check_side_kernel, check_weight, count_launch, ptr,
                           reference_side_tile, refuse_autograd, side_operands, side_tag, stream_args, variant, wtype)
from .flash_attention import _DTYPES

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(build.library("decode_layer"))
    return _lib


def bind(lib):
    """`lib` (csrc/decode_layer.cu built) with its C entries' argument types."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    split = [p, p, i]   # scratch, counters, their count
    block = [p] * 18 + [i] * 9 + [f, f, f, i] + [i] * 4 + split
    lib.attn_block_decode_fwd.argtypes = block + [p]
    lib.attn_block_decode_fwd.restype = i
    lib.attend_out_decode_fwd.argtypes = [p] * 17 + [i] * 7 + [f, i] + [i] * 2 + split + [p]
    lib.attend_out_decode_fwd.restype = i
    ll = ctypes.c_longlong
    side = [p, p, ll, p, p, p, f, i, p, p, ll, p, i, i, i, i]
    lib.attn_block_decode_side_fwd.argtypes = block + side + [p]
    lib.attn_block_decode_side_fwd.restype = i
    return lib


def attn_block_launches(wq, wout, dm: int, inner: int) -> list:
    """K3's two row GEMVs as `dense_stream.stream_args` takes them: (N, K,
    weight, gated) of the projection (wq's rows over D) and of the
    out-projection (D over H*Dh)."""
    return [(wq.shape[0], dm, wq, False), (dm, inner, wout, False)]


def attend_out_launches(wout, inner: int) -> list:
    """K6's out-projection as `dense_stream.stream_args` takes it: (D over
    H*Dh, the weight, not gated)."""
    return [(wout.shape[0], inner, wout, False)]


def check_cache(fn: str, k_cache, v_cache, k_scale, v_scale) -> bool:
    """An int8 cache comes with both (B, H_kv, S) scales, and scales with an
    int8 cache (ValueError). Returns whether the cache is int8."""
    if k_cache.dtype == torch.uint8 or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{fn}: caches {k_cache.dtype}/{v_cache.dtype}; expected one dtype, int8 or x's")
    int8 = k_cache.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or int8 != (k_scale is not None):
        raise ValueError(f"{fn}: an int8 cache needs both k_scale and v_scale, and scales need an int8 cache")
    if int8 and (k_scale.shape != k_cache.shape[:3] or v_scale.shape != k_scale.shape):
        raise ValueError(f"{fn}: k_scale/v_scale must be (B, H_kv, S) = {tuple(k_cache.shape[:3])}")
    return int8


def _write_slot(new, cache, scales, idx) -> None:
    """Write a new token's (B, H_kv, 1, Dh) K or V at slot `idx` in place:
    quantized with its scale into an int8 cache, else rounded to the
    cache's dtype."""
    if scales is None:
        cache.index_copy_(2, idx, new.to(cache.dtype))
    else:
        q, s = quantize_kv(new)
        cache.index_copy_(2, idx, q)
        scales.index_copy_(2, idx, s)


def reference_attn_block(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, *, heads, head_dim, scale,
                         fused_qkv=False, slot=None, slopes=None, clip=None, gate=None, wq_scale=None,
                         wout_scale=None, k_scale=None, v_scale=None, eps=1e-5, side_x=None, side_w=None,
                         side_w_scale=None, side_ln=None, side_eps=1e-5, side_act=None, side_b=None,
                         side_residual=None):
    """Plain version of attn_block_decode, at the kernel's rounding points;
    with side_x, side_out (`dense_stream.reference_side_tile`) last."""
    refuse_autograd("attn_block_decode", x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, slopes, gate, side_x,
                    side_w, side_b, side_residual)
    if side_x is not None:
        check_side(x, side_x, side_w, side_ln, side_act, side_b, side_residual, side_w_scale, "attn_block_decode")
    y = attn_block_f32(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, heads=heads, head_dim=head_dim,
                       scale=scale, fused_qkv=fused_qkv, slot=slot, slopes=slopes, clip=clip, gate=gate,
                       wq_scale=wq_scale, wout_scale=wout_scale, k_scale=k_scale, v_scale=v_scale, eps=eps)
    out = ((y.to(x.dtype), k_cache, v_cache) if fused_qkv else (y.to(x.dtype),))
    if side_x is not None:
        out += (reference_side_tile(side_x, side_w, side_w_scale=side_w_scale, side_ln=side_ln, side_eps=side_eps,
                                    side_act=side_act, side_b=side_b, side_residual=side_residual),)
    return out if len(out) > 1 else out[0]


def attn_block_f32(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, *, heads, head_dim, scale,
                   fused_qkv=False, slot=None, slopes=None, clip=None, gate=None, wq_scale=None, wout_scale=None,
                   k_scale=None, v_scale=None, eps=1e-5):
    """reference_attn_block's x + tanh(gate) * out_proj(attention) in fp32,
    before its last rounding (K11 keeps it fp32); the caches are written in
    place all the same."""
    b = x.shape[0]
    inner = heads * head_dim
    proj = layer_norm(x, ln_scale, ln_bias, eps).float() @ weight_values(wq).float().t()
    if wq_scale is not None:
        proj = proj * wq_scale
    if clip is not None:
        proj = proj.clamp(-clip, clip)
    q = proj[:, :inner].reshape(b, heads, head_dim)
    k, v = k_cache, v_cache
    if fused_qkv:
        idx = slot.long()
        kn = proj[:, inner:2 * inner].reshape(b, heads, 1, head_dim)
        vn = proj[:, 2 * inner:].reshape(b, heads, 1, head_dim)
        _write_slot(kn, k_cache, k_scale, idx)
        _write_slot(vn, v_cache, v_scale, idx)
        if k_scale is None:   # this step attends to the unrounded K/V
            k = k_cache.float().index_copy(2, idx, kn)
            v = v_cache.float().index_copy(2, idx, vn)
    a = reference_decode_attention(q, k, v, mask, scale, slopes, k_scale, v_scale)
    y = a.reshape(b, inner).to(x.dtype).float() @ weight_values(wout).float().t()
    if wout_scale is not None:
        y = y * wout_scale
    if gate is not None:
        y = y * torch.tanh(gate.float())
    return y + x.float()


def attn_block_decode(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, *, heads, head_dim, scale,
                      fused_qkv=False, slot=None, slopes=None, clip=None, gate=None, wq_scale=None,
                      wout_scale=None, k_scale=None, v_scale=None, eps=1e-5, side_x=None, side_w=None,
                      side_w_scale=None, side_ln=None, side_eps=1e-5, side_act=None, side_b=None,
                      side_residual=None):
    """x (B, D); ln_scale/ln_bias (D,); wq (3*H*Dh or H*Dh, D); wout
    (D, H*Dh), each in x's dtype, int8 or packed int4, with wq_scale /
    wout_scale (rows,) fp32 for an int weight; k_cache/v_cache
    (B, H, S, Dh) in x's dtype, or int8 with k_scale/v_scale (B, H, S) fp32
    (updated in place with the caches); mask (B, S), nonzero = attend; slot
    (1,) int32 (fused_qkv); slopes (H,) fp32; gate (1,). Returns y (B, D),
    or (y, k_cache, v_cache) with fused_qkv. Side operands as
    `dense_stream.fused_mlp`'s: side_out (M, SN) comes last."""
    if side_x is None and any(t is not None for t in (side_w, side_w_scale, side_ln, side_b, side_residual)):
        raise ValueError("attn_block_decode: side operands need side_x")
    refuse_autograd("attn_block_decode", x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, slopes, gate, side_x,
                    side_w, side_b, side_residual)
    side = dict(side_x=side_x, side_w=side_w, side_w_scale=side_w_scale, side_ln=side_ln, side_eps=side_eps,
                side_act=side_act, side_b=side_b, side_residual=side_residual)
    if side_x is not None:
        check_side(x, side_x, side_w, side_ln, side_act, side_b, side_residual, side_w_scale, "attn_block_decode")
    b, dm = x.shape
    inner = heads * head_dim
    p = 3 * inner if fused_qkv else inner
    s = k_cache.shape[2]
    nq = check_weight("attn_block_decode", "wq", wq, wq_scale, dm)
    no = check_weight("attn_block_decode", "wout", wout, wout_scale, inner)
    if (nq != p or no != dm or k_cache.shape != (b, heads, s, head_dim) or v_cache.shape != k_cache.shape
            or mask.shape != (b, s)):
        raise ValueError(
            f"attn_block_decode: expected x (B, D), wq ({p}, D), wout (D, {inner}), caches (B, H, S, Dh), "
            f"mask (B, S); got {tuple(x.shape)}, {tuple(wq.shape)}, {tuple(wout.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(mask.shape)}")
    int8 = check_cache("attn_block_decode", k_cache, v_cache, k_scale, v_scale)
    if fused_qkv and (slot is None or slot.shape != (1,) or slot.dtype != torch.int32):
        raise ValueError("attn_block_decode: fused_qkv needs slot, a (1,) int32 tensor")
    if slopes is not None and slopes.shape != (heads,):
        raise ValueError("attn_block_decode: slopes must be (H,)")
    if x.device.type == "cpu":
        return reference_attn_block(x, ln_scale, ln_bias, wq, wout, k_cache, v_cache, mask, heads=heads,
                                    head_dim=head_dim, scale=scale, fused_qkv=fused_qkv, slot=slot,
                                    slopes=slopes, clip=clip, gate=gate, wq_scale=wq_scale, wout_scale=wout_scale,
                                    k_scale=k_scale, v_scale=v_scale, eps=eps, **side)
    if x.device.type != "cuda":
        raise ValueError(f"attn_block_decode: unsupported device {x.device}")
    check_operands("attn_block_decode", x, dm, quantized=("wq", "wout", "k_cache", "v_cache"), ln_scale=ln_scale,
                   ln_bias=ln_bias, wq=wq, wout=wout, wq_scale=wq_scale, wout_scale=wout_scale, k_cache=k_cache,
                   v_cache=v_cache, k_scale=k_scale, v_scale=v_scale, gate=gate)
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
    plan, _ = stream_args(x, attn_block_launches(wq, wout, dm, inner))
    args = (ptr(x), ptr(ln_scale), ptr(ln_bias), ptr(wq), ptr(wq_scale), ptr(wout), ptr(wout_scale), ptr(k_cache),
            ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(m), ptr(sl), ptr(gate), ptr(slot) if fused_qkv else None,
            ptr(proj), ptr(attn), ptr(out), b, dm, heads, head_dim, s, int(fused_qkv), int(clip is not None),
            wtype(wq), wtype(wout), float(clip or 0.0), float(scale), float(eps), _DTYPES[x.dtype], *plan)
    main = (out, k_cache, v_cache) if fused_qkv else (out,)
    if side_x is None:
        build.check(_kernel().attn_block_decode_fwd(*args, build.current_stream(x.device)), "attn_block_decode_fwd")
        count_launch(attn_block_decode, variant(wq, int8))
        return main if fused_qkv else out
    check_side_kernel(side_x, side_w, side_w_scale, side_ln, side_b, side_residual, "attn_block_decode")
    sargs, side_out = side_operands(side_x, side_w, side_w_scale, side_ln, side_eps, side_act, side_b, side_residual)
    status = _kernel().attn_block_decode_side_fwd(*args, *sargs, build.current_stream(x.device))
    build.check(status, "attn_block_decode_side_fwd")
    count_launch(attn_block_decode, variant(wq, int8, tags=(side_tag(side_w_scale),)))
    return (*main, side_out)


attn_block_decode.launches = 0
attn_block_decode.variants = {}


def reference_attend(q, k_cache, v_cache, mask, wout, *, scale, k_new=None, v_new=None, slot=None, slopes=None,
                     k_scale=None, v_scale=None):
    """Plain version of attend_out_decode's attend: the slot write (in place,
    with k_new), then the head outputs (B, H*Dh) rounded to the dtype of the
    out-projection's operands (q's when wout is an int type), as the kernel
    writes them before its out-projection."""
    b, h, dh = q.shape
    n_rep = h // k_cache.shape[1]
    if k_new is not None:
        idx = slot.long()
        _write_slot(k_new[:, :, None], k_cache, k_scale, idx)
        _write_slot(v_new[:, :, None], v_cache, v_scale, idx)
    k, v = (c.repeat_interleave(n_rep, dim=1) for c in (k_cache, v_cache))
    ks, vs = (None if c is None else c.repeat_interleave(n_rep, dim=1) for c in (k_scale, v_scale))
    qs = (q.float() * scale).to(q.dtype)
    a = reference_decode_attention(qs, k, v, mask, 1.0, slopes, ks, vs)
    return a.reshape(b, h * dh).to(q.dtype if wout.dtype in _WTYPES else wout.dtype)


def reference_out_tail(heads, wout, *, dtype, wout_scale=None, bias=None, gate=None, residual=None):
    """Plain version of attend_out_decode's tail over given head outputs
    (B, H*Dh): the fp32 out-projection, *wout_scale, +bias, *tanh(gate),
    +residual, one rounding to `dtype`."""
    y = heads.float() @ weight_values(wout).float().t()
    if wout_scale is not None:
        y = y * wout_scale
    if bias is not None:
        y = y + bias.float()
    if gate is not None:
        y = y * torch.tanh(gate.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


def reference_attend_out(q, k_cache, v_cache, mask, wout, *, scale, k_new=None, v_new=None, slot=None, slopes=None,
                         wout_scale=None, bias=None, gate=None, residual=None, k_scale=None, v_scale=None,
                         attn_out=None):
    """Plain version of attend_out_decode, at the kernel's rounding points:
    `reference_attend`, then `reference_out_tail` over its head outputs
    (copied into `attn_out` when given)."""
    refuse_autograd("attend_out_decode", q, k_cache, v_cache, wout, k_new, v_new, slopes, bias, gate, residual)
    heads = reference_attend(q, k_cache, v_cache, mask, wout, scale=scale, k_new=k_new, v_new=v_new, slot=slot,
                             slopes=slopes, k_scale=k_scale, v_scale=v_scale)
    if attn_out is not None:
        attn_out.copy_(heads)
    y = reference_out_tail(heads, wout, dtype=q.dtype, wout_scale=wout_scale, bias=bias, gate=gate,
                           residual=residual)
    return (y, k_cache, v_cache) if k_new is not None else y


def attend_out_decode(q, k_cache, v_cache, mask, wout, *, scale, k_new=None, v_new=None, slot=None, slopes=None,
                      wout_scale=None, bias=None, gate=None, residual=None, layer_idx=None, k_scale=None,
                      v_scale=None, attn_out=None):
    """K6, the attention tail of a decode layer: with k_new/v_new, write them
    into the caches at `slot` IN PLACE; attend q over the caches under
    `mask`; out-project per head and sum; then *wout_scale, +bias,
    *tanh(gate), +residual. q (B, H, Dh), unscaled; k_cache/v_cache
    (B, H_kv, S, Dh) in q's dtype, or int8 with k_scale/v_scale (B, H_kv, S)
    fp32 (updated in place), query head h reading kv head h // (H / H_kv);
    k_new/v_new (B, H_kv, Dh) in q's dtype; slot (1,) int32 on the caches'
    device; mask (B, S), nonzero = attend; wout (D, H*Dh), the nn.Linear
    weight, in q's dtype, int8 or packed int4 with wout_scale (D,) fp32;
    slopes (H,) fp32; bias (D,); gate (1,); residual (B, D). attn_out, a
    contiguous (B, H*Dh) tensor in q's dtype on q's device, receives the
    head outputs the out-projection reads (the kernel writes them there in
    place of its own buffer; the decode path never passes it). Returns y
    (B, D) in q's dtype, or (y, k_cache, v_cache) with k_new."""
    if layer_idx is not None:
        raise ValueError("attend_out_decode: the port keeps one per-layer layout and takes no layer_idx (the JAX "
                         "package's stacked-weight index); pass the layer's own caches and weight")
    refuse_autograd("attend_out_decode", q, k_cache, v_cache, wout, k_new, v_new, slopes, bias, gate, residual)
    b, h, dh = q.shape
    h_kv, s = k_cache.shape[1], k_cache.shape[2]
    dm = check_weight("attend_out_decode", "wout", wout, wout_scale, h * dh)
    update = k_new is not None
    if (h % h_kv or k_cache.shape != (b, h_kv, s, dh) or v_cache.shape != k_cache.shape or mask.shape != (b, s)
            or (residual is not None and residual.shape != (b, dm))):
        raise ValueError(
            f"attend_out_decode: expected q (B, H, Dh), caches (B, H_kv, S, Dh) with H_kv | H, mask (B, S), "
            f"wout (D, H*Dh), residual (B, D); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(mask.shape)}, {tuple(wout.shape)}")
    int8 = check_cache("attend_out_decode", k_cache, v_cache, k_scale, v_scale)
    if (v_new is not None) != update or (update and (k_new.shape != (b, h_kv, dh) or v_new.shape != k_new.shape)):
        raise ValueError("attend_out_decode: k_new and v_new go together, each (B, H_kv, Dh)")
    if update and (slot is None or slot.shape != (1,) or slot.dtype != torch.int32):
        raise ValueError("attend_out_decode: k_new needs slot, a (1,) int32 tensor")
    if slopes is not None and slopes.shape != (h,):
        raise ValueError("attend_out_decode: slopes must be (H,)")
    if attn_out is not None and (attn_out.shape != (b, h * dh) or attn_out.dtype != q.dtype
                                 or attn_out.device != q.device or not attn_out.is_contiguous()):
        raise ValueError(f"attend_out_decode: attn_out must be a contiguous (B, H*Dh) = {(b, h * dh)} tensor in "
                         f"q's dtype on q's device")
    if q.device.type == "cpu":
        return reference_attend_out(q, k_cache, v_cache, mask, wout, scale=scale, k_new=k_new, v_new=v_new,
                                    slot=slot, slopes=slopes, wout_scale=wout_scale, bias=bias, gate=gate,
                                    residual=residual, k_scale=k_scale, v_scale=v_scale, attn_out=attn_out)
    if q.device.type != "cuda":
        raise ValueError(f"attend_out_decode: unsupported device {q.device}")
    q = q.contiguous()
    if update:
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
    check_operands("attend_out_decode", q, h * dh, quantized=("wout", "k_cache", "v_cache"), k_cache=k_cache,
                   v_cache=v_cache, k_scale=k_scale, v_scale=v_scale, wout=wout, wout_scale=wout_scale, k_new=k_new,
                   v_new=v_new, bias=bias, gate=gate, residual=residual)
    if dh % 8 or dh > 128 or s > 8192:
        raise ValueError(f"attend_out_decode: Dh = {dh} must be a multiple of 8 and <= 128, "
                         f"and the cache at most 8192 slots (got {s})")
    for name, t in (("mask", mask), ("slot", slot), ("slopes", slopes)):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"attend_out_decode: {name} must be contiguous on {q.device}")
    m = mask if mask.dtype in (torch.bool, torch.uint8) else (mask != 0).to(torch.uint8)
    sl = None if slopes is None else slopes.to(torch.float32)
    attn = torch.empty(b, h * dh, dtype=q.dtype, device=q.device) if attn_out is None else attn_out
    out = torch.empty(b, dm, dtype=q.dtype, device=q.device)
    plan, _ = stream_args(q, attend_out_launches(wout, h * dh))
    status = _kernel().attend_out_decode_fwd(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale), ptr(k_new), ptr(v_new),
        ptr(slot) if update else None, ptr(m), ptr(sl), ptr(wout), ptr(wout_scale), ptr(bias), ptr(gate),
        ptr(residual), ptr(attn), ptr(out),
        b, h, h_kv, s, dh, dm, wtype(wout), float(scale), _DTYPES[q.dtype], *plan, build.current_stream(q.device),
    )
    build.check(status, "attend_out_decode_fwd")
    count_launch(attend_out_decode, variant(wout, int8))
    return (out, k_cache, v_cache) if update else out


attend_out_decode.launches = 0
attend_out_decode.variants = {}
