"""K11 fused_layer_decode: a whole decode layer for one new token per
sequence in one launch, the attention half (K3's math) then the MLP half
(K2's), with the layer's residual stream x2 kept in fp32 between them.

Replaces `open_flamingo_tpu/ops/fused_layer.py` `fused_layer_decode`
(kernel `_layer_kernel`). The CUDA kernel is `csrc/fused_layer.cu`: one
persistent cooperative launch whose five phases (projection, attend,
out-projection, up, down) run the bodies of K3 and K2 between grid-wide
barriers, K2's phases on the plans of K2's own launches (`stream_plan`,
bf16: up to 64 rows); bound by the weight and cache bytes on the card (see
the source).

Two forms, as on the decode path:
  * `fused_qkv=True` (an MPT block): `wq` is the fused (3*H*Dh, D) Wqkv.
    The new token's K/V are written into the cache at `slot` IN PLACE and
    the caches are returned; `clip` (clip_qkv) and ALiBi `slopes` as K3's.
  * q only (a gated cross-attention block): `wq` is (H*Dh, D), the caches
    are the media K/V, `gate` and `gate2` scale the attention and the FF by
    their tanh.
x2 = x + tanh(gate) * out_proj(attention) stays fp32: LN2 normalises the
fp32 value and y = x2 + tanh(gate2) * (u @ w2.T * w2_scale + b2) adds it,
u = act(LN2(x2) @ w1.T * w1_scale + b1) [* LN2(x2) @ w1_gate.T *
w1_gate_scale] rounded to x's dtype. So in fp32 K11 equals K3 then K2, and
in bf16 it does not (K3 rounds x2). The other rounding points are K3's and
K2's. The weights are in torch's nn.Linear layout, all in x's dtype, int8 or
packed int4 (one stored type for the layer), each int weight with its
per-out-channel fp32 scale. The JAX kernel's TPU tiling arguments
(`head_block`, `block_s`, `block_k2`, `interpret`) have no counterpart.

Refused, as the other wrappers refuse what they do not take: `layer_idx`
(the port keeps one per-layer layout), an int8 cache (K11 has no
cache-scale operand; JAX's callers route it to K3 + K2), autograd, and
malformed operands.

Route (the JAX package's hooks, same defaults): `DISABLE = False` runs
every MPT block and gated cross-attention block of a fused decode step as
K11; `XATTN_ONLY = True` the gated blocks alone (`use_for_xattn`). The
callers take it only on the fused route, not over an int8 K/V or media cache
and not in an absorbing step; there they run K3 + K2 as before.

The wrapper launches the kernel for CUDA tensors and runs the plain version
`reference_fused_layer` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import layer_norm
from . import build
from .decode_layer import attn_block_f32
from .dense_stream import (_ACTS, STREAM_ROWS, check_operands, check_prologue, check_weight, count_launch, form_tags,
                           ptr, reference_mlp, refuse_autograd, stream_args, variant, wtype)
from .flash_attention import _DTYPES

# True by default, as in the JAX package: every block runs K3 + K2.
DISABLE = True
# The gated cross-attention blocks alone take K11, the decoder blocks K3 + K2.
XATTN_ONLY = False

_lib = None


def use_for_xattn() -> bool:
    """Whether the gated cross-attention blocks take K11."""
    return XATTN_ONLY or not DISABLE


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("fused_layer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_layer_decode_fwd.argtypes = [p] * 29 + [i] * 10 + [f, f, f] + [i] * 4 + [p, p, i] + [i, p]
        lib.fused_layer_decode_fwd.restype = i
        _lib = lib
    return _lib


def _refuse_int8_cache(k_cache, v_cache) -> None:
    if torch.int8 in (k_cache.dtype, v_cache.dtype):
        raise TypeError("fused_layer_decode: an int8 cache is not taken (K11 has no cache-scale operand); "
                        "run the block as attn_block_decode + fused_mlp")


def reference_fused_layer(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale, ln2_bias, *,
                          heads, head_dim, scale, act="gelu", fused_qkv=False, slot=None, slopes=None, clip=None,
                          gate=None, gate2=None, w1_gate=None, wq_scale=None, wout_scale=None, w1_scale=None,
                          w2_scale=None, w1_gate_scale=None, b1=None, b2=None, eps=1e-5):
    """Plain version of fused_layer_decode, at the kernel's rounding points:
    x2 in fp32 between the halves."""
    refuse_autograd("fused_layer_decode", x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, w1, w2, ln2_scale,
                    ln2_bias, slopes, gate, gate2, w1_gate, b1, b2)
    _refuse_int8_cache(k_cache, v_cache)
    x2 = attn_block_f32(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, heads=heads, head_dim=head_dim,
                        scale=scale, fused_qkv=fused_qkv, slot=slot, slopes=slopes, clip=clip, gate=gate,
                        wq_scale=wq_scale, wout_scale=wout_scale, eps=eps)
    h = layer_norm(x2, ln2_scale, ln2_bias, eps).to(x.dtype)
    y = reference_mlp(h, w1, w2, w1_gate=w1_gate, w1_scale=w1_scale, w2_scale=w2_scale, w1_gate_scale=w1_gate_scale,
                      b1=b1, b2=b2, act=act, residual=x2, gate=gate2)
    return (y, k_cache, v_cache) if fused_qkv else y


def fused_layer_decode(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale, ln2_bias, *,
                       heads, head_dim, scale, act="gelu", fused_qkv=False, slot=None, slopes=None, clip=None,
                       gate=None, gate2=None, w1_gate=None, wq_scale=None, wout_scale=None, w1_scale=None,
                       w2_scale=None, w1_gate_scale=None, b1=None, b2=None, layer_idx=None, eps=1e-5):
    """x (B, D); ln1_scale/ln1_bias, ln2_scale/ln2_bias (D,); wq (3*H*Dh or
    H*Dh, D); wout (D, H*Dh); w1, w1_gate (K2, D); w2 (D, K2); each weight
    in x's dtype, int8 or packed int4 (last dim halved), all of one stored
    type, an int weight with its (rows,) fp32 scale; k_cache/v_cache
    (B, H, S, Dh) in x's dtype; mask (B, S), nonzero = attend; slot (1,)
    int32 (fused_qkv); slopes (H,) fp32; gate, gate2 (1,); b1 (K2,); b2
    (D,). Returns y (B, D), or (y, k_cache, v_cache) with fused_qkv."""
    if layer_idx is not None:
        raise ValueError("fused_layer_decode: the port keeps one per-layer layout and takes no layer_idx (the JAX "
                         "package's stacked-weight index); pass the layer's own caches and weights")
    refuse_autograd("fused_layer_decode", x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, w1, w2, ln2_scale,
                    ln2_bias, slopes, gate, gate2, w1_gate, b1, b2)
    _refuse_int8_cache(k_cache, v_cache)
    check_prologue("fused_layer_decode", act, "layer", ln1_scale, ln1_bias)
    check_prologue("fused_layer_decode", act, "layer", ln2_scale, ln2_bias)
    if ln1_scale is None or ln2_scale is None:
        raise ValueError("fused_layer_decode: both LayerNorms need their scale")
    b, dm = x.shape
    inner = heads * head_dim
    p = 3 * inner if fused_qkv else inner
    s = k_cache.shape[2]
    nq = check_weight("fused_layer_decode", "wq", wq, wq_scale, dm)
    no = check_weight("fused_layer_decode", "wout", wout, wout_scale, inner)
    k2 = check_weight("fused_layer_decode", "w1", w1, w1_scale, dm)
    n2 = check_weight("fused_layer_decode", "w2", w2, w2_scale, k2)
    if (nq != p or no != dm or n2 != dm or k_cache.shape != (b, heads, s, head_dim) or v_cache.shape != k_cache.shape
            or mask.shape != (b, s)):
        raise ValueError(
            f"fused_layer_decode: expected x (B, D), wq ({p}, D), wout (D, {inner}), w1 (K2, D), w2 (D, K2), "
            f"caches (B, H, S, Dh), mask (B, S); got {tuple(x.shape)}, {tuple(wq.shape)}, {tuple(wout.shape)}, "
            f"{tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(k_cache.shape)}, {tuple(mask.shape)}")
    if w1_gate is None and w1_gate_scale is not None:
        raise ValueError("fused_layer_decode: w1_gate_scale needs w1_gate")
    if w1_gate is not None and check_weight("fused_layer_decode", "w1_gate", w1_gate, w1_gate_scale, dm) != k2:
        raise ValueError(f"fused_layer_decode: w1_gate {tuple(w1_gate.shape)} does not match w1 {tuple(w1.shape)}")
    if len({w.dtype for w in (wq, wout, w1, w2, w1_gate) if w is not None}) != 1:
        raise ValueError("fused_layer_decode: wq, wout, w1, w2 (and w1_gate) share one stored type")
    if fused_qkv and (slot is None or slot.shape != (1,) or slot.dtype != torch.int32):
        raise ValueError("fused_layer_decode: fused_qkv needs slot, a (1,) int32 tensor")
    if slopes is not None and slopes.shape != (heads,):
        raise ValueError("fused_layer_decode: slopes must be (H,)")
    for name, t, n in (("b1", b1, k2), ("b2", b2, dm), ("gate", gate, 1), ("gate2", gate2, 1)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"fused_layer_decode: {name} must be ({n},), got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return reference_fused_layer(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale,
                                     ln2_bias, heads=heads, head_dim=head_dim, scale=scale, act=act,
                                     fused_qkv=fused_qkv, slot=slot, slopes=slopes, clip=clip, gate=gate, gate2=gate2,
                                     w1_gate=w1_gate, wq_scale=wq_scale, wout_scale=wout_scale, w1_scale=w1_scale,
                                     w2_scale=w2_scale, w1_gate_scale=w1_gate_scale, b1=b1, b2=b2, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_decode: unsupported device {x.device}")
    check_operands("fused_layer_decode", x, dm, quantized=("wq", "wout", "w1", "w1_gate", "w2"), ln1_scale=ln1_scale,
                   ln1_bias=ln1_bias, ln2_scale=ln2_scale, ln2_bias=ln2_bias, wq=wq, wout=wout, w1=w1,
                   w1_gate=w1_gate, w2=w2, wq_scale=wq_scale, wout_scale=wout_scale, w1_scale=w1_scale,
                   w2_scale=w2_scale, w1_gate_scale=w1_gate_scale, k_cache=k_cache, v_cache=v_cache, b1=b1, b2=b2,
                   gate=gate, gate2=gate2)
    if x.dtype == torch.bfloat16 and b > STREAM_ROWS:
        raise ValueError(f"fused_layer_decode: in bf16 K2's phases take at most {STREAM_ROWS} rows in one pass, "
                         f"got B {b}; run the block as attn_block_decode + fused_mlp")
    if head_dim % 8 or head_dim > 128 or s > 8192 or k2 % 8:
        raise ValueError(f"fused_layer_decode: Dh = {head_dim} must be a multiple of 8 and <= 128, the cache at "
                         f"most 8192 slots (got {s}) and the hidden size a multiple of 8 (got {k2})")
    for name, t in (("mask", mask), ("slot", slot), ("slopes", slopes)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"fused_layer_decode: {name} must be contiguous on {x.device}")
    m = mask if mask.dtype in (torch.bool, torch.uint8) else (mask != 0).to(torch.uint8)
    sl = None if slopes is None else slopes.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=x.device)
    proj, x2 = torch.empty(b, p, **f32), torch.empty(b, dm, **f32)
    attn = torch.empty(b, inner, dtype=x.dtype, device=x.device)
    u = torch.empty(b, k2, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    plan, _ = stream_args(x, [(k2, dm, w1, w1_gate is not None), (dm, k2, w2, False)])   # K2's plans, phases 4, 5
    status = _kernel().fused_layer_decode_fwd(
        ptr(x), ptr(ln1_scale), ptr(ln1_bias), ptr(wq), ptr(wq_scale), ptr(wout), ptr(wout_scale), ptr(k_cache),
        ptr(v_cache), ptr(m), ptr(sl), ptr(gate), ptr(slot) if fused_qkv else None, ptr(w1), ptr(w1_gate), ptr(w2),
        ptr(w1_scale), ptr(w1_gate_scale), ptr(w2_scale), ptr(b1), ptr(b2), ptr(ln2_scale), ptr(ln2_bias),
        ptr(gate2), ptr(proj), ptr(attn), ptr(x2), ptr(u), ptr(y),
        b, dm, heads, head_dim, s, k2, int(fused_qkv), int(clip is not None), wtype(wq), _ACTS[act],
        float(clip or 0.0), float(scale), float(eps), *plan, _DTYPES[x.dtype], build.current_stream(x.device),
    )
    build.check(status, "fused_layer_decode_fwd")
    count_launch(fused_layer_decode, layer_variant(wq, fused_qkv, act, w1_gate is not None))
    return (y, k_cache, v_cache) if fused_qkv else y


def layer_variant(wq, fused_qkv: bool, act, gated: bool) -> str:
    """K11's launch-counter key: the weights' kind, "+xattn" for the q-only
    form, then K2's tags (SwiGLU, an activation other than exact GELU)."""
    return variant(wq, tags=(None if fused_qkv else "xattn",) + form_tags("layer", act, gated))


fused_layer_decode.launches = 0
fused_layer_decode.variants = {}
