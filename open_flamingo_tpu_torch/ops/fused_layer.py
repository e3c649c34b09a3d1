"""K11 fused_layer_decode: a whole decode layer for one new token per
sequence in one launch, the attention half (K3's math) then the MLP half
(K2's), with the layer's residual stream x2 kept in fp32 between them.

Replaces `open_flamingo_tpu/ops/fused_layer.py` `fused_layer_decode`
(kernel `_layer_kernel`). The CUDA kernel is `csrc/fused_layer.cu`: one
persistent cooperative launch whose five phases (projection, attend,
out-projection, up, down) run between grid-wide barriers. In bf16 each
row-GEMV phase runs the weight-streaming body of `csrc/rows_stream.cuh` on
the plan of the separate launch that computes it (`layer_launches`: K3's
two, then K2's two, from one `stream_args` call), any B in passes of 64
rows, and issues its first weight stages before the barrier its rows wait
for; fp32 runs the CUDA-core body. Bound by the weight and cache bytes on
the card (see the source).

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
in bf16 it does not (K3 rounds x2): there the written caches are K3's bits
and x2 rounded to bf16 is K3's output, bit for bit (`x2_out` receives x2).
The other rounding points are K3's and K2's. The weights are in torch's
nn.Linear layout, all in x's dtype, int8 or
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
from .decode_layer import attn_block_f32, attn_block_launches
from .dense_stream import (_ACTS, check_operands, check_prologue, check_weight, count_launch, form_tags, ptr,
                           reference_mlp, refuse_autograd, stream_args, stream_ring, variant, wtype)
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
        lib.fused_layer_decode_fwd.argtypes = [p] * 29 + [i] * 10 + [f, f, f] + [i] * 8 + [p, p, i] + [i, p]
        lib.fused_layer_decode_fwd.restype = i
        _lib = lib
    return _lib


def layer_launches(wq, wout, w1, w1_gate, w2, dm: int, inner: int) -> list:
    """K11's four row-GEMV phases as `dense_stream.stream_args` takes them,
    each the separate launch that computes it: K3's projection and
    out-projection (`attn_block_launches`), then K2's up (gated with
    w1_gate) and down."""
    k2 = w1.shape[0]
    return attn_block_launches(wq, wout, dm, inner) + [(k2, dm, w1, w1_gate is not None), (dm, k2, w2, False)]


# K11's shared memory in bf16 (csrc/fused_layer.cu, the top): the instance's
# ring and h slice (`dense_stream.stream_ring`, 64 rows' statistics and a
# flag), then the attend's q, new K, new V and reduction partials; its scores
# (S floats) and their output partials (128 x 8 floats) lie in the h slice.
ATTEND_STATICS = (3 * 128 + 4) * 4
ATTEND_PARTS = 128 * 8 * 4


def layer_smem(b: int, gated: bool, s: int) -> dict:
    """The bf16 launch's regions for b rows over an S-slot cache: name ->
    (first byte, end), and "total"."""
    _, ring, stream = stream_ring(b, gated)
    h_end = stream - (2 * 64 * 4 + 16)
    return {"ring": (0, ring), "h": (ring, h_end), "scores": (ring, ring + 4 * s),
            "attend_parts": (ring, ring + ATTEND_PARTS), "stats": (h_end, stream),
            "attend_statics": (stream, stream + ATTEND_STATICS), "total": stream + ATTEND_STATICS}


def _refuse_int8_cache(k_cache, v_cache) -> None:
    if torch.int8 in (k_cache.dtype, v_cache.dtype):
        raise TypeError("fused_layer_decode: an int8 cache is not taken (K11 has no cache-scale operand); "
                        "run the block as attn_block_decode + fused_mlp")


def reference_fused_layer(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale, ln2_bias, *,
                          heads, head_dim, scale, act="gelu", fused_qkv=False, slot=None, slopes=None, clip=None,
                          gate=None, gate2=None, w1_gate=None, wq_scale=None, wout_scale=None, w1_scale=None,
                          w2_scale=None, w1_gate_scale=None, b1=None, b2=None, eps=1e-5, x2_out=None):
    """Plain version of fused_layer_decode, at the kernel's rounding points:
    x2 in fp32 between the halves (copied into `x2_out` when given)."""
    refuse_autograd("fused_layer_decode", x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, w1, w2, ln2_scale,
                    ln2_bias, slopes, gate, gate2, w1_gate, b1, b2)
    _refuse_int8_cache(k_cache, v_cache)
    x2 = attn_block_f32(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, heads=heads, head_dim=head_dim,
                        scale=scale, fused_qkv=fused_qkv, slot=slot, slopes=slopes, clip=clip, gate=gate,
                        wq_scale=wq_scale, wout_scale=wout_scale, eps=eps)
    if x2_out is not None:
        x2_out.copy_(x2)
    h = layer_norm(x2, ln2_scale, ln2_bias, eps).to(x.dtype)
    y = reference_mlp(h, w1, w2, w1_gate=w1_gate, w1_scale=w1_scale, w2_scale=w2_scale, w1_gate_scale=w1_gate_scale,
                      b1=b1, b2=b2, act=act, residual=x2, gate=gate2)
    return (y, k_cache, v_cache) if fused_qkv else y


def fused_layer_decode(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale, ln2_bias, *,
                       heads, head_dim, scale, act="gelu", fused_qkv=False, slot=None, slopes=None, clip=None,
                       gate=None, gate2=None, w1_gate=None, wq_scale=None, wout_scale=None, w1_scale=None,
                       w2_scale=None, w1_gate_scale=None, b1=None, b2=None, layer_idx=None, eps=1e-5,
                       x2_out=None):
    """x (B, D), any B; ln1_scale/ln1_bias, ln2_scale/ln2_bias (D,); wq
    (3*H*Dh or H*Dh, D); wout (D, H*Dh); w1, w1_gate (K2, D); w2 (D, K2);
    each weight in x's dtype, int8 or packed int4 (last dim halved), all of
    one stored type, an int weight with its (rows,) fp32 scale;
    k_cache/v_cache (B, H, S, Dh) in x's dtype; mask (B, S), nonzero =
    attend; slot (1,) int32 (fused_qkv); slopes (H,) fp32; gate, gate2 (1,);
    b1 (K2,); b2 (D,). x2_out, a contiguous (B, D) fp32 tensor on x's
    device, receives x2 (the kernel writes it there in place of its own
    buffer; the decode path never passes it). Returns y (B, D), or (y,
    k_cache, v_cache) with fused_qkv."""
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
    if x2_out is not None and (x2_out.shape != (b, dm) or x2_out.dtype != torch.float32
                               or x2_out.device != x.device or not x2_out.is_contiguous()):
        raise ValueError(f"fused_layer_decode: x2_out must be a contiguous (B, D) = {(b, dm)} float32 tensor on "
                         f"x's device")
    if x.device.type == "cpu":
        return reference_fused_layer(x, ln1_scale, ln1_bias, wq, wout, k_cache, v_cache, mask, w1, w2, ln2_scale,
                                     ln2_bias, heads=heads, head_dim=head_dim, scale=scale, act=act,
                                     fused_qkv=fused_qkv, slot=slot, slopes=slopes, clip=clip, gate=gate, gate2=gate2,
                                     w1_gate=w1_gate, wq_scale=wq_scale, wout_scale=wout_scale, w1_scale=w1_scale,
                                     w2_scale=w2_scale, w1_gate_scale=w1_gate_scale, b1=b1, b2=b2, eps=eps,
                                     x2_out=x2_out)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_decode: unsupported device {x.device}")
    check_operands("fused_layer_decode", x, dm, quantized=("wq", "wout", "w1", "w1_gate", "w2"), ln1_scale=ln1_scale,
                   ln1_bias=ln1_bias, ln2_scale=ln2_scale, ln2_bias=ln2_bias, wq=wq, wout=wout, w1=w1,
                   w1_gate=w1_gate, w2=w2, wq_scale=wq_scale, wout_scale=wout_scale, w1_scale=w1_scale,
                   w2_scale=w2_scale, w1_gate_scale=w1_gate_scale, k_cache=k_cache, v_cache=v_cache, b1=b1, b2=b2,
                   gate=gate, gate2=gate2)
    if head_dim % 8 or head_dim > 128 or s > 8192 or k2 % 8:
        raise ValueError(f"fused_layer_decode: Dh = {head_dim} must be a multiple of 8 and <= 128, the cache at "
                         f"most 8192 slots (got {s}) and the hidden size a multiple of 8 (got {k2})")
    for name, t in (("mask", mask), ("slot", slot), ("slopes", slopes)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"fused_layer_decode: {name} must be contiguous on {x.device}")
    m = mask if mask.dtype in (torch.bool, torch.uint8) else (mask != 0).to(torch.uint8)
    sl = None if slopes is None else slopes.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=x.device)
    proj = torch.empty(b, p, **f32)
    x2 = torch.empty(b, dm, **f32) if x2_out is None else x2_out
    attn = torch.empty(b, inner, dtype=x.dtype, device=x.device)
    u = torch.empty(b, k2, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    plan, _ = stream_args(x, layer_launches(wq, wout, w1, w1_gate, w2, dm, inner), passes=True)
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
