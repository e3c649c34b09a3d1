"""K1 fused_dense and K2 fused_mlp, the weight-streaming halves of the
single-token decode step, and the switch that routes a step through K1-K3.

Replaces `open_flamingo_tpu/ops/dense_stream.py` `fused_dense` (kernel
`_dense_kernel`) and `fused_mlp` (`_mlp_kernel`). The CUDA kernels are in
`csrc/dense_stream.cu`: one launch for K1, two for K2, whose (B, K2) hidden
activation goes through a scratch in x's dtype where the TPU kernel casts
it. In bf16 each launch runs the weight-streaming row GEMV of
`csrc/rows_stream.cuh` (a cp.async ring per warp into `mma.sync`, every row
up to 64 in one pass) on the plan `stream_plan` computes here from the
shape and the SM count and passes in: 256-column tiles, K cut into slices
of whole ring stages so that the tiles and slices fill the SMs, the split
K's fp32 partials in a scratch allocated here and added in slice order.
fp32 runs the CUDA-core row GEMV of `csrc/rows_gemv.cuh`. Both are bound by
the weight bytes on the card; see the sources' notes.

Weights are in torch's nn.Linear layout (out, in) and are read in place.
K1's `w` is (N, K): the JAX kernel's `w_transposed=True` form, which is
how the decode path calls it (the tied (V, D) embedding as the vocab head).
K2's `w1` (and SwiGLU's `w1_gate`) is (K2, K) and `w2` is (N, K2). The
semantics are the TPU kernels': `norm="layer"`, LayerNorm with the flax
fast variance, or `norm="rms"`, RMSNorm (x * rsqrt(mean(x^2) + eps) *
scale, no bias), in fp32; the normalised rows and K2's hidden activation
rounded to x's dtype before each product; fp32 accumulation; the epilogue
*w_scale -> +bias -> clip -> act -> *tanh(gate) -> +residual; the result in
x's dtype. `act` is one of `_ACTS`: exact GELU, gelu_new (tanh form), relu,
quick_gelu (CLIP) and silu. With `w1_gate` (llama's SwiGLU, `w1` its
gate_proj and `w1_gate` its up_proj) K2's hidden activation is
act(h @ w1.T * w1_scale + b1) * (h @ w1_gate.T * w1_gate_scale), computed in
K2's first launch from both weights streamed in one pass, then rounded.

A weight is in x's dtype, int8, or packed int4 (`torch.uint8`, (N, K/2),
`quantize.pack_int4`); an int weight comes with its per-out-channel fp32
scale (N,). Its values convert to x's dtype exactly (|q| <= 127) before the
product, and the scale multiplies the fp32 result first in the epilogue
(K2: `w1_scale` before b1 and the activation, `w2_scale` before b2).

K2b side tiles (`side_x`, `side_w`, ...; the JAX kernel's
`side_tile_compute`): an unrelated product rides K2's launch and fused_mlp
returns (y, side_out), side_out = act(LN?(side_x)) @ side_w.T + side_b +
side_residual, with the LayerNorm (flax fast variance) and the activation
in fp32, one rounding to side_x's dtype before the product, fp32
accumulation and one rounding of the result. side_w is (SN, SK) in torch's
layout and may be a view with a row stride (a slice of a ViT weight, read
in place); side_residual may have a row stride too. The tile runs as extra
blocks of K2's down-projection launch (`csrc/side_tile.cuh`), with main
weights of every type, and leaves y bit for bit as the launch without it
gives. In bf16, and in the W8A8 tile, each side block prepares 64 rows
once and streams W through a `wgmma` ring over a span of columns that
`side_span` computes from the shape and the SM count; its prepared rows
live in shared memory, which caps SK at 1,024, ViT-L/14's width
(`check_side_kernel` refuses more). `reference_side_tile` is its plain version; `reference_mlp` with
side operands returns the pair too. The W8A8 side tile (`side_w_scale`, the
TPU tile's `has_side_ws` branch, K2b int8): side_w int8 with its (SN,) fp32
scale; the activated rows stay fp32 (no rounding to side_x's dtype), are
quantized per row over SK (`ops.w8a8.quantize_activations`), and side_out =
float(q @ side_w.T) * s_act * side_w_scale + side_b + side_residual, rounded
once.

Route: `use_fused_decode` sends one query against a cache on a CUDA tensor
through K1-K3, where the JAX package asks for a TPU backend. The JAX
package's test hooks keep their meaning: `DISABLE_FUSED` keeps the unfused
route (K7 decode attention); `FORCE_FUSED` takes the fused route on CPU
tensors too, where each wrapper runs its plain version. On a CUDA tensor
the caller picks the kernel or its plain version with
`ops.attention.use_kernels` (`plain_path()`); the wrappers launch the
kernel for a CUDA tensor, run the plain version for a CPU one, and raise
for any other device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.layers import gelu_exact, layer_norm, quick_gelu
from ..quantize import weight_values
from . import build, w8a8
from .flash_attention import _DTYPES

FORCE_FUSED = False
DISABLE_FUSED = False

_ACTS = {None: 0, "gelu": 1, "gelu_new": 2, "relu": 3, "quick_gelu": 4, "silu": 5}   # csrc rows::Act
_NORMS = {"layer": 0, "rms": 1}                                                     # csrc rows::Norm
_WTYPES = {torch.int8: 1, torch.uint8: 2}   # 0: the weight in x's dtype
_WKINDS = {torch.int8: "int8", torch.uint8: "int4"}
# the fp32 operands: per-out-channel weight scales and int8-cache row scales
_SCALES = frozenset({"w_scale", "w1_scale", "w2_scale", "w1_gate_scale", "wq_scale", "wout_scale", "k_scale",
                     "v_scale"})
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(build.library("dense_stream"))
    return _lib


def bind(lib):
    """`lib` (csrc/dense_stream.cu built) with its C entries' argument types."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    split = [p, p, i]   # scratch, counters, their count
    lib.fused_dense_fwd.argtypes = [p] * 9 + [i, i, i, i, f, i, f, i, i, i, i, i] + split + [p]
    lib.fused_dense_fwd.restype = i
    mlp = [p] * 15 + [i, i, i, i, i, f, i, i, i, i, i, i, i, i] + split
    lib.fused_mlp_fwd.argtypes = mlp + [p]
    lib.fused_mlp_fwd.restype = i
    ll = ctypes.c_longlong
    side = [p, p, ll, p, p, p, f, i, p, p, ll, p, i, i, i, i]
    lib.fused_mlp_side_fwd.argtypes = mlp + side + [p]
    lib.fused_mlp_side_fwd.restype = i
    return lib


def fused_route(device) -> bool:
    """Whether single-token decode on `device` takes the fused route: on a
    CUDA device (any device under FORCE_FUSED), unless DISABLE_FUSED."""
    return not DISABLE_FUSED and (FORCE_FUSED or torch.device(device).type == "cuda")


def use_fused_decode(x: torch.Tensor, tq: int, cached: bool) -> bool:
    """Whether a forward on `x` with `tq` queries takes the fused decode
    route: one query against a cache, where `fused_route` says so."""
    return tq == 1 and cached and fused_route(x.device)


def refuse_autograd(fn: str, *tensors) -> None:
    """Raise when grad mode is on and an operand requires grad: the decode
    kernels have no backward, and their outputs carry no grad_fn."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{fn}: a decode kernel has no backward; call it under torch.no_grad()")


def check_prologue(fn: str, act, norm, ln_scale, ln_bias) -> None:
    """An activation of `_ACTS`, a norm of `_NORMS`, ln_bias only with
    ln_scale and only for a LayerNorm (ValueError)."""
    if act not in _ACTS:
        raise ValueError(f"{fn}: unknown activation {act!r}; expected one of {list(_ACTS)}")
    if norm not in _NORMS:
        raise ValueError(f"{fn}: unknown norm {norm!r}; expected one of {list(_NORMS)}")
    if ln_bias is not None and ln_scale is None:
        raise ValueError(f"{fn}: ln_bias needs ln_scale")
    if ln_bias is not None and norm == "rms":
        raise ValueError(f"{fn}: an RMSNorm takes no ln_bias")


def activation(y: torch.Tensor, act) -> torch.Tensor:
    """The TPU kernels' `_act_f32` on an fp32 tensor."""
    if act == "gelu":
        return gelu_exact(y)
    if act == "gelu_new":
        return F.gelu(y, approximate="tanh")
    if act == "relu":
        return torch.relu(y)
    if act == "quick_gelu":
        return quick_gelu(y)
    if act == "silu":
        return F.silu(y)
    return y


def normalize(x, ln_scale, ln_bias, eps, norm):
    """The kernels' prologue: x, its LayerNorm or its RMSNorm in fp32 times
    the scale, rounded to x's dtype."""
    if ln_scale is None:
        return x
    if norm == "layer":
        return layer_norm(x, ln_scale, ln_bias, eps)
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * ln_scale.float()).to(x.dtype)


def ptr(t):
    return None if t is None else t.data_ptr()


def wtype(w: torch.Tensor) -> int:
    """The kernels' weight type code: 0 x's dtype, 1 int8, 2 packed int4."""
    return _WTYPES.get(w.dtype, 0)


def variant(w: torch.Tensor, int8_cache: bool = False, tags=()) -> str:
    """The launch-counter key of a kernel variant: the weight's kind
    ("float", "int8", "int4"), "+kv8" with an int8 cache, then "+tag" for
    each tag that is not None (K1/K2: "rms", "swiglu", an activation other
    than exact GELU)."""
    return _WKINDS.get(w.dtype, "float") + ("+kv8" if int8_cache else "") + "".join(f"+{t}" for t in tags if t)


def form_tags(norm, act, gated: bool = False) -> tuple:
    """K1/K2's tags for `variant`: the RMSNorm, SwiGLU, a new activation."""
    return ("rms" if norm == "rms" else None, "swiglu" if gated else None, None if act in (None, "gelu") else act)


def count_launch(fn, key: str) -> None:
    """One launch of `fn`'s kernel: its count, and the count of its variant."""
    fn.launches += 1
    fn.variants[key] = fn.variants.get(key, 0) + 1


def check_weight(fn: str, name: str, w: torch.Tensor, scale, k: int) -> int:
    """Shape rules of a streamed (N, K) weight: in x's dtype, int8 (N, K) or
    packed int4 (N, K/2) uint8 with K even; an int weight comes with its
    (N,) scale and a weight in x's dtype with none. Raises ValueError;
    returns N."""
    if (w.dtype in _WTYPES) != (scale is not None):
        raise ValueError(f"{fn}: {name} is {w.dtype}; a per-channel scale goes with an int weight, and only there")
    if w.dtype == torch.uint8 and k % 2:
        raise ValueError(f"{fn}: int4 {name} needs an even reduction length, got {k}")
    n = w.shape[0]
    if w.dim() != 2 or w.shape[1] != (k // 2 if w.dtype == torch.uint8 else k):
        raise ValueError(f"{fn}: {name} {tuple(w.shape)} {w.dtype} does not match the reduction length {k}")
    if scale is not None and scale.shape != (n,):
        raise ValueError(f"{fn}: {name}'s scale must be ({n},), got {tuple(scale.shape)}")
    return n


def check_operands(fn: str, x: torch.Tensor, k: int, quantized=(), **tensors) -> None:
    """Kernel preconditions: x float32 or bfloat16 with rows of k elements,
    k a multiple of 8 (16-byte vector loads), and every other tensor
    operand on x's device, contiguous and 16-byte aligned, in x's dtype;
    except the names in `quantized`, which may also be int8 or uint8, and
    the weight and cache scales (`_SCALES`), which are float32."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype}; the kernels take float32 or bfloat16")
    if k % 8:
        raise ValueError(f"{fn}: reduction length {k} is not a multiple of 8")
    for name, t in dict(x=x, **tensors).items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if name in _SCALES:
            allowed = (torch.float32,)
        else:
            allowed = (x.dtype, *_WTYPES) if name in quantized else (x.dtype,)
        if t.dtype not in allowed:
            raise TypeError(f"{fn}: {name} is {t.dtype}; expected one of {allowed}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


# The weight-streaming row GEMV of csrc/rows_stream.cuh (every bf16 row GEMV
# of K1, K2, K3 and K6, the K2 and K3 carriers and K11's phases, each on its
# plan from `stream_args`): 256-column tiles (16 warps of 16 columns), up
# to 64 rows a pass, a ring per warp of 128 bytes of each of its rows a
# stage, a slice of h, the rows' statistics; one block per SM. Its
# instance for any B: 4 stages (2 of W and Wg gated), 128 KB, and a 64 KB h
# slice; for B <= 8: 6 stages (3 of W and Wg), 192 KB, and 32 KB of h.
STREAM_COLS, STREAM_ROWS, STREAM_SEG = 256, 64, 128
STREAM_SMEM = 16 * 4 * 16 * STREAM_SEG + 64 * 1024 + 2 * STREAM_ROWS * 4 + 16
STREAM_SMEM_SMALL = 16 * 6 * 16 * STREAM_SEG + 32 * 1024 + 2 * STREAM_ROWS * 4 + 16
SMEM_OPTIN = 232448                                  # sm_90's opt-in shared memory of a block
STREAM_COUNTERS = 1024                               # column tiles a launch may count: N <= 262,144
_WEIGHT_BITS = {"bf16": 16, "int8": 8, "int4": 4}
# the plan's cost of an item beyond its ring stages (its h slice, epilogue,
# partials and the ring's refill, ~1.3 us at an SM's share of 3.35 TB/s) and
# of a split K (the partials read back), in bytes of one block's stream. At
# 24 KB an item, K3's Wqkv (6,144 x 2,048 bf16) went in two waves of 3-stage
# items, slower on the card than one wave of 7-stage items; 32 KB moves that
# plan alone among the decode path's shapes on 132 SMs
_ITEM_COST, _SPLIT_COST = 32 * 1024, 16 * 1024


class StreamPlan(NamedTuple):
    """How the weight-streaming body cuts an (N, K) product: `tiles`
    256-column tiles, K in `stages` ring stages of `stage_elems` values,
    `slices` K slices of `slice` stages (the last may be shorter), `items`
    = tiles x slices walked by `blocks` persistent blocks."""
    tiles: int
    stage_elems: int
    stages: int
    slice: int
    slices: int
    items: int
    blocks: int


def weight_kind(w: torch.Tensor) -> str:
    """The stored type of a streamed weight: "bf16" (x's dtype), "int8",
    "int4" (packed)."""
    return _WKINDS.get(w.dtype, "bf16")


def stream_ring(b: int, gated: bool) -> tuple:
    """The ring of the instance that runs b rows: (stages a warp, bytes of
    the ring, the block's shared memory), csrc/rows_stream.cuh `Geometry`."""
    small = b <= 8
    stages = (3 if gated else 6) if small else (2 if gated else 4)
    ring = 16 * stages * 16 * STREAM_SEG * (2 if gated else 1)
    return stages, ring, STREAM_SMEM_SMALL if small else STREAM_SMEM


@functools.lru_cache(maxsize=None)
def stream_plan(n: int, k: int, wkind: str, sms: int) -> StreamPlan:
    """The weight-streaming body's plan for N columns over K of a weight
    stored as `wkind` ("bf16", "int8", "int4") on `sms` SMs. K is cut into
    the slice count whose items fill the SMs at the least cost: waves of
    items x (an item's stage bytes + a fixed cost per item), plus the split's
    partials; ties to fewer slices. A function of (N, K, the weight type,
    the SM count) alone: never of B, the gated form or a launch's grid, so
    a column's sums add in one order in every launch, K2b carrier and K11
    phase of a shape."""
    stage_elems = STREAM_SEG * 8 // _WEIGHT_BITS[wkind]
    stages = -(-k // stage_elems)
    tiles = -(-n // STREAM_COLS)
    block_stage = STREAM_COLS * STREAM_SEG
    best = None
    for want in range(1, stages + 1):
        per = -(-stages // want)
        slices = -(-stages // per)
        if slices != want:
            continue
        items = tiles * slices
        cost = -(-items // sms) * (per * block_stage + _ITEM_COST) + (_SPLIT_COST if slices > 1 else 0)
        if best is None or cost < best[0]:
            best = (cost, per, slices, items)
    _, per, slices, items = best
    return StreamPlan(tiles, stage_elems, stages, per, slices, items, min(items, sms))


def stream_items(plan: StreamPlan, n: int, k: int):
    """The items of `plan` as the kernel walks them: (columns [c0, c1), K
    values [k0, k1)) per item, item i being column tile i // slices and K
    slice i % slices."""
    for i in range(plan.items):
        t, s = divmod(i, plan.slices)
        st0, st1 = s * plan.slice, min((s + 1) * plan.slice, plan.stages)
        yield (t * STREAM_COLS, min((t + 1) * STREAM_COLS, n)), (st0 * plan.stage_elems, min(st1 * plan.stage_elems, k))


def stream_scratch_floats(plan: StreamPlan, b: int, gated: bool) -> int:
    """fp32 partials a split K writes for up to 64 rows of b: slices x
    tiles x 256 columns x the rows rounded up to 8 (twice when gated); 0
    without a split."""
    if plan.slices == 1:
        return 0
    rows = 8 * -(-min(b, STREAM_ROWS) // 8)
    return plan.slices * plan.tiles * STREAM_COLS * rows * (2 if gated else 1)


_COUNTERS, _SCRATCH = {}, {}


def stream_counters(device) -> torch.Tensor:
    """The per-tile arrival counts of a split K on `device`: zeros, which
    every launch leaves zero. One tensor per device, made on first use
    outside a CUDA graph capture (inside one, a capture-local tensor); the
    port launches K1, K2, K3 and K6 on one stream at a time."""
    idx = torch.device(device).index
    if idx in _COUNTERS:
        return _COUNTERS[idx]
    counters = torch.zeros(STREAM_COUNTERS, dtype=torch.int32, device=device)
    if not torch.cuda.is_current_stream_capturing():
        _COUNTERS[idx] = counters
    return counters


def stream_scratch(device, floats: int) -> torch.Tensor:
    """At least `floats` fp32 of scratch for a split K's partials on
    `device`: one buffer per device, grown when a launch needs more, kept
    when made outside a CUDA graph capture; launches on one stream use it
    in turn, as they use the counters."""
    idx = torch.device(device).index
    buf = _SCRATCH.get(idx)
    if buf is not None and buf.numel() >= floats:
        return buf
    buf = torch.empty(floats, dtype=torch.float32, device=device)
    if not torch.cuda.is_current_stream_capturing():
        _SCRATCH[idx] = buf
    return buf


def stream_launches(b: int, launches, sms: int, passes: bool = False) -> tuple:
    """The plans of bf16 launches ((n, k, weight kind, gated), ...) for b
    rows on `sms` SMs: ((slice, blocks) per launch, flattened; the fp32
    scratch floats the largest split needs, for every pass of 64 rows of b
    with `passes`, K11's phases, which keep each pass's partials). The plans
    do not depend on b."""
    plans = [(stream_plan(n, k, wkind, sms), gated) for n, k, wkind, gated in launches]
    if any(p.tiles > STREAM_COUNTERS for p, _ in plans):
        raise ValueError(f"the row GEMV counts at most {STREAM_COUNTERS} column tiles of {STREAM_COLS}")
    floats = max(stream_scratch_floats(p, b, gated) for p, gated in plans)
    return (tuple(v for p, _ in plans for v in (p.slice, p.blocks)),
            floats * (-(-b // STREAM_ROWS) if passes else 1))


_ARGS = {}


def stream_args(x: torch.Tensor, launches, passes: bool = False) -> tuple:
    """The C interface's plan arguments for bf16 launches (n, k, weight,
    gated) on x's device: (slice, blocks) per launch, then the scratch
    (`stream_scratch`, room for the largest split; with `passes`, for every
    pass of 64 rows, as K11 keeps them), the counters and their count; and
    the scratch tensor. Zeros and nulls for fp32, which takes no plan. Kept
    per (B, device, shapes) outside a CUDA graph capture: a decode step asks
    for the same few every layer."""
    if x.dtype != torch.bfloat16:
        return (0, 0) * len(launches) + (None, None, 0), None
    key = (x.shape[0], x.device.index, passes, *[(n, k, w.dtype, gated) for n, k, w, gated in launches])
    hit = _ARGS.get(key)
    if hit is not None:
        return hit
    flat, floats = stream_launches(x.shape[0], tuple((n, k, weight_kind(w), gated) for n, k, w, gated in launches),
                                   _sm_count(x.device), passes)
    if floats:
        scratch = stream_scratch(x.device, floats)
        hit = flat + (ptr(scratch), ptr(stream_counters(x.device)), STREAM_COUNTERS), scratch
    else:
        hit = flat + (None, None, 0), None
    if not torch.cuda.is_current_stream_capturing():
        _ARGS[key] = hit
    return hit


def _product(h, w, scale):
    y = h.float() @ weight_values(w).float().t()
    return y if scale is None else y * scale.float()


def reference_dense(x, w, *, w_scale=None, bias=None, ln_scale=None, ln_bias=None, eps=1e-5, norm="layer", act=None,
                    clip=None, residual=None, gate=None, w_gate=None, w_gate_scale=None):
    """Plain version of fused_dense, at the kernel's rounding points; with
    w_gate, the gated form of K2's first launch: the activation times
    h @ w_gate.T * w_gate_scale."""
    refuse_autograd("fused_dense", x, w, bias, ln_scale, ln_bias, residual, gate, w_gate)
    h = normalize(x, ln_scale, ln_bias, eps, norm)
    y = _product(h, w, w_scale)
    if bias is not None:
        y = y + bias.float()
    if clip is not None:
        y = y.clamp(-clip, clip)
    y = activation(y, act)
    if w_gate is not None:
        y = y * _product(h, w_gate, w_gate_scale)
    if gate is not None:
        y = y * torch.tanh(gate.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def side_activations(side_x, side_ln=None, side_eps=1e-5, side_act=None) -> torch.Tensor:
    """A side tile's rows before its product: act(LN?(side_x)) in fp32, the
    LayerNorm with the flax fast variance."""
    h = side_x.float()
    if side_ln is not None:
        mean = h.mean(-1, keepdim=True)
        var = torch.clamp(h.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        h = (h - mean) * torch.rsqrt(var + side_eps) * side_ln[0].float()
        if side_ln[1] is not None:
            h = h + side_ln[1].float()
    return activation(h, side_act)


def reference_side_tile(side_x, side_w, *, side_w_scale=None, side_ln=None, side_eps=1e-5, side_act=None,
                        side_b=None, side_residual=None):
    """Plain version of a K2b side tile: `side_activations`; rounded to
    side_x's dtype, @ side_w.T in fp32; or, with side_w_scale (the W8A8
    tile), quantized per row and float(q @ side_w.T) * s_act * side_w_scale
    (the int32 sum exact); then + side_b, + side_residual, rounded."""
    h = side_activations(side_x, side_ln, side_eps, side_act)
    if side_w_scale is None:
        y = h.to(side_x.dtype).float() @ side_w.float().t()
    else:
        q, s_act = w8a8.quantize_activations(h)
        y = w8a8.int8_matmul(q, side_w.contiguous()) * s_act * side_w_scale
    if side_b is not None:
        y = y + side_b.float()
    if side_residual is not None:
        y = y + side_residual.float()
    return y.to(side_x.dtype)


def check_side(x, side_x, side_w, side_ln, side_act, side_b, side_residual, side_w_scale, fn="fused_mlp") -> None:
    """Shape rules of K2b's operands (ValueError): side_w in x's dtype, or
    int8 with its (SN,) fp32 side_w_scale (the W8A8 tile), and no scale
    beside a float side_w."""
    if side_w is None:
        raise ValueError(f"{fn}: side_x needs side_w")
    if side_act not in _ACTS:
        raise ValueError(f"{fn}: unknown side activation {side_act!r}; expected one of {list(_ACTS)}")
    if side_x.dim() != 2 or side_w.dim() != 2 or side_w.shape[1] != side_x.shape[1]:
        raise ValueError(f"{fn}: side_x {tuple(side_x.shape)} against side_w (SN, SK) {tuple(side_w.shape)}")
    m, sk = side_x.shape
    sn = side_w.shape[0]
    if (side_w.dtype == torch.int8) != (side_w_scale is not None):
        raise ValueError(f"{fn}: side_w is {side_w.dtype}; side_w_scale goes with an int8 side_w (the W8A8 tile), "
                         "and only there")
    if side_w_scale is not None and (side_w_scale.shape != (sn,) or side_w_scale.dtype != torch.float32
                                     or side_w_scale.device != x.device):
        raise ValueError(f"{fn}: side_w_scale must be ({sn},) float32 on {x.device}")
    if side_ln is not None and (side_ln[0].shape != (sk,) or (side_ln[1] is not None and side_ln[1].shape != (sk,))):
        raise ValueError(f"{fn}: side_ln must be ({sk},) scale and bias")
    if side_b is not None and side_b.shape != (sn,):
        raise ValueError(f"{fn}: side_b must be ({sn},), got {tuple(side_b.shape)}")
    if side_residual is not None and side_residual.shape != (m, sn):
        raise ValueError(f"{fn}: side_residual must be ({m}, {sn}), got {tuple(side_residual.shape)}")
    for name, t in dict(side_x=side_x, side_w=side_w, side_b=side_b, side_residual=side_residual,
                        side_ln_scale=None if side_ln is None else side_ln[0],
                        side_ln_bias=None if side_ln is None else side_ln[1]).items():
        want = torch.int8 if name == "side_w" and side_w_scale is not None else x.dtype
        if t is not None and (t.dtype != want or t.device != x.device):
            raise ValueError(f"{fn}: {name} is {t.dtype} on {t.device}; expected {want} on {x.device}")


# The ring tile of csrc/side_tile.cuh (bf16 and W8A8): 64-row blocks
# (models/absorb_vit.py rounds M to them), passes of 256 columns, and SK up
# to 1,024 (`kMaxK`: a row in a warp's registers, the prepared rows and the
# W ring in a block's shared memory).
SIDE_ROWS, SIDE_PASS, SIDE_MAX_K = 64, 256, 1024


def ring_tile(dtype, int8_tile: bool) -> bool:
    """Whether a side tile runs the ring body: bf16, and W8A8 in either
    dtype (fp32 in x's dtype keeps the 64 x 64 CUDA-core tile)."""
    return int8_tile or dtype != torch.float32


def side_span(m: int, sn: int, sms: int) -> int:
    """The columns each ring block owns: all of SN (whole passes) when the
    row blocks alone fill the `sms` SMs, else the widest equal split of SN's
    passes that gives at least `sms` blocks, else one pass. Depends on the
    shape and the SM count only."""
    row_blocks, passes = -(-m // SIDE_ROWS), -(-sn // SIDE_PASS)
    for per in range(passes, 0, -1):
        if passes % per == 0 and row_blocks * (passes // per) >= sms:
            return per * SIDE_PASS
    return SIDE_PASS


_SMS = {}


def _sm_count(device) -> int:
    """The SM count of a CUDA device, read once."""
    idx = torch.device(device).index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[idx]


def check_side_kernel(side_x, side_w, side_w_scale, side_ln, side_b, side_residual, fn="fused_mlp") -> None:
    """The side tile kernel's preconditions: SK a multiple of 32 and, for
    the ring tile, at most SIDE_MAX_K; side_x and the vectors contiguous,
    side_w and side_residual with a contiguous last dim and rows a multiple
    of 16 bytes apart, everything 16-byte aligned."""
    sk = side_x.shape[1]
    if sk % 32:
        raise ValueError(f"{fn}: the side tile kernel takes SK a multiple of 32, got {sk}")
    int8_tile = side_w_scale is not None
    if ring_tile(side_x.dtype, int8_tile) and sk > SIDE_MAX_K:
        kind = "W8A8" if int8_tile else "bf16"
        raise ValueError(f"{fn}: the {kind} side tile keeps its {SIDE_ROWS} rows of SK in a warp's registers and "
                         f"in shared memory beside its W ring, which hold SK up to {SIDE_MAX_K}; got SK {sk}")
    vectors = [side_x, side_b, side_w_scale] + ([] if side_ln is None else list(side_ln))
    for t in (t for t in vectors if t is not None):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: side_x, side_ln, side_b and side_w_scale must be contiguous and 16-byte aligned")
    for name, t in (("side_w", side_w), ("side_residual", side_residual)):
        if t is not None and (t.stride(1) != 1 or t.stride(0) * t.element_size() % 16 or t.data_ptr() % 16):
            raise ValueError(f"{fn}: {name} needs unit column stride, rows a multiple of 16 bytes apart "
                             "and 16-byte aligned data")


def side_operands(side_x, side_w, side_w_scale, side_ln, side_eps, side_act, side_b, side_residual) -> tuple:
    """The side tile's arguments of the C interface (fused_mlp_side_fwd,
    attn_block_decode_side_fwd) and its output, allocated here."""
    m, sn = side_x.shape[0], side_w.shape[0]
    side_out = torch.empty(m, sn, dtype=side_x.dtype, device=side_x.device)
    ln_s, ln_b = side_ln if side_ln is not None else (None, None)
    args = (ptr(side_x), ptr(side_w), side_w.stride(0), ptr(side_w_scale), ptr(ln_s), ptr(ln_b), float(side_eps),
            _ACTS[side_act], ptr(side_b), ptr(side_residual), 0 if side_residual is None else side_residual.stride(0),
            ptr(side_out), m, sn, side_x.shape[1], side_span(m, sn, _sm_count(side_x.device)))
    return args, side_out


def side_tag(side_w_scale) -> str:
    """The launch-counter tag of a carried tile: "side", or "side8" for the
    W8A8 tile."""
    return "side" if side_w_scale is None else "side8"


def reference_mlp(x, w1, w2, *, w1_gate=None, w1_scale=None, w2_scale=None, w1_gate_scale=None, b1=None, b2=None,
                  ln_scale=None, ln_bias=None, eps=1e-5, norm="layer", act="gelu", residual=None, gate=None,
                  side_x=None, side_w=None, side_w_scale=None, side_ln=None, side_eps=1e-5, side_act=None,
                  side_b=None, side_residual=None):
    """Plain version of fused_mlp: the hidden activation in x's dtype; with
    side_x, (y, reference_side_tile(...))."""
    u = reference_dense(x, w1, w_scale=w1_scale, bias=b1, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps, norm=norm,
                        act=act, w_gate=w1_gate, w_gate_scale=w1_gate_scale)
    y = reference_dense(u, w2, w_scale=w2_scale, bias=b2, residual=residual, gate=gate)
    if side_x is None:
        return y
    check_side(x, side_x, side_w, side_ln, side_act, side_b, side_residual, side_w_scale)
    return y, reference_side_tile(side_x, side_w, side_w_scale=side_w_scale, side_ln=side_ln, side_eps=side_eps,
                                  side_act=side_act, side_b=side_b, side_residual=side_residual)


def fused_dense(x, w, *, w_scale=None, bias=None, ln_scale=None, ln_bias=None, eps=1e-5, norm="layer",
                act=None, clip=None, residual=None, gate=None):
    """epilogue(norm?(x) @ w.T): x (B, K); w (N, K) in x's dtype or int8, or
    (N, K/2) packed int4, an int weight with w_scale (N,) fp32; bias (N,);
    ln_scale and ln_bias (K,), the LayerNorm's (norm="layer") or the
    RMSNorm's scale alone (norm="rms"); residual (B, N); gate (1,), applied
    as *tanh(gate). Returns (B, N) in x's dtype."""
    refuse_autograd("fused_dense", x, w, bias, ln_scale, ln_bias, residual, gate)
    check_prologue("fused_dense", act, norm, ln_scale, ln_bias)
    b, k = x.shape
    n = check_weight("fused_dense", "w", w, w_scale, k)
    if residual is not None and residual.shape != (b, n):
        raise ValueError(f"fused_dense: expected residual (B, N) = ({b}, {n}); got {tuple(residual.shape)}")
    if x.device.type == "cpu":
        return reference_dense(x, w, w_scale=w_scale, bias=bias, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
                               norm=norm, act=act, clip=clip, residual=residual, gate=gate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense: unsupported device {x.device}")
    check_operands("fused_dense", x, k, quantized=("w",), w=w, w_scale=w_scale, bias=bias, ln_scale=ln_scale,
                   ln_bias=ln_bias, residual=residual, gate=gate)
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    plan, _ = stream_args(x, [(n, k, w, False)])
    status = _kernel().fused_dense_fwd(
        ptr(x), ptr(w), ptr(w_scale), ptr(bias), ptr(ln_scale), ptr(ln_bias), ptr(residual), ptr(gate), ptr(out),
        b, n, k, int(clip is not None), float(clip or 0.0), _ACTS[act], float(eps), _NORMS[norm], _DTYPES[x.dtype],
        wtype(w), *plan, build.current_stream(x.device),
    )
    build.check(status, "fused_dense_fwd")
    count_launch(fused_dense, variant(w, tags=form_tags(norm, act)))
    return out


def fused_mlp(x, w1, w2, *, w1_gate=None, w1_scale=None, w2_scale=None, w1_gate_scale=None, b1=None, b2=None,
              ln_scale=None, ln_bias=None, eps=1e-5, norm="layer", act="gelu", residual=None, gate=None,
              side_x=None, side_w=None, side_w_scale=None, side_ln=None, side_eps=1e-5, side_act=None, side_b=None,
              side_residual=None):
    """residual + tanh(gate) * (u @ w2.T * w2_scale + b2), u = act(norm?(x)
    @ w1.T * w1_scale + b1), times norm?(x) @ w1_gate.T * w1_gate_scale with
    w1_gate (SwiGLU): x (B, K); w1, w1_gate (K2, K); w2 (N, K2), each in x's
    dtype, int8 or packed int4 (last dim halved) with its fp32 scale (K2,) /
    (N,), w1 and w1_gate in one stored type. Returns (B, N) in x's dtype.

    With side_x (M, SK) and side_w (SN, SK), both in x's dtype: the K2b side
    tile act(LN?(side_x)) @ side_w.T + side_b + side_residual in the same
    launch; side_ln (scale, bias or None) (SK,), side_act one of `_ACTS`,
    side_b (SN,), side_residual (M, SN); side_w int8 with side_w_scale (SN,)
    fp32: the W8A8 tile. Returns (y, side_out (M, SN))."""
    if side_x is None and any(t is not None for t in (side_w, side_w_scale, side_ln, side_b, side_residual)):
        raise ValueError("fused_mlp: side operands need side_x")
    refuse_autograd("fused_mlp", x, w1, w2, w1_gate, b1, b2, ln_scale, ln_bias, residual, gate, side_x, side_w,
                    side_b, side_residual)
    check_prologue("fused_mlp", act, norm, ln_scale, ln_bias)
    b, k = x.shape
    k2 = check_weight("fused_mlp", "w1", w1, w1_scale, k)
    n = check_weight("fused_mlp", "w2", w2, w2_scale, k2)
    if w1_gate is None and w1_gate_scale is not None:
        raise ValueError("fused_mlp: w1_gate_scale needs w1_gate")
    if w1_gate is not None:
        if w1_gate.dtype != w1.dtype:
            raise ValueError(f"fused_mlp: w1 is {w1.dtype} and w1_gate {w1_gate.dtype}; they share one stored type")
        if check_weight("fused_mlp", "w1_gate", w1_gate, w1_gate_scale, k) != k2:
            raise ValueError(f"fused_mlp: w1_gate {tuple(w1_gate.shape)} does not match w1 {tuple(w1.shape)}")
    if residual is not None and residual.shape != (b, n):
        raise ValueError(f"fused_mlp: expected residual (B, N) = ({b}, {n}); got {tuple(residual.shape)}")
    if x.device.type == "cpu":
        return reference_mlp(x, w1, w2, w1_gate=w1_gate, w1_scale=w1_scale, w2_scale=w2_scale,
                             w1_gate_scale=w1_gate_scale, b1=b1, b2=b2, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
                             norm=norm, act=act, residual=residual, gate=gate, side_x=side_x, side_w=side_w,
                             side_w_scale=side_w_scale, side_ln=side_ln, side_eps=side_eps, side_act=side_act,
                             side_b=side_b, side_residual=side_residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    check_operands("fused_mlp", x, k, quantized=("w1", "w1_gate", "w2"), w1=w1, w1_gate=w1_gate, w2=w2,
                   w1_scale=w1_scale, w1_gate_scale=w1_gate_scale, w2_scale=w2_scale, b1=b1, b2=b2,
                   ln_scale=ln_scale, ln_bias=ln_bias, residual=residual, gate=gate)
    if k2 % 8:
        raise ValueError(f"fused_mlp: hidden size {k2} is not a multiple of 8")
    hidden = torch.empty(b, k2, dtype=x.dtype, device=x.device)
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    plan, _ = stream_args(x, [(k2, k, w1, w1_gate is not None), (n, k2, w2, False)])
    args = (ptr(x), ptr(w1), ptr(w1_gate), ptr(w2), ptr(w1_scale), ptr(w1_gate_scale), ptr(w2_scale), ptr(b1), ptr(b2),
            ptr(ln_scale), ptr(ln_bias), ptr(residual), ptr(gate), ptr(hidden), ptr(out), b, k, k2, n, _ACTS[act],
            float(eps), _NORMS[norm], _DTYPES[x.dtype], wtype(w1), wtype(w2), *plan)
    tags = form_tags(norm, act, w1_gate is not None)
    if side_x is None:
        build.check(_kernel().fused_mlp_fwd(*args, build.current_stream(x.device)), "fused_mlp_fwd")
        count_launch(fused_mlp, variant(w1, tags=tags))
        return out
    check_side(x, side_x, side_w, side_ln, side_act, side_b, side_residual, side_w_scale)
    check_side_kernel(side_x, side_w, side_w_scale, side_ln, side_b, side_residual)
    sargs, side_out = side_operands(side_x, side_w, side_w_scale, side_ln, side_eps, side_act, side_b, side_residual)
    status = _kernel().fused_mlp_side_fwd(*args, *sargs, build.current_stream(x.device))
    build.check(status, "fused_mlp_side_fwd")
    count_launch(fused_mlp, variant(w1, tags=tags + (side_tag(side_w_scale),)))
    return out, side_out


fused_dense.launches = 0
fused_mlp.launches = 0
fused_dense.variants = {}
fused_mlp.variants = {}
