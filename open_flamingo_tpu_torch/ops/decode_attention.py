"""K7: single-token decode attention over the head-major KV cache.

Replaces `open_flamingo_tpu/ops/decode_attention.py` `decode_attention`
and `decode_attention_update` (`_decode_kernel` via `_call`). The CUDA
kernel is `csrc/decode_attention.cu` `decode_attention_fwd`: the keys of
each (b, h) are cut into `decode_plan(S, Dh, dtype).splits` chunks, one
block each, the blocks of a (b, h) one thread block cluster; each block
brings its chunk's K and V tiles into shared memory by bulk copies, takes
scores and P.V with lanes owning 16-byte columns, and rank 0 merges the
chunks' softmax partials through distributed shared memory, in one launch.
Bound by the cache bytes on the card (4 FLOPs per element read); see the
source's note. The plan depends on S, Dh and the dtype alone, so a (b, h)
row gives the same bits alone, in any batch and on every repeat.

`decode_attention_update` writes `k_new`/`v_new` into the cache tensors
IN PLACE at `slot` and attends with the new token in the same launch (the
counterpart of the TPU kernel's input/output aliasing); it returns the
same cache tensors it was given.

The wrappers launch the kernel for CUDA tensors and run the plain version
`reference_decode_attention` (after an in-place slot write, for the update)
for CPU tensors. A `torch.bool` mask goes to the kernel as its bytes, with
no conversion. Forward-only: both raise when autograd would need a
gradient through them (`dense_stream.refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .dense_stream import refuse_autograd
from .flash_attention import _DTYPES, check_qkv

DECODE_TILE = 64              # keys a ring stage holds (csrc/decode_attention.cu kTile)
DECODE_MAX_SPLITS = 8         # blocks of one (b, h): the portable cluster size (kMaxSplits)
DECODE_MAX_STAGES = 8         # kMaxStages
DECODE_MIN_TILES = 2          # tiles a split takes before the keys are cut further
DECODE_RING_BYTES = 32 * 1024  # the ring a block aims at (one stage at least): more blocks an SM

_lib = None


class DecodePlan(NamedTuple):
    chunk: int    # keys of each split (a multiple of DECODE_TILE); the last split takes the rest
    splits: int   # blocks of one (b, h), one cluster
    stages: int   # tiles of a block's ring in shared memory


@functools.lru_cache(maxsize=None)
def decode_plan(s: int, d: int, dtype: torch.dtype) -> DecodePlan:
    """K7's plan for a cache of S keys of Dh = d in `dtype`: S's 64-key
    tiles cut into splits of at least DECODE_MIN_TILES tiles, at most
    DECODE_MAX_SPLITS of them (past that the chunk grows), the splits
    evened out; a ring of as many tiles of a split as DECODE_RING_BYTES
    holds (one at least). A function of (S, Dh, dtype) alone, never of B or
    H, so a (b, h) row's sums add in one order in every launch."""
    row = -(-d * torch.tensor([], dtype=dtype).element_size() // 16) * 16   # a staged row's bytes
    tiles = max(1, -(-s // DECODE_TILE))
    splits = min(DECODE_MAX_SPLITS, max(1, tiles // DECODE_MIN_TILES))
    per = -(-tiles // splits)
    stages = min(per, max(1, DECODE_RING_BYTES // (2 * DECODE_TILE * row)), DECODE_MAX_STAGES)
    return DecodePlan(per * DECODE_TILE, -(-tiles // per), stages)


def bind(lib):
    """`lib` (csrc/decode_attention.cu built) with its C entry's argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, i, i, p]
    lib.decode_attention_fwd.restype = i
    return lib


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(build.library("decode_attention"))
    return _lib


def reference_decode_attention(q, k, v, mask, scale: float = 1.0, slopes=None, k_scale=None, v_scale=None):
    """Plain version. q (B, H, D); k/v (B, H, S, D); mask (B, S), nonzero
    = attend; slopes (H,) fp32 or None. All-masked rows give exact zeros.
    k_scale/v_scale (B, H, S): the row scales of an int8 cache, applied as
    the fused decode kernels do: to the logits after the dot product, and to
    the softmax weights before the sum over values."""
    refuse_autograd("decode_attention", q, k, v, slopes)
    s = k.shape[2]
    logits = torch.einsum("bhd,bhkd->bhk", q.float() * scale, k.float())
    if k_scale is not None:
        logits = logits * k_scale
    if slopes is not None:
        k_pos = torch.arange(s, device=q.device, dtype=torch.float32) - (s - 1)
        logits = logits + slopes.float()[None, :, None] * k_pos
    m = (mask != 0)[:, None, :]
    logits = logits.masked_fill(~m, float("-inf"))
    mx = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(mx), 0.0, mx)).masked_fill(~m, 0.0)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    p = p / denom
    if v_scale is not None:
        p = p * v_scale
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)


def _launch(q, k, v, mask, scale, slopes, k_new, v_new, slot, name):
    b, h, s, d = k.shape
    if q.shape != (b, h, d) or v.shape != k.shape or mask.shape != (b, s):
        raise ValueError(f"{name}: expected q (B, H, D), k/v (B, H, S, D), mask (B, S)")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_qkv(q, k, v, name)
    if mask.device != q.device or (slopes is not None and slopes.device != q.device):
        raise ValueError(f"{name}: mask/slopes on another device")
    if mask.dtype == torch.bool and mask.is_contiguous():
        m = mask.view(torch.uint8)          # its bytes are 0 / 1 already: no conversion kernel
    else:
        m = (mask != 0).to(torch.uint8).contiguous()
    sl = None
    if slopes is not None:
        sl = slopes.to(torch.float32).contiguous()
        if sl.shape != (h,):
            raise ValueError(f"{name}: slopes must be (H,)")
    kn = vn = None
    if k_new is not None:
        if k_new.shape != (b, h, d) or v_new.shape != (b, h, d):
            raise ValueError(f"{name}: k_new/v_new must be (B, H, D)")
        if k_new.dtype != k.dtype or v_new.dtype != k.dtype or k_new.device != q.device or v_new.device != q.device:
            raise TypeError(f"{name}: k_new/v_new must match the cache's dtype and device")
        if not 0 <= slot < s:
            raise ValueError(f"{name}: slot {slot} outside the cache of {s}")
        kn, vn = k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(q)
    plan = decode_plan(s, d, q.dtype)
    status = _kernel().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
        None if sl is None else sl.data_ptr(),
        None if kn is None else kn.data_ptr(), None if vn is None else vn.data_ptr(),
        out.data_ptr(), b, h, s, d, int(slot), float(scale), _DTYPES[q.dtype], *plan,
        build.current_stream(q.device),
    )
    build.check(status, "decode_attention_fwd")
    return out


def decode_attention(q, k, v, mask, *, scale: float = 1.0, slopes=None):
    """Attention only (static K/V, e.g. cached media). Returns (B, H, D)."""
    refuse_autograd("decode_attention", q, k, v, slopes)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, mask, scale, slopes)
    out = _launch(q, k, v, mask, scale, slopes, None, None, 0, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention_update(q, k_cache, v_cache, k_new, v_new, mask, slot: int, *, scale: float = 1.0, slopes=None):
    """Write-then-attend decode step; `mask` must mark `slot` valid.
    Mutates k_cache/v_cache in place and returns (out, k_cache, v_cache)."""
    refuse_autograd("decode_attention_update", q, k_cache, v_cache, k_new, v_new, slopes)
    if q.device.type == "cpu":
        k_cache[:, :, slot] = k_new
        v_cache[:, :, slot] = v_new
        return reference_decode_attention(q, k_cache, v_cache, mask, scale, slopes), k_cache, v_cache
    out = _launch(q, k_cache, v_cache, mask, scale, slopes, k_new, v_new, slot, "decode_attention_update")
    decode_attention_update.launches += 1
    return out, k_cache, v_cache


decode_attention.launches = 0
decode_attention_update.launches = 0
