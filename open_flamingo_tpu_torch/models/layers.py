"""Shared building blocks: LayerNorm with flax's fast variance, GELUs,
Dense, FeedForward and the einsum attention core.

Attention softmax always runs in fp32; projections run in the weights'
dtype (fp32 for parity tests, bf16 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import w8a8
from ..quantize import w8a8_weight

# torch.nn.LayerNorm's eps; checkpoint parity with the reference stack.
LN_EPS = 1e-5


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float = LN_EPS,
) -> torch.Tensor:
    """flax LayerNorm: fp32 stats with the fast variance
    max(0, E[x^2] - E[x]^2), fp32 scale and bias, cast back to x's dtype.
    (torch's own layer norm takes a two-pass variance.)"""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    mean2 = x32.square().mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=LN_EPS, bias=True, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw)) if bias else None

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Dense(nn.Linear):
    """nn.Linear with the W8A8 prefill product, the JAX package's
    `PDense.__call__`: the same parameters and state_dict; when
    `ops.w8a8.use_w8a8(x)` and the module carries int8 weights (`weight_q`
    int8, or the int4 grid's values, `quantize.w8a8_weight`), y =
    w8a8_dot(x, weight_q, weight_s, bias) in the weight's dtype; otherwise
    nn.Linear's product, bit for bit. The W8A8 product has no backward: it
    raises under autograd (the train step never enables it)."""

    def forward(self, x):
        if w8a8.use_w8a8(x):
            w_q = w8a8_weight(self)
            if w_q is not None:
                if torch.is_grad_enabled() and self.weight.requires_grad:
                    raise RuntimeError("Dense: the W8A8 product has no backward; call it under torch.no_grad()")
                return w8a8.w8a8_dot(x, w_q, self.weight_s, self.bias, out_dtype=self.weight.dtype)
        return super().forward(x)


class FeedForward(nn.Module):
    """LayerNorm -> Linear(mult*dim, no bias) -> GELU -> Linear(dim, no bias)."""

    def __init__(self, dim, mult=4, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = LayerNorm(dim, **kw)
        self.fc1 = Dense(dim, dim * mult, bias=False, **kw)
        self.fc2 = Dense(dim * mult, dim, bias=False, **kw)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(self.norm(x))))


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    zero_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Einsum attention core, the JAX package's `layers.attend`.

    q: (..., Tq, H, Dh), pre-scaled by the caller; k/v: (..., Tk, H, Dh).
    bias: broadcastable to (..., H, Tq, Tk). mask: bool, False = masked.
    zero_rows: bool broadcastable to (..., H, Tq, 1), True forces the row
    to zero after the softmax. Fully-masked rows come out uniform.
    """
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    return _softmax_v(logits, v, "...hqk,...khd->...qhd", bias, mask, zero_rows)


def _softmax_v(logits, v, eq, bias, mask, zero_rows):
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if zero_rows is not None:
        probs = probs.masked_fill(zero_rows, 0.0)
    return torch.einsum(eq, probs.to(v.dtype), v)


def attend_cached(q, k, v, *, bias=None, mask=None, zero_rows=None):
    """`attend` over the head-major cache layout: q (B, Tq, H, D),
    k/v (B, H, S, D); returns (B, Tq, H, D)."""
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float())
    return _softmax_v(logits, v, "bhqk,bhkd->bqhd", bias, mask, zero_rows)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., T, H*Dh) -> (..., T, H, Dh)."""
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., T, H, Dh) -> (..., T, H*Dh)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
