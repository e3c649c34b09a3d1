"""PerceiverResampler: compress patch tokens into a fixed set of latents.

Input (b, T, F, v, D) patch tokens -> (b, T, num_latents, D). K/V of each
attention layer come from concat(media tokens, latents).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import FeedForward, LayerNorm, attend, merge_heads, split_heads


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head=64, heads=8, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm_media = LayerNorm(dim, **kw)
        self.norm_latents = LayerNorm(dim, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x, latents):
        # x: (b, T, n1, D) media features; latents: (b, T, n2, D)
        x = self.norm_media(x)
        latents = self.norm_latents(latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        q = split_heads(q, self.heads) * (self.dim_head**-0.5)
        out = attend(q, split_heads(k, self.heads), split_heads(v, self.heads))
        return self.to_out(merge_heads(out))


class PerceiverLayer(nn.Module):
    def __init__(self, dim, dim_head, heads, ff_mult, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = PerceiverAttention(dim, dim_head, heads, **kw)
        self.ff = FeedForward(dim, ff_mult, **kw)


class PerceiverResampler(nn.Module):
    """depth x (latent cross-attn + FF), residual, final LayerNorm."""

    def __init__(
        self, dim, depth=6, dim_head=64, heads=8, num_latents=64, ff_mult=4,
        *, device=None, dtype=None,
    ):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latents = nn.Parameter(torch.zeros(num_latents, dim, **kw))
        self.layers = nn.ModuleList(
            PerceiverLayer(dim, dim_head, heads, ff_mult, **kw) for _ in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f, v, d = x.shape
        x = x.reshape(b, t, f * v, d).to(self.latents.dtype)
        lat = self.latents.expand(b, t, *self.latents.shape)
        for layer in self.layers:
            lat = layer.attn(x, lat) + lat
            lat = layer.ff(lat) + lat
        return self.norm(lat)
