"""Gated cross-attention: text queries attend to media latents.

Media-time rule (the reference's helpers.py): media_time[j] = j + 1 for
the j-th image; text_time[i] = cumsum(media_locations)[i] in a full
forward, or the number of cached media in decode. Attend iff text_time ==
media_time ("immediate", the released models) or text_time >= media_time;
in immediate mode text with text_time 0 gets a zero attention output.

The media K/V are projected once at prefill and returned to the caller
(the JAX package's `sow("media_kv")`); decode steps pass them back in.
A multi-token immediate-mode forward on the card runs K5 `masked_xattn`
(under autograd with its backward K5b); the einsum path zeroes the rows
with text_time 0 after the softmax, so they get zero gradient too.
One decode token on the card takes the fused route in immediate mode: K3
`attn_block_decode` in its q-only form (LN, q projection, masked softmax
over the cached media K/V, out-projection, *tanh(attn_gate) + x), then K2
`fused_mlp` (*tanh(ff_gate) + x), streaming to_q/to_out and fc1/fc2 or their
int8 / int4 copies (`quantize.stream_weight`); in an absorbing decode step
the K2 launch (and with `absorb_vit.ATTN_CARRIERS` the K3 launch) carries a
K2b side tile of the next batch's ViT (`absorb_vit.carry`). The media K/V are a pair
(k, v), or with an int8 media cache (k, v, k_s, v_s): int8 rows with their
(B, H, S_m) fp32 scales, which the fused route reads as they are and every
other route dequantizes. With `ops.fused_layer.use_for_xattn()` (`DISABLE =
False` or `XATTN_ONLY`) the whole gated block is one K11
`fused_layer_decode` launch in its q-only form, as in the JAX package: not
over an int8 media cache and not in an absorbing step, which keep K3 + K2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import fused_layer
from ..ops.attention import use_kernels
from ..ops.decode_layer import attn_block_decode, reference_attn_block
from ..ops.dense_stream import fused_mlp, reference_mlp, use_fused_decode
from ..ops.fused_layer import fused_layer_decode, reference_fused_layer
from ..quantize import stream_weight
from .absorb_vit import carry
from .decoders.common import dequantize_kv
from .layers import Dense, FeedForward, LayerNorm, attend_cached, merge_heads, split_heads


def media_time_from_locations(media_locations: torch.Tensor) -> torch.Tensor:
    """text_time for a full forward: (B, T) bool -> (B, T) cumulative count."""
    return torch.cumsum(media_locations.long(), dim=-1)


def use_xattn_kernel(x: torch.Tensor, immediate: bool) -> bool:
    """Whether prefill cross-attention on text `x` (B, T, D) runs the K5
    kernel."""
    return immediate and x.shape[1] >= 8 and use_kernels(x)


def _media_time(t_img: int, n_lat: int, device) -> torch.Tensor:
    return torch.arange(t_img * n_lat, device=device) // n_lat + 1


def decode_media_mask(text_time, t_img: int, n_lat: int) -> torch.Tensor:
    """(B, T_img*n_lat) immediate-mode mask of one decode token per
    sequence (text_time is constant within a step). Text with no preceding
    image has no valid latent: the decode kernels give it exact zeros.
    Layer-independent: built once per step."""
    return text_time[:, :1] == _media_time(t_img, n_lat, text_time.device)[None, :]


def build_media_masks(text_time, t_img: int, n_lat: int, immediate: bool):
    """Einsum-path media mask (B, 1, T_txt, T_img*n_lat) and, in immediate
    mode, the zero_rows flags (B, 1, T_txt, 1). Layer-independent: built
    once per forward."""
    tt = text_time[:, None, :, None]
    mt = _media_time(t_img, n_lat, text_time.device)[None, None, None, :]
    if immediate:
        return tt == mt, (text_time == 0)[:, None, :, None]
    return tt >= mt, None


class MaskedCrossAttention(nn.Module):
    def __init__(self, dim, dim_visual, dim_head=64, heads=8, only_attend_immediate_media=True, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.immediate = only_attend_immediate_media
        self.norm = LayerNorm(dim, **kw)
        self.to_q = Dense(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim_visual, 2 * inner, bias=False, **kw)
        self.to_out = Dense(inner, dim, bias=False, **kw)

    def project_media(self, media: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T_img, n_lat, D_vis) -> head-major (k, v), each (B, H, S_m, Dh)."""
        b, t_img, n_lat, dv = media.shape
        k, v = self.to_kv(media.reshape(b, t_img * n_lat, dv)).chunk(2, dim=-1)
        return (
            split_heads(k, self.heads).transpose(1, 2).contiguous(),
            split_heads(v, self.heads).transpose(1, 2).contiguous(),
        )

    def forward(
        self,
        x: torch.Tensor,                 # (B, T_txt, D)
        media: torch.Tensor,             # (B, T_img, n_lat, D_vis)
        text_time: torch.Tensor,         # (B, T_txt)
        media_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        media_mask: Optional[torch.Tensor] = None,
        zero_rows: Optional[torch.Tensor] = None,
    ):
        """Returns (out (B, T_txt, D), media_kv)."""
        b, t_img, n_lat, _ = media.shape
        if media_kv is None:
            media_kv = self.project_media(media)
        k, v = media_kv[:2]
        if len(media_kv) == 4:              # an int8 media cache off the fused route
            k, v = dequantize_kv(k, media_kv[2], x.dtype), dequantize_kv(v, media_kv[3], x.dtype)
        q = split_heads(self.to_q(self.norm(x)), self.heads)
        h, d, s, tq = self.heads, self.dim_head, t_img * n_lat, q.shape[1]
        scale = self.dim_head**-0.5
        if use_xattn_kernel(x, self.immediate):
            from ..ops.masked_xattn import masked_xattn

            qf = q.transpose(1, 2).reshape(b * h, tq, d).contiguous()
            tt = text_time.to(torch.int32).repeat_interleave(h, dim=0)
            out = masked_xattn(qf, k.reshape(b * h, s, d), v.reshape(b * h, s, d), tt, n_lat, scale)
            out = out.reshape(b, h, tq, d).transpose(1, 2)
        elif tq == 1 and self.immediate and use_kernels(x):
            # one decode token: one mask row per sequence; text with no
            # preceding image is an all-masked row -> exact zeros
            from ..ops.decode_attention import decode_attention

            mask2d = decode_media_mask(text_time, t_img, n_lat)
            out = decode_attention(q[:, 0].contiguous(), k, v, mask2d, scale=scale)[:, None]
        else:
            if media_mask is None:
                media_mask, zero_rows = build_media_masks(text_time, t_img, n_lat, self.immediate)
            out = attend_cached(q * scale, k, v, mask=media_mask, zero_rows=zero_rows)
        return self.to_out(merge_heads(out)), media_kv

    def fused_decode(self, x, media_kv, mask2d, gate, side=None):
        """x (B, D) + tanh(gate) * attention of x over the cached media K/V
        (B, H, S_m, Dh) under mask2d (B, S_m): K3 in its q-only form, carrying
        the next tile of `side` when the plan counts attention carriers."""
        k, v, k_s, v_s = (*media_kv, None, None)[:4]
        (w_q, s_q), (w_out, s_out) = stream_weight(self.to_q), stream_weight(self.to_out)
        attn_half = attn_block_decode if use_kernels(x) else reference_attn_block
        return carry(
            side, attn_half, x, self.norm.weight, self.norm.bias, w_q, w_out, k, v, mask2d, heads=self.heads,
            head_dim=self.dim_head, scale=self.dim_head**-0.5, gate=gate, wq_scale=s_q, wout_scale=s_out,
            k_scale=k_s, v_scale=v_s, eps=self.norm.eps, attn=True,
        )


class GatedCrossAttentionBlock(nn.Module):
    """x = xattn(x) * tanh(attn_gate) + x; x = ff(x) * tanh(ff_gate) + x."""

    def __init__(self, dim, dim_visual, dim_head=64, heads=8, ff_mult=4, only_attend_immediate_media=True, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_gate = nn.Parameter(torch.zeros(1, **kw))
        self.ff_gate = nn.Parameter(torch.zeros(1, **kw))
        self.attn = MaskedCrossAttention(dim, dim_visual, dim_head, heads, only_attend_immediate_media, **kw)
        self.ff = FeedForward(dim, ff_mult, **kw)

    def forward(self, x, media, text_time, media_kv=None, media_mask=None, zero_rows=None, side=None):
        """Returns (x, media_kv). On the fused decode route `media_mask` is
        decode_media_mask's (B, S_m) row, built here when not given, and the
        attention's K3 launch (when the plan counts attention carriers) then
        the FF's K2 launch carry the next tiles of `side` (an absorbing decode
        step's `absorb_vit.SideHook`)."""
        if media_kv is not None and self.attn.immediate and use_fused_decode(x, x.shape[1], True):
            if media_mask is None:
                media_mask = decode_media_mask(text_time, media.shape[1], media.shape[2])
            if fused_layer.use_for_xattn() and len(media_kv) == 2 and side is None:
                return self.fused_layer(x[:, 0], media_kv, media_mask)[:, None], media_kv
            x2 = self.attn.fused_decode(x[:, 0], media_kv, media_mask, self.attn_gate, side)
            mlp_half = fused_mlp if use_kernels(x) else reference_mlp
            ff = self.ff
            (w1, s1), (w2, s2) = stream_weight(ff.fc1), stream_weight(ff.fc2)
            y = carry(
                side, mlp_half, x2, w1, w2, w1_scale=s1, w2_scale=s2, ln_scale=ff.norm.weight, ln_bias=ff.norm.bias,
                eps=ff.norm.eps, act="gelu", residual=x2, gate=self.ff_gate,
            )
            return y[:, None], media_kv
        out, media_kv = self.attn(x, media, text_time, media_kv, media_mask, zero_rows)
        x = out * torch.tanh(self.attn_gate) + x
        x = self.ff(x) * torch.tanh(self.ff_gate) + x
        return x, media_kv

    def fused_layer(self, x, media_kv, mask2d):
        """The whole block for x (B, D) over the cached media K/V (B, H, S_m,
        Dh) under mask2d (B, S_m): K11 in its q-only form, both tanh gates."""
        at, ff = self.attn, self.ff
        (w_q, s_q), (w_out, s_out) = stream_weight(at.to_q), stream_weight(at.to_out)
        (w1, s1), (w2, s2) = stream_weight(ff.fc1), stream_weight(ff.fc2)
        layer = fused_layer_decode if use_kernels(x) else reference_fused_layer
        return layer(
            x, at.norm.weight, at.norm.bias, w_q, w_out, *media_kv, mask2d, w1, w2, ff.norm.weight, ff.norm.bias,
            heads=at.heads, head_dim=at.dim_head, scale=at.dim_head**-0.5, act="gelu", gate=self.attn_gate,
            gate2=self.ff_gate, wq_scale=s_q, wout_scale=s_out, w1_scale=s1, w2_scale=s2, eps=at.norm.eps,
        )
