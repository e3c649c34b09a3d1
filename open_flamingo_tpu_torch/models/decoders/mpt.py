"""MPT decoder block (ALiBi, no biases), the OF-3B / OF-9B LM family.

Fused Wqkv with the [q|k|v] column layout, optional clip_qkv clamp,
softmax scale 1/sqrt(head_dim), key-position-only ALiBi, LayerNorms
without bias, 4x GELU MLP without biases.

One decode token against a cache on the card takes the fused route, the
JAX package's two-launch form: K3 `attn_block_decode` (LN, Wqkv, in-place
K/V slot write, ALiBi softmax, out-projection, residual) then K2
`fused_mlp` (LN, up, GELU, down, residual), reading the nn.Linear weights
in place, or their int8 / int4 copies when `quantize.quantize_decode_weights`
attached them (`stream_weight`), and an int8 cache with its scales.
With `ops.fused_layer.DISABLE = False` the whole block is one K11
`fused_layer_decode` launch instead (x2 kept fp32 between the halves), as
in the JAX package: not over an int8 cache and not in an absorbing step,
which keep K3 + K2.
"""

from __future__ import annotations

import torch
from torch import nn

from ...configs import DecoderConfig
from ...ops import fused_layer
from ...ops.attention import cached_self_attention, use_kernels
from ...ops.decode_layer import attn_block_decode, reference_attn_block
from ...ops.dense_stream import fused_mlp, reference_mlp, use_fused_decode
from ...ops.fused_layer import fused_layer_decode, reference_fused_layer
from ...quantize import stream_weight
from ..absorb_vit import carry
from ..layers import Dense, LayerNorm, gelu_exact, merge_heads
from .common import LayerKV, alibi_slopes


class MPTBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        ln_bias = not cfg.ln_no_bias
        self.norm_1 = LayerNorm(d, cfg.layer_norm_eps, bias=ln_bias, **kw)
        self.Wqkv = Dense(d, 3 * d, bias=False, **kw)
        self.out_proj = Dense(d, d, bias=False, **kw)
        self.norm_2 = LayerNorm(d, cfg.layer_norm_eps, bias=ln_bias, **kw)
        self.up_proj = Dense(d, cfg.intermediate_size, bias=False, **kw)
        self.down_proj = Dense(cfg.intermediate_size, d, bias=False, **kw)
        # fp32 on the module's device; not a parameter, not in state_dict
        self.register_buffer(
            "alibi_slopes",
            torch.from_numpy(alibi_slopes(cfg.num_heads, cfg.alibi_bias_max)).to(device),
            persistent=False,
        )

    def forward(self, x, attn, layer_kv, side=None):
        """`side`: an absorbing decode step's `absorb_vit.SideHook`, whose
        next tiles the fused route's K3 launch (when the plan counts
        attention carriers) and K2 launch carry."""
        cfg = self.cfg
        b, t, _ = x.shape
        if layer_kv is not None and use_fused_decode(x, t, attn.cached):
            return self._fused_decode(x, attn, layer_kv, side)
        qkv = self.Wqkv(self.norm_1(x))
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = (z.reshape(b, t, cfg.num_heads, cfg.head_dim) for z in qkv.chunk(3, dim=-1))
        out, new_kv = cached_self_attention(
            q, k, v, attn, layer_kv,
            scale=cfg.head_dim**-0.5,
            alibi_slopes=self.alibi_slopes,
        )
        x = x + self.out_proj(merge_heads(out))
        h = self.down_proj(gelu_exact(self.up_proj(self.norm_2(x))))
        return x + h, new_kv

    def _fused_decode(self, x, attn, layer_kv, side):
        cfg, hd = self.cfg, self.cfg.head_dim
        kern = use_kernels(x)
        attn_half = attn_block_decode if kern else reference_attn_block
        mlp_half = fused_mlp if kern else reference_mlp
        (w_qkv, s_qkv), (w_out, s_out) = stream_weight(self.Wqkv), stream_weight(self.out_proj)
        (w_up, s_up), (w_down, s_down) = stream_weight(self.up_proj), stream_weight(self.down_proj)
        if not fused_layer.DISABLE and not layer_kv.int8 and side is None:
            layer = fused_layer_decode if kern else reference_fused_layer
            y, kc, vc = layer(
                x[:, 0], self.norm_1.weight, self.norm_1.bias, w_qkv, w_out, layer_kv.k, layer_kv.v, attn.pad_mask,
                w_up, w_down, self.norm_2.weight, self.norm_2.bias, heads=cfg.num_heads, head_dim=hd,
                scale=hd**-0.5, act="gelu", fused_qkv=True, slot=attn.slot, slopes=self.alibi_slopes,
                clip=cfg.clip_qkv, wq_scale=s_qkv, wout_scale=s_out, w1_scale=s_up, w2_scale=s_down,
                eps=cfg.layer_norm_eps,
            )
            return y[:, None], LayerKV(kc, vc)
        x2, kc, vc = carry(
            side, attn_half, x[:, 0], self.norm_1.weight, self.norm_1.bias, w_qkv, w_out, layer_kv.k, layer_kv.v, attn.pad_mask,
            heads=cfg.num_heads, head_dim=hd, scale=hd**-0.5, fused_qkv=True, slot=attn.slot,
            slopes=self.alibi_slopes, clip=cfg.clip_qkv, wq_scale=s_qkv, wout_scale=s_out, k_scale=layer_kv.k_s,
            v_scale=layer_kv.v_s, eps=cfg.layer_norm_eps, attn=True,
        )
        y = carry(
            side, mlp_half, x2, w_up, w_down, w1_scale=s_up, w2_scale=s_down, ln_scale=self.norm_2.weight,
            ln_bias=self.norm_2.bias, eps=cfg.layer_norm_eps, act="gelu", residual=x2,
        )
        return y[:, None], LayerKV(kc, vc, layer_kv.k_s, layer_kv.v_s)
