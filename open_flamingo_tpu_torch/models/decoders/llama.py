"""LLaMA decoder block (RMSNorm, full rotary, SwiGLU, grouped-query
attention), the JAX package's `models/decoders/llama.py`.

HF LlamaForCausalLM semantics: pre-RMSNorm with the config's eps (1e-6 for
LLaMA-7B, read from `layer_norm_eps`), q/k/v/o projections without bias
(`attention_bias`), full rotary in the rotate-half layout, softmax scale
1/sqrt(head_dim), H_kv <= H key/value heads with query head h reading KV
head h // (H / H_kv), and the MLP down(silu(gate(h)) * up(h)).

One decode token against a cache on the card takes the fused route, the
JAX package's form (`scan_decode.py:219-254`): three K1 `fused_dense`
launches with the RMSNorm prologue (q, k and v), RoPE in plain torch, K6
`attend_out_decode` (in-place K/V slot write into the grouped cache,
attend, o_proj, residual), then K2 `fused_mlp` in its SwiGLU form (RMSNorm,
gate_proj and up_proj streamed in one pass, silu, down_proj, residual),
reading the nn.Linear weights in place, or their int8 / int4 copies
(`quantize.stream_weight`), and an int8 cache with its scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...configs import DecoderConfig
from ...ops.attention import cached_self_attention, use_kernels
from ...ops.decode_layer import attend_out_decode, reference_attend_out
from ...ops.dense_stream import fused_dense, fused_mlp, reference_dense, reference_mlp, use_fused_decode
from ...quantize import stream_weight
from ..absorb_vit import carry
from ..layers import Dense, merge_heads
from .common import LayerKV, apply_rope, rope_cos_sin


class RMSNorm(nn.Module):
    """HF LlamaRMSNorm: the variance in fp32, x_normed rounded to x's dtype,
    then times the scale (`weight`, the JAX parameter `scale`)."""

    def __init__(self, dim, eps, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (self.weight * xf.to(x.dtype)).to(x.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, dh, bias = cfg.hidden_size, cfg.head_dim, cfg.attention_bias
        self.cfg = cfg
        self.input_layernorm = RMSNorm(d, cfg.layer_norm_eps, **kw)
        self.q_proj = Dense(d, cfg.num_heads * dh, bias=bias, **kw)
        self.k_proj = Dense(d, cfg.kv_heads * dh, bias=bias, **kw)
        self.v_proj = Dense(d, cfg.kv_heads * dh, bias=bias, **kw)
        self.o_proj = Dense(cfg.num_heads * dh, d, bias=bias, **kw)
        self.post_attention_layernorm = RMSNorm(d, cfg.layer_norm_eps, **kw)
        self.gate_proj = Dense(d, cfg.intermediate_size, bias=bias, **kw)
        self.up_proj = Dense(d, cfg.intermediate_size, bias=bias, **kw)
        self.down_proj = Dense(cfg.intermediate_size, d, bias=bias, **kw)

    def _rope(self, q, k, attn):
        cos, sin = rope_cos_sin(attn.position_ids, self.cfg.head_dim, self.cfg.rope_theta)
        return apply_rope(q, k, cos, sin)

    def forward(self, x, attn, layer_kv, side=None):
        cfg = self.cfg
        if layer_kv is not None and use_fused_decode(x, x.shape[1], attn.cached):
            return self._fused_decode(x, attn, layer_kv, side)
        b, t, _ = x.shape
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(h).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(h).reshape(b, t, cfg.kv_heads, cfg.head_dim)
        q, k = self._rope(q, k, attn)
        out, new_kv = cached_self_attention(q, k, v, attn, layer_kv, scale=cfg.head_dim**-0.5,
                                            n_rep=cfg.num_heads // cfg.kv_heads)
        x = x + self.o_proj(merge_heads(out))
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h)), new_kv

    def _fused_decode(self, x, attn, layer_kv, side):
        cfg = self.cfg
        kern = use_kernels(x)
        dense = fused_dense if kern else reference_dense
        tail = attend_out_decode if kern else reference_attend_out
        mlp = fused_mlp if kern else reference_mlp
        b, x2 = x.shape[0], x[:, 0]
        ln1, ln2 = self.input_layernorm, self.post_attention_layernorm

        def proj(lin):      # K1: RMSNorm, the projection
            w, s = stream_weight(lin)
            return dense(x2, w, w_scale=s, bias=lin.bias, ln_scale=ln1.weight, eps=ln1.eps, norm="rms")

        q, k, v = proj(self.q_proj), proj(self.k_proj), proj(self.v_proj)
        q = q.reshape(b, 1, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, 1, cfg.kv_heads, cfg.head_dim)
        q, k = self._rope(q, k, attn)
        w_o, s_o = stream_weight(self.o_proj)
        x2, kc, vc = tail(
            q[:, 0], layer_kv.k, layer_kv.v, attn.pad_mask, w_o, scale=cfg.head_dim**-0.5, k_new=k[:, 0],
            v_new=v.reshape(b, cfg.kv_heads, cfg.head_dim), slot=attn.slot, wout_scale=s_o, bias=self.o_proj.bias,
            residual=x2, k_scale=layer_kv.k_s, v_scale=layer_kv.v_s,
        )
        (w_g, s_g), (w_u, s_u), (w_d, s_d) = (stream_weight(p) for p in (self.gate_proj, self.up_proj, self.down_proj))
        y = carry(
            side, mlp, x2, w_g, w_d, w1_gate=w_u, w1_scale=s_g, w2_scale=s_d, w1_gate_scale=s_u,
            b1=self.gate_proj.bias, b2=self.down_proj.bias, ln_scale=ln2.weight, eps=ln2.eps, norm="rms", act="silu",
            residual=x2,
        )
        return y[:, None], LayerKV(kc, vc, layer_kv.k_s, layer_kv.v_s)
