"""OPT decoder block (pre-LN, every projection biased, ReLU MLP), the JAX
package's `models/decoders/opt.py`; the learned positions with OPT's +2
offset are added to the embeddings in `models/lm.py`.

HF OPTForCausalLM semantics (`do_layer_norm_before=True` models): LayerNorms
with bias and eps `layer_norm_eps`, q/k/v/out_proj and fc1/fc2 with
biases, softmax scale 1/sqrt(head_dim), no rotary.

One decode token against a cache on the card takes the fused route, the
JAX package's form (`opt.py:57-103`): three K1 `fused_dense` launches with
the LayerNorm prologue and the bias epilogue (q, k and v), K6
`attend_out_decode` (in-place K/V slot write, attend, out_proj + bias,
residual), then K2 `fused_mlp` (LayerNorm, fc1 + b1, relu, fc2 + b2,
residual), reading the nn.Linear weights in place, or their int8 / int4
copies (`quantize.stream_weight`), and an int8 cache with its scales.
"""

from __future__ import annotations

import torch
from torch import nn

from ...configs import DecoderConfig
from ...ops.attention import cached_self_attention, use_kernels
from ...ops.decode_layer import attend_out_decode, reference_attend_out
from ...ops.dense_stream import fused_dense, fused_mlp, reference_dense, reference_mlp, use_fused_decode
from ...quantize import stream_weight
from ..absorb_vit import carry
from ..layers import Dense, LayerNorm, merge_heads
from .common import LayerKV


class OPTBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.self_attn_layer_norm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.q_proj = Dense(d, d, **kw)
        self.k_proj = Dense(d, d, **kw)
        self.v_proj = Dense(d, d, **kw)
        self.out_proj = Dense(d, d, **kw)
        self.final_layer_norm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.fc1 = Dense(d, cfg.intermediate_size, **kw)
        self.fc2 = Dense(cfg.intermediate_size, d, **kw)

    def forward(self, x, attn, layer_kv, side=None):
        cfg = self.cfg
        if layer_kv is not None and use_fused_decode(x, x.shape[1], attn.cached):
            return self._fused_decode(x, attn, layer_kv, side)
        b, t, _ = x.shape
        h = self.self_attn_layer_norm(x)
        q, k, v = (p(h).reshape(b, t, cfg.num_heads, cfg.head_dim) for p in (self.q_proj, self.k_proj, self.v_proj))
        out, new_kv = cached_self_attention(q, k, v, attn, layer_kv, scale=cfg.head_dim**-0.5)
        x = x + self.out_proj(merge_heads(out))
        return x + self.fc2(torch.relu(self.fc1(self.final_layer_norm(x)))), new_kv

    def _fused_decode(self, x, attn, layer_kv, side):
        cfg = self.cfg
        kern = use_kernels(x)
        dense = fused_dense if kern else reference_dense
        tail = attend_out_decode if kern else reference_attend_out
        mlp = fused_mlp if kern else reference_mlp
        b, x2 = x.shape[0], x[:, 0]
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm

        def proj(lin):      # K1: LayerNorm, the projection, its bias; (B, H, Dh)
            w, s = stream_weight(lin)
            y = dense(x2, w, w_scale=s, bias=lin.bias, ln_scale=ln1.weight, ln_bias=ln1.bias, eps=ln1.eps)
            return y.reshape(b, cfg.num_heads, cfg.head_dim)

        q, k, v = proj(self.q_proj), proj(self.k_proj), proj(self.v_proj)
        w_o, s_o = stream_weight(self.out_proj)
        x2, kc, vc = tail(
            q, layer_kv.k, layer_kv.v, attn.pad_mask, w_o, scale=cfg.head_dim**-0.5, k_new=k, v_new=v,
            slot=attn.slot, wout_scale=s_o, bias=self.out_proj.bias, residual=x2, k_scale=layer_kv.k_s,
            v_scale=layer_kv.v_s,
        )
        (w1, s1), (w2, s2) = stream_weight(self.fc1), stream_weight(self.fc2)
        y = carry(
            side, mlp, x2, w1, w2, w1_scale=s1, w2_scale=s2, b1=self.fc1.bias, b2=self.fc2.bias, ln_scale=ln2.weight,
            ln_bias=ln2.bias, eps=ln2.eps, act="relu", residual=x2,
        )
        return y[:, None], LayerKV(kc, vc, layer_kv.k_s, layer_kv.v_s)
