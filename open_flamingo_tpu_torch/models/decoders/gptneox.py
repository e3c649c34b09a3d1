"""GPT-NeoX decoder block (rotary, biased projections), the
RedPajama-INCITE (OF-4B) LM family.

HF GPTNeoXForCausalLM semantics: fused query_key_value with the
per-head-interleaved layout (the output reshaped to (B, T, H, 3*Dh), then
split into q|k|v per head; MPT's is [q|k|v] over all heads), partial rotary
(rotary_pct) in the HF layout, softmax scale 1/sqrt(head_dim), LayerNorms
with bias, 4x exact-GELU MLP. Residual: parallel x + attn(ln1(x)) +
mlp(ln2(x)), or sequential (x' = x + attn; x' + mlp(ln2(x'))), as
`use_parallel_residual` says.

One decode token against a cache on the card takes the fused route, the
JAX package's three-launch form: K1 `fused_dense` (LN, QKV, bias), RoPE in
plain torch, K6 `attend_out_decode` (in-place K/V slot write, attend,
out-projection, bias), then K2 `fused_mlp` (LN, up + b1, GELU, down + b2,
residual x + attn_out), reading the nn.Linear weights in place, or their
int8 / int4 copies (`quantize.stream_weight`), and an int8 cache with its
scales.
"""

from __future__ import annotations

from torch import nn

from ...configs import DecoderConfig
from ...ops.attention import cached_self_attention, use_kernels
from ...ops.decode_layer import attend_out_decode, reference_attend_out
from ...ops.dense_stream import fused_dense, fused_mlp, reference_dense, reference_mlp, use_fused_decode
from ...quantize import stream_weight
from ..absorb_vit import carry
from ..layers import Dense, LayerNorm, gelu_exact, merge_heads
from .common import LayerKV, apply_rope, rope_cos_sin


class GPTNeoXBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, bias = cfg.hidden_size, cfg.attention_bias
        self.cfg = cfg
        self.rotary_ndims = int(cfg.head_dim * cfg.rotary_pct)
        self.input_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.query_key_value = Dense(d, 3 * d, bias=bias, **kw)
        self.dense = Dense(d, d, bias=bias, **kw)
        self.post_attention_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.dense_h_to_4h = Dense(d, cfg.intermediate_size, bias=bias, **kw)
        self.dense_4h_to_h = Dense(cfg.intermediate_size, d, bias=bias, **kw)

    def _qkv(self, qkv, attn):
        """(B, T, 3*D) -> q, k (rotated), v, each (B, T, H, Dh)."""
        cfg = self.cfg
        b, t, _ = qkv.shape
        q, k, v = qkv.reshape(b, t, cfg.num_heads, 3 * cfg.head_dim).split(cfg.head_dim, dim=-1)
        cos, sin = rope_cos_sin(attn.position_ids, self.rotary_ndims, cfg.rope_theta)
        q, k = apply_rope(q, k, cos, sin)
        return q, k, v

    def forward(self, x, attn, layer_kv, side=None):
        cfg = self.cfg
        if layer_kv is not None and use_fused_decode(x, x.shape[1], attn.cached):
            return self._fused_decode(x, attn, layer_kv, side)
        q, k, v = self._qkv(self.query_key_value(self.input_layernorm(x)), attn)
        out, new_kv = cached_self_attention(q, k, v, attn, layer_kv, scale=cfg.head_dim**-0.5)
        attn_out = self.dense(merge_heads(out))
        mlp_in = x if cfg.use_parallel_residual else x + attn_out
        mlp_out = self.dense_4h_to_h(gelu_exact(self.dense_h_to_4h(self.post_attention_layernorm(mlp_in))))
        return x + attn_out + mlp_out, new_kv

    def _fused_decode(self, x, attn, layer_kv, side):
        cfg = self.cfg
        kern = use_kernels(x)
        dense = fused_dense if kern else reference_dense
        tail = attend_out_decode if kern else reference_attend_out
        mlp = fused_mlp if kern else reference_mlp
        x2 = x[:, 0]
        ln1, ln2 = self.input_layernorm, self.post_attention_layernorm
        (w_qkv, s_qkv), (w_out, s_out) = stream_weight(self.query_key_value), stream_weight(self.dense)
        (w_up, s_up), (w_down, s_down) = stream_weight(self.dense_h_to_4h), stream_weight(self.dense_4h_to_h)
        qkv = dense(x2, w_qkv, w_scale=s_qkv, bias=self.query_key_value.bias, ln_scale=ln1.weight,
                    ln_bias=ln1.bias, eps=ln1.eps)
        q, k, v = self._qkv(qkv[:, None], attn)
        attn_out, kc, vc = tail(
            q[:, 0], layer_kv.k, layer_kv.v, attn.pad_mask, w_out, scale=cfg.head_dim**-0.5,
            k_new=k[:, 0], v_new=v[:, 0], slot=attn.slot, wout_scale=s_out, bias=self.dense.bias,
            k_scale=layer_kv.k_s, v_scale=layer_kv.v_s,
        )
        h = x2 + attn_out
        y = carry(
            side, mlp, x2 if cfg.use_parallel_residual else h, w_up, w_down, w1_scale=s_up, w2_scale=s_down,
            b1=self.dense_h_to_4h.bias, b2=self.dense_4h_to_h.bias, ln_scale=ln2.weight, ln_bias=ln2.bias,
            eps=ln2.eps, act="gelu", residual=h,
        )
        return y[:, None], LayerKV(kc, vc, layer_kv.k_s, layer_kv.v_s)
