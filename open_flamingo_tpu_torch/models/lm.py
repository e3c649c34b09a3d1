"""Decoder LM with gated cross-attention before every `cross_attn_every_n`-th
layer (the JAX package's `FlamingoLM`, unrolled layer layout).

Layer i applies its xattn block (if any) before the decoder block. The
final norm (an RMSNorm for llama, a LayerNorm otherwise) and the LM head
follow: tied (the (V, D) embedding table) or an untied `lm_head` (V, D),
with a bias when `lm_head_bias`. On the fused decode route they are one K1
`fused_dense` launch that reads the (V, D) weight in place as the
transposed weight, or its int8 copy with its per-row scale when
`quantize.quantize_decode_weights` attached one. Prefill keeps `F.linear`
over the model-dtype weight for a tied head and calls the untied `Dense`,
whose W8A8 branch takes it under `ops.w8a8.ENABLED`, as the JAX package
does (`embed.attend` and `head(x)`). OPT adds learned
positions (`wpe`, max_position_embeddings + 2 rows) at the mask-aware
position ids + 2. Vision latents and text time are explicit
arguments; decode state is an explicit KVCache. With `gradient_checkpointing` (the JAX
package's `nn.remat`), each decoder and xattn block of a cache-free forward
under autograd keeps only its inputs and recomputes its forward in the
backward (`torch.utils.checkpoint`, non-reentrant).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import DecoderConfig
from ..ops.attention import use_kernels
from ..ops.dense_stream import fused_dense, reference_dense, use_fused_decode
from ..quantize import stream_weight
from .decoders.common import KVCache, LayerKV, make_attn_inputs
from .decoders.gptneox import GPTNeoXBlock
from .decoders.llama import LlamaBlock, RMSNorm
from .decoders.mpt import MPTBlock
from .decoders.opt import OPTBlock
from .layers import Dense, LayerNorm
from .xattn import GatedCrossAttentionBlock, build_media_masks, decode_media_mask, use_xattn_kernel

BLOCK_REGISTRY = {"mpt": MPTBlock, "gptneox": GPTNeoXBlock, "llama": LlamaBlock, "opt": OPTBlock}


class FlamingoLM(nn.Module):
    def __init__(
        self, cfg: DecoderConfig, vis_dim: Optional[int] = None,
        cross_attn_every_n: Optional[int] = None,
        only_attend_immediate_media: bool = True, gradient_checkpointing: bool = False, *, device=None,
        dtype=None,
    ):
        super().__init__()
        if cfg.family not in BLOCK_REGISTRY:
            raise NotImplementedError(
                f"decoder family {cfg.family!r} is not ported yet (ROADMAP.md)"
            )
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.immediate = only_attend_immediate_media
        self.every = cross_attn_every_n or 1
        self.gradient_checkpointing = gradient_checkpointing
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings + 2, cfg.hidden_size, **kw) if cfg.family == "opt" else None
        self.blocks = nn.ModuleList(BLOCK_REGISTRY[cfg.family](cfg, **kw) for _ in range(cfg.num_layers))
        n = cross_attn_every_n
        self.xattn = nn.ModuleDict({
            str(i): GatedCrossAttentionBlock(
                cfg.hidden_size, vis_dim, only_attend_immediate_media=only_attend_immediate_media, **kw
            )
            for i in range(cfg.num_layers)
            if n is not None and (i + 1) % n == 0
        })
        if cfg.family == "llama":
            self.norm_f = RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        else:
            self.norm_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, bias=not cfg.ln_no_bias, **kw)
        self.lm_head = None
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=cfg.lm_head_bias, **kw)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        *,
        media: Optional[torch.Tensor] = None,
        text_time: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        side=None,
    ):
        """input_ids (B, T); attention_mask (B, T) 1/0; media (B, T_img,
        n_lat, vis_dim) perceiver latents; text_time (B, T). Returns
        (logits (B, T, V) fp32, cache or None). A cache without media K/V
        gets the ones this call projects (prefill); decode reuses them.
        `side` (`absorb_vit.SideHook`, a fused decode step with media only)
        rides the next batch's ViT on the K2 launches: the hook hears the
        start of each group of `cross_attn_every_n` layers, and the xattn FF
        then each block's MLP carry its tiles in program order."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        attn, cache = make_attn_inputs(attention_mask, cache=cache)
        x = self.wte(input_ids)
        if self.wpe is not None:
            x = x + self.wpe(attn.position_ids + 2)
        fused = use_fused_decode(x, input_ids.shape[1], cache is not None)
        media_cache = cache.media if cache is not None else None
        if side is not None and not (fused and media_cache is not None and self.xattn):
            raise ValueError("FlamingoLM: side tiles ride a fused decode step over cached media")

        media_mask = zero_rows = None
        if media is not None:
            if fused and self.immediate and media_cache is not None:
                media_mask = decode_media_mask(text_time, media.shape[1], media.shape[2])
            elif not use_xattn_kernel(x, self.immediate):
                media_mask, zero_rows = build_media_masks(text_time, media.shape[1], media.shape[2], self.immediate)

        remat = self.gradient_checkpointing and cache is None and torch.is_grad_enabled()

        def run(module, *args):
            return checkpoint(module, *args, use_reentrant=False) if remat else module(*args)

        new_layers, new_media = [], []
        for i, block in enumerate(self.blocks):
            if side is not None and i % self.every == 0:
                side.group(i // self.every)
            if str(i) in self.xattn and media is not None:
                mkv = None
                if media_cache is not None:
                    m = media_cache[len(new_media)]
                    mkv = (m.k, m.v) if not m.int8 else (m.k, m.v, m.k_s, m.v_s)
                x, mkv = run(self.xattn[str(i)], x, media, text_time, mkv, media_mask, zero_rows, side)
                new_media.append(LayerKV(*mkv))
            x, kv = run(block, x, attn, cache.layers[i] if cache is not None else None, side)
            new_layers.append(kv)

        head_mod = self.wte if self.lm_head is None else self.lm_head
        w_head, b_head = head_mod.weight, getattr(head_mod, "bias", None)
        if fused:
            head = fused_dense if use_kernels(x) else reference_dense
            w_stream, s_head = stream_weight(head_mod)
            logits = head(
                x[:, 0], w_stream, w_scale=s_head, bias=b_head, ln_scale=self.norm_f.weight,
                ln_bias=getattr(self.norm_f, "bias", None), eps=self.cfg.layer_norm_eps,
                norm="rms" if isinstance(self.norm_f, RMSNorm) else "layer",
            )[:, None].float()
        elif self.lm_head is None:
            logits = torch.nn.functional.linear(self.norm_f(x), w_head, b_head).float()
        else:       # through Dense, so that W8A8 prefill takes the untied head as JAX's `head(x)` does
            logits = self.lm_head(self.norm_f(x)).float()
        if cache is not None:
            cache = dataclasses.replace(
                cache,
                layers=tuple(new_layers),
                index=cache.index + input_ids.shape[1],
                slot=cache.slot + input_ids.shape[1],
                media=media_cache if media_cache is not None else (tuple(new_media) or None),
            )
        return logits, cache
