"""Greedy generation over the explicit KVCache, the JAX package's
`greedy_or_sample` and `flamingo_generate` with `num_beams == 1`.

Vision is encoded once, the prompt is prefilled into a cache whose length
is rounded up to 16, and every decode step attends to the media K/V
projected at prefill. Quantized decode is opt-in, as in the JAX package:
`quantize.quantize_decode_weights(model, bits)` makes the decode kernels
stream int8 / int4 weights, and `GenerationConfig.int8_kv` holds the K/V
and media caches as int8. With `next_pixels` the call also encodes the
NEXT batch's images: on the fused route, where `absorb_vit.make_plan` gives
a schedule, the ViT rides the first decode forwards as K2b side tiles
(`greedy_absorb`), else it runs after the decode loop; either way the
tokens are those of the call without it. Beam search and sampling are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .device import resolve_device
from .models.absorb_vit import SideHook, finish_tokens, make_plan, patch_embed_flat
from .models.decoders.common import KVCache, quantize_layer_kv
from .models.flamingo import Flamingo, count_media
from .ops.dense_stream import fused_route

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int
    min_new_tokens: int = 0
    num_beams: int = 1
    do_sample: bool = False
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    # int8 K/V and media caches (per-row scales): half the cache bytes of a
    # decode step. Engaged only where the decode step takes the fused route
    # (`dense_stream.fused_route`), whose kernels dequantize in place; with
    # DISABLE_FUSED the cache stays in the model's dtype, as in the JAX
    # package, which engages it only for its fused decode engine.
    int8_kv: bool = False


def _process_logits(logits: torch.Tensor, step: int, cfg: GenerationConfig) -> torch.Tensor:
    """min_new_tokens: forbid EOS before the minimum length."""
    if cfg.eos_token_id is not None and step < cfg.min_new_tokens:
        logits = logits.clone()
        logits[:, cfg.eos_token_id] = NEG_INF
    return logits


def greedy(step_fn, first_logits: torch.Tensor, cache: KVCache, cfg: GenerationConfig, n_forced: int = 0):
    """Greedy decode loop. first_logits: (B, V) at the last prompt position;
    step_fn(tokens (B, 1), mask (B, 1), cache) -> (logits (B, 1, V), cache).
    The last token needs no forward; the first `n_forced` forwards run all
    the same (an absorbing step carries work of its own). Returns
    (B, max_new_tokens), pad-filled after EOS."""
    b = first_logits.shape[0]
    logits = first_logits
    finished = torch.zeros(b, dtype=torch.bool, device=logits.device)
    ones = torch.ones(b, 1, dtype=torch.long, device=logits.device)
    tokens = []
    for step in range(cfg.max_new_tokens):
        tok = torch.argmax(_process_logits(logits, step, cfg), dim=-1)
        if cfg.eos_token_id is not None:
            tok = torch.where(finished, cfg.pad_token_id, tok)
            finished = finished | (tok == cfg.eos_token_id)
        tokens.append(tok)
        if step + 1 < cfg.max_new_tokens or step < n_forced:
            step_logits, cache = step_fn(tok[:, None], ones, cache)
            logits = step_logits[:, 0]
    return torch.stack(tokens, dim=1)


def greedy_absorb(step_fn, first_logits, cache: KVCache, cfg: GenerationConfig, xw: torch.Tensor, vit_blocks,
                  plan) -> tuple:
    """`greedy` with the first `plan.n_steps` decode forwards each carrying
    `plan.per_step` layers of the next batch's ViT (the JAX package's
    `greedy_absorb`) and threading the flat workspace `xw` (m_pad, D)
    through them; the last of them runs even when it feeds no token (the
    JAX scan runs every step's forward). Returns (tokens, final workspace)."""
    state = {"xw": xw, "step": 0}

    def absorb_step(tok, mask, cache):
        step = state["step"]
        state["step"] += 1
        if step >= plan.n_steps:
            return step_fn(tok, mask, cache)
        hook = SideHook(vit_blocks[step * plan.per_step:(step + 1) * plan.per_step], state["xw"], plan)
        out = step_fn(tok, mask, cache, side=hook)
        state["xw"] = hook.result()
        return out

    tokens = greedy(absorb_step, first_logits, cache, cfg, n_forced=plan.n_steps)
    return tokens, state["xw"]


@torch.no_grad()
def prefill(model: Flamingo, latents: torch.Tensor, lang_x: torch.Tensor, attention_mask: torch.Tensor,
            cache_len: int, int8_kv: bool = False):
    """Prefill the prompt into a new cache of `cache_len` slots (int8 with
    `int8_kv`: the prompt's K/V quantized into it, and each xattn layer's
    media K/V quantized once after). Returns (logits (B, T, V), cache)."""
    cache = KVCache.create(model.cfg.lm, lang_x.shape[0], cache_len, model.dtype, lang_x.device, int8=int8_kv)
    logits, _, cache = model(None, lang_x, attention_mask, media_latents=latents, cache=cache)
    if int8_kv and cache.media is not None:
        cache = dataclasses.replace(cache, media=tuple(quantize_layer_kv(m) for m in cache.media))
    return logits, cache


@torch.no_grad()
def flamingo_generate(
    model: Flamingo,
    vision_x: Optional[torch.Tensor],
    lang_x: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GenerationConfig,
    *,
    media_latents: Optional[torch.Tensor] = None,
    next_pixels: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Encode vision once (or take `media_latents`, (B, T_img, n_lat, D)),
    prefill, decode greedily with the cached media. Inputs move to
    `device`, where the model must live. Returns generated ids
    (B, max_new_tokens), prompt excluded.

    next_pixels: (B', T', F', H, W, C) pixels of the NEXT batch. Returns
    (tokens, next_latents), next_latents its perceiver latents for the next
    call's `media_latents`: its ViT forward rides this call's decode loop
    as side tiles where the geometry carries the schedule, else it runs
    after the loop (`embed_vision`). The tokens do not change."""
    if cfg.num_beams != 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP.md)")
    if cfg.do_sample:
        raise NotImplementedError("sampling is not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, generate asked for {dev}")
    lang_x = lang_x.to(dev)
    attention_mask = attention_mask.to(dev)
    b, t = lang_x.shape
    # round the cache up to 16 slots, as the JAX package does; extra slots
    # stay masked in pad_mask
    cache_len = -(-(t + cfg.max_new_tokens) // 16) * 16

    if media_latents is not None:
        latents = media_latents.to(device=dev, dtype=model.dtype)
    else:
        latents = model.embed_vision(vision_x.to(device=dev, dtype=model.dtype))
    n_media = count_media(lang_x, model.cfg.media_token_id)

    logits, cache = prefill(model, latents, lang_x, attention_mask, cache_len, cfg.int8_kv and fused_route(dev))

    def step_fn(tok, mask, cache, side=None):
        return model.decode_step(latents, tok, mask, cache, n_media, side)

    if next_pixels is None:
        return greedy(step_fn, logits[:, -1], cache, cfg)
    next_pixels = next_pixels.to(device=dev, dtype=model.dtype)
    # the schedule rides the fused route's K2 launches
    plan = make_plan(model.cfg, next_pixels.shape[:3], cfg.max_new_tokens) if fused_route(dev) else None
    if plan is None:
        tokens = greedy(step_fn, logits[:, -1], cache, cfg)
        return tokens, model.embed_vision(next_pixels)
    vit = model.vision_encoder
    xw = patch_embed_flat(vit, next_pixels.reshape(plan.bv, *next_pixels.shape[3:]), plan)
    tokens, xw = greedy_absorb(step_fn, logits[:, -1], cache, cfg, xw, vit.blocks, plan)
    return tokens, model.resample_vision(finish_tokens(vit, xw, plan))
