"""Generation over the explicit KVCache: greedy, sampling and beam search,
the JAX package's `greedy_or_sample`, `beam_search` and `flamingo_generate`.

Vision is encoded once, the prompt is prefilled into a cache whose length
is rounded up to 16, and every decode step attends to the media K/V
projected at prefill. Quantized decode is opt-in, as in the JAX package:
`quantize.quantize_decode_weights(model, bits)` makes the decode kernels
stream int8 / int4 weights, and `GenerationConfig.int8_kv` holds the K/V
and media caches as int8. With `next_pixels` the call also encodes the
NEXT batch's images: on the fused route, where `absorb_vit.make_plan` gives
a schedule (one beam only), the ViT rides the first decode forwards as K2b
side tiles (`greedy_absorb`), else it runs after the decode loop; either
way the tokens are those of the call without it.

Sampling filters the logits as the JAX package does (temperature, top-k,
top-p) and draws argmax(logits + Gumbel noise), the form of
`jax.random.categorical`; the noise comes from a `torch.Generator` on the
device through `gumbel_noise`. Beam search prefills at B and then repeats
the cache beam-major; each step gathers the cache rows of the chosen beams
in place, so the cache keeps its addresses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .device import resolve_device
from .models.absorb_vit import SideHook, finish_tokens, make_plan, patch_embed_flat
from .models.decoders.common import KVCache, LayerKV, quantize_layer_kv
from .models.flamingo import Flamingo, count_media
from .ops.dense_stream import fused_route

NEG_INF = -1.0e7

# (step, shape) -> fp32 Gumbel(0, 1) noise of `shape` for that step's draw
NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int
    min_new_tokens: int = 0
    num_beams: int = 1
    length_penalty: float = 1.0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    # int8 K/V and media caches (per-row scales): half the cache bytes of a
    # decode step. Engaged only where the decode step takes the fused route
    # (`dense_stream.fused_route`), whose kernels dequantize in place; with
    # DISABLE_FUSED the cache stays in the model's dtype, as in the JAX
    # package, which engages it only for its fused decode engine.
    int8_kv: bool = False


def gumbel_noise(generator: torch.Generator) -> NoiseFn:
    """The noise source of a sampled call: Gumbel(0, 1) drawn from
    `generator` on its device, -log(-log(u)) with u uniform in [tiny, 1), as
    `jax.random.gumbel` draws it."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    return draw


def _process_logits(logits: torch.Tensor, step, cfg: GenerationConfig) -> torch.Tensor:
    """min_new_tokens: forbid EOS before the minimum length. `step` is the
    decode step of every row (an int), or a tensor of each row's own step
    ((B, 1), or a scalar on the device) that forbids EOS row by row without
    a host sync (the serving engine's tenants, speculative decoding's bonus
    token)."""
    if cfg.eos_token_id is None or cfg.min_new_tokens <= 0:
        return logits
    if isinstance(step, torch.Tensor):
        forbid = step.reshape(-1, 1) < cfg.min_new_tokens
        eos = torch.arange(logits.shape[-1], device=logits.device) == cfg.eos_token_id
        return torch.where(forbid & eos, torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device), logits)
    if step < cfg.min_new_tokens:
        logits = logits.clone()
        logits[:, cfg.eos_token_id] = NEG_INF
    return logits


def _filter_logits(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """JAX `_sample_token`'s filtering of (N, V) logits: divide by the
    temperature (at least 1e-6); top-k masks every entry below the k-th
    largest, so ties at the k-th value stay; top-p keeps the first
    sum(cumsum(softmax) < top_p) + 1 entries in descending order. Masked
    entries become NEG_INF. Constants are device tensors made by a fill (no
    host copy, no sync): a CUDA division by a host scalar multiplies by its
    reciprocal, one ulp away from JAX's."""
    dev, dt = logits.device, logits.dtype
    neg = torch.full((), NEG_INF, dtype=dt, device=dev)
    logits = logits / torch.full((), max(cfg.temperature, 1e-6), dtype=dt, device=dev)
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k, None]
        logits = torch.where(logits < kth, neg, logits)
    if cfg.top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        e = torch.exp(srt - srt[:, :1])               # jax.nn.softmax: exp(x - max) / sum
        cum = torch.cumsum(e / e.sum(-1, keepdim=True), dim=-1)
        # past the last entry JAX's gather fills NaN and masks nothing; the
        # smallest entry masks nothing either
        idx = (cum < cfg.top_p).sum(-1, keepdim=True).clamp_(max=srt.shape[-1] - 1)
        logits = torch.where(logits < torch.gather(srt, -1, idx), neg, logits)
    return logits


def _sample_token(logits: torch.Tensor, cfg: GenerationConfig, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax of the logits, or with do_sample of the filtered logits plus
    `gumbel` (noise of their shape): `jax.random.categorical`'s draw."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(_filter_logits(logits, cfg) + gumbel, dim=-1)


def greedy_or_sample(step_fn, first_logits: torch.Tensor, cache: KVCache, cfg: GenerationConfig,
                     noise: Optional[NoiseFn] = None, n_forced: int = 0):
    """Greedy or sampled decode loop. first_logits: (B, V) at the last
    prompt position; step_fn(tokens (B, 1), mask (B, 1), cache) -> (logits
    (B, 1, V), cache); `noise` draws each step's Gumbel noise with
    do_sample (default: `gumbel_noise` of a generator seeded 0, as the JAX
    package defaults to PRNGKey(0)). The last token needs no forward; the
    first `n_forced` forwards run all the same (an absorbing step carries
    work of its own). Returns (B, max_new_tokens), pad-filled after EOS."""
    b = first_logits.shape[0]
    logits = first_logits
    if cfg.do_sample and noise is None:
        noise = gumbel_noise(torch.Generator(device=logits.device).manual_seed(0))
    finished = torch.zeros(b, dtype=torch.bool, device=logits.device)
    ones = torch.ones(b, 1, dtype=torch.long, device=logits.device)
    tokens = []
    for step in range(cfg.max_new_tokens):
        logits = _process_logits(logits, step, cfg)
        tok = _sample_token(logits, cfg, noise(step, logits.shape) if cfg.do_sample else None)
        if cfg.eos_token_id is not None:
            tok = torch.where(finished, cfg.pad_token_id, tok)
            finished = finished | (tok == cfg.eos_token_id)
        tokens.append(tok)
        if step + 1 < cfg.max_new_tokens or step < n_forced:
            step_logits, cache = step_fn(tok[:, None], ones, cache)
            logits = step_logits[:, 0]
    return torch.stack(tokens, dim=1)


def greedy_absorb(step_fn, first_logits, cache: KVCache, cfg: GenerationConfig, xw: torch.Tensor, vit_blocks,
                  plan, noise: Optional[NoiseFn] = None) -> tuple:
    """`greedy_or_sample` with the first `plan.n_steps` decode forwards each
    carrying `plan.per_step` layers of the next batch's ViT (the JAX
    package's `greedy_absorb`) and threading the flat workspace `xw` (m_pad,
    D) through them; the last of them runs even when it feeds no token (the
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

    tokens = greedy_or_sample(absorb_step, first_logits, cache, cfg, noise, n_forced=plan.n_steps)
    return tokens, state["xw"]


# --- beam search -----------------------------------------------------------


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest, ties to the lower
    index (a stable descending sort; `torch.topk` orders no ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, n, ...) at idx (b, m) along axis 1."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.ndim - 2))).expand(*idx.shape, *x.shape[2:]))


def _gather_beams(cache: KVCache, indices: torch.Tensor, batch: int, beams: int) -> KVCache:
    """Move each row's cache to the beam it continues, in place: row
    b*beams + j takes row b*beams + indices[b, j]. Every field gathers on
    axis 0, the int8 scales (B, H_kv, S) with their values; slots past
    `cache.index` hold nothing yet and stay. `media` is skipped: all beams
    of a batch row share the same media K/V (JAX `_gather_beams`). The
    tensors keep their addresses (K3 writes into them at `cache.slot`)."""
    rows = (torch.arange(batch, device=indices.device)[:, None] * beams + indices).reshape(-1)
    n = cache.index
    for layer in cache.layers:
        for x in (layer.k, layer.v, layer.k_s, layer.v_s):
            if x is not None:
                written = x[:, :, :n]
                written.copy_(written.index_select(0, rows))
    cache.pad_mask.copy_(cache.pad_mask.index_select(0, rows))
    return cache


def _repeat_beams(cache: KVCache, k: int) -> KVCache:
    """Each batch row's cache k times, beam-major (batch b's beams at rows
    b*k .. b*k + k - 1), the media K/V too: run once after the B-row
    prefill, so the prompt forward never runs per beam."""

    def rep(x):
        return None if x is None else x.repeat_interleave(k, dim=0)

    def layer(kv: LayerKV) -> LayerKV:
        return LayerKV(rep(kv.k), rep(kv.v), rep(kv.k_s), rep(kv.v_s))

    return dataclasses.replace(
        cache, layers=tuple(layer(kv) for kv in cache.layers), pad_mask=rep(cache.pad_mask),
        media=None if cache.media is None else tuple(layer(kv) for kv in cache.media),
    )


def _length_penalty(length: int, cfg: GenerationConfig, device) -> torch.Tensor:
    """length ** length_penalty in fp32, a device tensor (see `_filter_logits`)."""
    return torch.full((), float(length), dtype=torch.float32, device=device) ** cfg.length_penalty


def beam_search(step_fn, first_logits: torch.Tensor, cache: KVCache, cfg: GenerationConfig, prompt_len: int = 0,
                observe=None) -> torch.Tensor:
    """Length-penalised beam search, HF semantics as in the JAX package: a
    hypothesis scores sum(logprob) / len ** length_penalty at EOS or at the
    maximum length, len counting the (padded) prompt of `prompt_len`
    tokens. first_logits: (B*K, V) and the cache already repeated
    beam-major. Each step keeps the top 2K candidates so that EOS picks do
    not starve the live set. `observe(step, logprobs (B, K, V), beams (B,
    K), tokens (B, K))`, where given, sees every step's choice. The last
    token needs no forward. Returns the best sequences (B, max_new_tokens)."""
    k, eos, steps = cfg.num_beams, cfg.eos_token_id, cfg.max_new_tokens
    bk, vocab = first_logits.shape
    b, dev = bk // k, first_logits.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    # beam 0 starts at 0, the others at NEG_INF: their prefixes are identical
    live_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    live_scores[:, 0] = 0.0
    live_seqs = torch.full((b, k, steps), cfg.pad_token_id, dtype=torch.long, device=dev)
    fin_scores, fin_seqs = live_scores.new_full((b, k), NEG_INF), live_seqs.clone()
    ones = torch.ones(bk, 1, dtype=torch.long, device=dev)
    logits = first_logits
    for step in range(steps):
        logprobs = F.log_softmax(_process_logits(logits, step, cfg).float(), dim=-1).reshape(b, k, vocab)
        top_scores, top_idx = _top_k((live_scores[:, :, None] + logprobs).reshape(b, k * vocab), 2 * k)
        top_beam, top_tok = top_idx // vocab, top_idx % vocab
        new_seqs = _take(live_seqs, top_beam)
        new_seqs[:, :, step] = top_tok
        live_cand = top_scores
        if eos is not None:
            is_eos = top_tok == eos
            cand_fin = torch.where(is_eos, top_scores / _length_penalty(prompt_len + step + 1, cfg, dev), neg)
            fin_scores, fin_idx = _top_k(torch.cat([fin_scores, cand_fin], dim=1), k)
            fin_seqs = _take(torch.cat([fin_seqs, new_seqs], dim=1), fin_idx)
            live_cand = torch.where(is_eos, neg, top_scores)
        live_scores, live_idx = _top_k(live_cand, k)
        live_seqs = _take(new_seqs, live_idx)
        beams, toks = torch.gather(top_beam, 1, live_idx), torch.gather(top_tok, 1, live_idx)
        if observe is not None:
            observe(step, logprobs, beams, toks)
        if step + 1 < steps:
            cache = _gather_beams(cache, beams, b, k)
            step_logits, cache = step_fn(toks.reshape(bk, 1), ones, cache)
            logits = step_logits[:, 0]
    # live beams count as hypotheses at the maximum length
    scores = torch.cat([fin_scores, live_scores / _length_penalty(prompt_len + steps, cfg, dev)], dim=1)
    best = torch.argmax(scores, dim=1)
    return _take(torch.cat([fin_seqs, live_seqs], dim=1), best[:, None])[:, 0]


# --- Flamingo front-end ----------------------------------------------------


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
    generator: Optional[torch.Generator] = None,
    observe=None,
    device="cuda",
):
    """Encode vision once (or take `media_latents`, (B, T_img, n_lat, D)),
    prefill at B, then decode greedily, by sampling (`do_sample`) or by beam
    search (`num_beams` > 1, the cache repeated per beam after prefill)
    with the cached media. Inputs move to `device`, where the model must
    live. `generator`: a torch.Generator on that device for the sampled
    draws (default: seeded 0). `observe`: `beam_search`'s per-step hook.
    Returns generated ids (B, max_new_tokens), prompt excluded.

    next_pixels: (B', T', F', H, W, C) pixels of the NEXT batch. Returns
    (tokens, next_latents), next_latents its perceiver latents for the next
    call's `media_latents`: its ViT forward rides this call's decode loop
    as side tiles where the geometry carries the schedule (one beam, the
    fused route), else it runs after the loop (`embed_vision`). The tokens
    do not change."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, generate asked for {dev}")
    lang_x = lang_x.to(dev)
    attention_mask = attention_mask.to(dev)
    b, t = lang_x.shape
    k = cfg.num_beams
    # round the cache up to 16 slots, as the JAX package does; extra slots
    # stay masked in pad_mask
    cache_len = -(-(t + cfg.max_new_tokens) // 16) * 16

    if media_latents is not None:
        latents = media_latents.to(device=dev, dtype=model.dtype)
    else:
        latents = model.embed_vision(vision_x.to(device=dev, dtype=model.dtype))
    n_media = count_media(lang_x, model.cfg.media_token_id)

    logits, cache = prefill(model, latents, lang_x, attention_mask, cache_len, cfg.int8_kv and fused_route(dev))
    first = logits[:, -1]
    if k > 1:
        cache, first = _repeat_beams(cache, k), first.repeat_interleave(k, dim=0)
        latents, n_media = latents.repeat_interleave(k, dim=0), n_media.repeat_interleave(k, dim=0)
    noise = None
    if cfg.do_sample:
        noise = gumbel_noise(generator if generator is not None else torch.Generator(device=dev).manual_seed(0))

    def step_fn(tok, mask, cache, side=None):
        return model.decode_step(latents, tok, mask, cache, n_media, side)

    def decode():
        if k > 1:
            return beam_search(step_fn, first, cache, cfg, prompt_len=t, observe=observe)
        return greedy_or_sample(step_fn, first, cache, cfg, noise)

    if next_pixels is None:
        return decode()
    next_pixels = next_pixels.to(device=dev, dtype=model.dtype)
    # the schedule rides the fused route's K2 launches
    plan = make_plan(model.cfg, next_pixels.shape[:3], cfg.max_new_tokens, num_beams=k) if fused_route(dev) else None
    if plan is None:
        tokens = decode()
        return tokens, model.embed_vision(next_pixels)
    vit = model.vision_encoder
    xw = patch_embed_flat(vit, next_pixels.reshape(plan.bv, *next_pixels.shape[3:]), plan)
    tokens, xw = greedy_absorb(step_fn, first, cache, cfg, xw, vit.blocks, plan, noise)
    return tokens, model.resample_vision(finish_tokens(vit, xw, plan))
