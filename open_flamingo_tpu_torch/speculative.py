"""Speculative decoding: a draft model guesses, the target verifies (the JAX
package's `speculative.py`).

A small draft Flamingo (for example an int4 copy of the target's weights,
`quantize.quantize_decode_weights`) proposes `D` greedy tokens one at a
time on the fused decode route; the target verifies them in one forward of
the (B, D + 1) window, so its weights stream once per accepted run instead
of once per token. Verification is exact: the tokens are the target's own
greedy tokens, whatever the draft proposes (a bad draft only costs speed).

  * the draft always runs D + 1 single-token steps (the last writes the last
    draft's K/V, so full acceptance needs no catch-up step);
  * the verify window is always D + 1 tokens: under 8 it takes the einsum
    attention, from 8 on K4 and K5 at the cache's offset, as prefill does;
  * acceptance is lockstep over the batch (a = the minimum over rows,
    finished rows counted as D); rows that accepted more re-derive those
    tokens in the next iteration;
  * both caches roll back in place (`common.rollback`: `index`, the device
    `slot` and `pad_mask`); rejected slots are overwritten by the next
    window.

At the top of each iteration both caches hold the K/V of every committed
token except the newest (`last`), which is fed first. The loop reads the
host once an iteration: the accepted count and whether to go on.
"""

from __future__ import annotations

from typing import Optional

import torch

from .device import resolve_device
from .generation import GenerationConfig, _process_logits, prefill
from .models.decoders.common import rollback
from .models.flamingo import Flamingo, count_media


@torch.no_grad()
def speculative_generate(
    model: Flamingo,
    draft_model: Flamingo,
    vision_x: Optional[torch.Tensor],
    lang_x: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GenerationConfig,
    num_draft_tokens: int = 4,
    return_stats: bool = False,
    media_latents: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Greedy generate with draft speculation. Returns (B, max_new_tokens)
    ids, exactly what `flamingo_generate(model, ...)` greedy returns; with
    return_stats (ids, {"iters": draft + verify iterations}): max_new / iters
    is the mean of tokens committed per target forward. The draft reuses
    the target's latents (one vision encode; exactness never depends on the
    draft's inputs). `media_latents` skips the vision encode."""
    if cfg.do_sample or cfg.num_beams != 1:
        raise ValueError("speculative decoding is greedy-only")
    dev = resolve_device(device)
    for m in (model, draft_model):
        if m.device != dev:
            raise ValueError(f"model lives on {m.device}, generate asked for {dev}")
    lang_x, attention_mask = lang_x.to(dev), attention_mask.to(dev)
    d = num_draft_tokens
    b, t = lang_x.shape
    max_new, pad, eos = cfg.max_new_tokens, cfg.pad_token_id, cfg.eos_token_id
    # room for the last window's overshoot, rounded up to 16 slots
    cache_len = -(-(t + max_new + d + 1) // 16) * 16

    if media_latents is not None:
        latents = media_latents.to(device=dev, dtype=model.dtype)
    else:
        latents = model.embed_vision(vision_x.to(device=dev, dtype=model.dtype))
    t_logits0, t_cache = prefill(model, latents, lang_x, attention_mask, cache_len)
    d_latents = latents.to(draft_model.dtype)
    _, d_cache = prefill(draft_model, d_latents, lang_x, attention_mask, cache_len)
    n_media_t = count_media(lang_x, model.cfg.media_token_id)
    n_media_d = count_media(lang_x, draft_model.cfg.media_token_id)
    ones = torch.ones(b, 1, dtype=torch.long, device=dev)
    window_ones = torch.ones(b, d + 1, dtype=torch.long, device=dev)

    # the first token comes from the target's prefill logits
    last = torch.argmax(_process_logits(t_logits0[:, -1], 0, cfg), dim=-1)
    finished = last == eos if eos is not None else torch.zeros(b, dtype=torch.bool, device=dev)
    out = torch.full((b, max_new + d + 1), pad, dtype=torch.long, device=dev)
    out[:, 0] = last
    n, iters = 1, 0
    go = n < max_new and not bool(finished.all())
    while go:
        # draft: D + 1 single-token steps, fed [last, d_1 .. d_D]
        tok, feds = last, []
        for i in range(d + 1):
            logits, d_cache = draft_model.decode_step(d_latents, tok[:, None], ones, d_cache, n_media_d)
            feds.append(tok)
            tok = torch.argmax(_process_logits(logits[:, -1], n + i, cfg), dim=-1)
        feds = torch.stack(feds, dim=1)                                   # (B, D + 1)

        # verify: one target forward over the window
        t_logits, t_cache = model.decode_step(latents, feds, window_ones, t_cache, n_media_t)  # (B, D + 1, V)
        greedy = torch.stack([torch.argmax(_process_logits(t_logits[:, j - 1], n - 1 + j, cfg), dim=-1)
                              for j in range(1, d + 1)], dim=1)          # the target's token at n - 1 + j
        a_b = torch.cumprod((feds[:, 1:] == greedy).long(), dim=1).sum(1)
        # finished rows emit pad whatever their drafts: they never throttle
        a = torch.where(finished, d, a_b).min()                           # lockstep acceptance

        # the bonus token: the target's greedy continuation after `a` drafts
        bonus_logits = torch.gather(t_logits, 1, a.reshape(1, 1, 1).expand(b, 1, t_logits.shape[-1]))[:, 0]
        bonus = torch.argmax(_process_logits(bonus_logits, n + a, cfg), dim=-1)

        # emit [d_1 .. d_a, bonus, pad ...] with each row's EOS chain
        fin = finished
        for j in range(d + 1):
            raw = torch.where(j < a, feds[:, min(j + 1, d)], torch.where(j == a, bonus, pad))
            tok = torch.where(fin | (j > a), pad, raw)
            if eos is not None:
                fin = fin | ((tok == eos) & (j <= a))
            last = torch.where(j == a, tok, last)      # the token at the last committed position
            out[:, n + j] = tok
        finished = fin
        # the one host read of the iteration: the accepted count and the
        # loop's condition
        a_host, all_done = torch.stack([a, fin.all().long()]).tolist()

        # roll both caches back to the a + 1 accepted window slots
        start = t + n - 1
        rollback(t_cache, start, a_host + 1, d + 1)
        rollback(d_cache, start, a_host + 1, d + 1)
        n += a_host + 1
        iters += 1
        go = n < max_new and not all_done
    out = out[:, :max_new]
    return (out, {"iters": iters}) if return_stats else out
