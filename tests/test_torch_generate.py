"""The PyTorch port's tiny OF-3B-shaped Flamingo against the JAX package on
the CPU: full-forward logits, prefill + decode against the full forward,
and greedy tokens exactly equal to JAX's `flamingo_generate`, with and
without left padding.

Weights come from the JAX init through `convert/from_jax.py`, with the
xattn gates set to 0.5 so the cross-attention reaches the logits. The
port runs its einsum path on the CPU, as the JAX package does there.
Logits are compared at non-pad query positions only: a fully-masked
(left-pad) query row is uniform in both einsum paths but depends on pad
keys, which the two cache layouts fill differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models.decoders.common import KVCache
from open_flamingo_tpu_torch.models.flamingo import Flamingo, count_media, init_random

VOCAB, MEDIA, EOC, PAD = 64, 5, 6, 1
B, T_IMG, T_TXT = 2, 2, 10
# fp32 on both sides; the two einsum paths sum in different orders, and a
# 2-layer model keeps the difference near 1e-6 (test_flamingo.py uses 2e-5)
ATOL = RTOL = 1e-4

VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=2, num_heads=2, intermediate_size=32)
LM = dict(
    family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, alibi=True, attention_bias=False, ln_no_bias=True,
)
FLAMINGO = dict(
    media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1,
    num_vis_latents=4, perceiver_depth=2, perceiver_heads=2, perceiver_dim_head=8,
)


def set_gates(params, value=0.5):
    """Nonzero xattn gates (they initialise to 0)."""
    def f(path, x):
        name = jax.tree_util.keystr(path)
        return jnp.full_like(x, value) if ("attn_gate" in name or "ff_gate" in name) else x
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**LM), **FLAMINGO)
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, T_IMG, 1, 14, 14, 3)).astype(np.float32)
    ids = rng.integers(7, VOCAB, size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = MEDIA
    ids[:, 4] = MEDIA
    params = jmodel.init(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids))
    params = set_gates(params)
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO)
    tmodel = Flamingo(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, vision_x, ids


def left_pad(ids, cols):
    ids_p = np.concatenate([np.full((B, cols), PAD, np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, cols), np.int32), np.ones_like(ids)], axis=1)
    # row 1 keeps no padding: a batch mixes padded and unpadded rows
    ids_p[1] = np.concatenate([ids[1], np.full(cols, 9, np.int32)])
    mask[1] = 1
    return ids_p, mask


@pytest.mark.parametrize("pad_cols", [0, 3])
def test_full_forward_logits_match_jax(models, pad_cols):
    jmodel, params, tmodel, vision_x, ids = models
    ids, mask = left_pad(ids, pad_cols)
    want, jlat, _ = jmodel.apply(params, vision_x, ids, mask)
    with torch.no_grad():        # the forward is differentiable: no graph for a comparison
        got, tlat, _ = tmodel(torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=ATOL, rtol=RTOL)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=ATOL, rtol=RTOL)


def test_prefill_decode_matches_full(models):
    """Prefill into the cache, then cached-media decode steps, equal the
    full forward (positions after the last media token)."""
    _, _, tmodel, vision_x, ids = models
    ids_t = torch.from_numpy(ids)
    mask = torch.ones_like(ids_t)
    full, latents, _ = tmodel(torch.from_numpy(vision_x), ids_t, mask)
    t_prompt = 7
    cache = KVCache.create(tmodel.cfg.lm, B, T_TXT + 2, torch.float32, "cpu")
    logits, _, cache = tmodel(None, ids_t[:, :t_prompt], mask[:, :t_prompt], media_latents=latents, cache=cache)
    torch.testing.assert_close(logits, full[:, :t_prompt], atol=2e-5, rtol=1e-5)
    assert cache.media is not None and len(cache.media) == tmodel.cfg.lm.num_layers
    n_media = count_media(ids_t[:, :t_prompt], MEDIA)
    for t in range(t_prompt, T_TXT):
        step, cache = tmodel.decode_step(latents, ids_t[:, t:t + 1], mask[:, t:t + 1], cache, n_media)
        torch.testing.assert_close(step[:, 0], full[:, t], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("pad_cols", [0, 3])
def test_greedy_tokens_equal_jax(models, pad_cols):
    jmodel, params, tmodel, vision_x, ids = models
    ids, mask = left_pad(ids, pad_cols)
    want = jax_generate(
        jmodel, params, vision_x, ids, mask,
        JaxGenerationConfig(max_new_tokens=6, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2),
    )
    got = flamingo_generate(
        tmodel, torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask),
        GenerationConfig(max_new_tokens=6, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2),
        device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_media_latents_argument_skips_vision(models):
    _, _, tmodel, vision_x, ids = models
    ids_t, mask = torch.from_numpy(ids), torch.ones(B, T_TXT, dtype=torch.long)
    cfg = GenerationConfig(max_new_tokens=4, pad_token_id=PAD)
    latents = tmodel.embed_vision(torch.from_numpy(vision_x))
    a = flamingo_generate(tmodel, torch.from_numpy(vision_x), ids_t, mask, cfg, device="cpu")
    b = flamingo_generate(tmodel, None, ids_t, mask, cfg, media_latents=latents, device="cpu")
    torch.testing.assert_close(a, b)


def test_init_random_is_seeded_and_gated():
    """One seed gives the same weights in every dtype, and the xattn gates
    are nonzero so the cross-attention reaches the logits."""
    cfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO)
    a = init_random(cfg, seed=3, device="cpu")
    b = init_random(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa.to(torch.bfloat16), pb, atol=0, rtol=0, msg=name)
    assert all(float(blk.attn_gate) == 0.5 and float(blk.ff_gate) == 0.5 for blk in a.lm.xattn.values())
    assert not torch.equal(a.lm.wte.weight, init_random(cfg, seed=4, device="cpu").lm.wte.weight)
