"""The port's fused decode route (K3 attn_block_decode and K2 fused_mlp in
every block, K1 fused_dense as the head) against the JAX package's on the
CPU. Both packages take the route through their test hooks: JAX's
`FORCE_FUSED` + `INTERPRET` (Pallas interpret mode), the port's
`FORCE_FUSED` (each wrapper runs its plain version on CPU tensors).

  * one MPTBlock decode step (output and caches) and one
    GatedCrossAttentionBlock decode step, weights moved by
    `convert/from_jax.py`, as tests/test_dense_stream.py holds the JAX
    blocks' fused steps against their einsum steps;
  * the slice: greedy tokens exactly equal to JAX `flamingo_generate`, with
    and without left padding, and to the port's unfused route; the logits
    of prefill and of every decode step on one token stream; and the JAX
    package's `scan_layers=True` model (its stacked-weight decode engine,
    `models/scan_decode.py`), whose weights the port reads by unstacking.

fp32 on both sides, atol 2e-5 for one block (the JAX package's bound for
these steps) and 1e-4 for logits through the whole tiny model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_layers import _scan_variables

from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import make_attn_inputs as jax_attn_inputs
from open_flamingo_tpu.models.decoders.mpt import MPTBlock as JaxMPTBlock
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.flamingo import count_media as jax_count_media
from open_flamingo_tpu.models.lm import extract_media_kv
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.models.xattn import GatedCrossAttentionBlock as JaxGated
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models import lm as port_lm
from open_flamingo_tpu_torch.models import xattn as port_xattn
from open_flamingo_tpu_torch.models.decoders import mpt as port_mpt
from open_flamingo_tpu_torch.models.decoders.common import KVCache, make_attn_inputs
from open_flamingo_tpu_torch.models.decoders.mpt import MPTBlock
from open_flamingo_tpu_torch.models.flamingo import Flamingo, count_media
from open_flamingo_tpu_torch.models.xattn import GatedCrossAttentionBlock
from open_flamingo_tpu_torch.ops import dense_stream as port_ds

BLOCK_ATOL = 2e-5
LOGITS_ATOL = 1e-4


@pytest.fixture
def fused(monkeypatch):
    """Both packages on the fused decode route; counts the port's calls of
    each plain version on it (K1 head, K2 and K3 in the blocks)."""
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(port_lm, "reference_dense", "K1")
    for module in (port_mpt, port_xattn):
        counted(module, "reference_mlp", "K2")
    counted(port_mpt, "reference_attn_block", "K3")
    counted(port_xattn, "reference_attn_block", "K3")
    return calls


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return module


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


MPT_BLOCK = dict(
    family="mpt", vocab_size=64, hidden_size=128, num_layers=1, num_heads=2, intermediate_size=256,
    alibi=True, ln_no_bias=True, clip_qkv=6.0, attention_bias=False,
)


def test_mpt_block_decode_step_matches_jax(rng, fused):
    b, t, s = 2, 4, 8
    jcfg = JaxDecoderConfig(**MPT_BLOCK)
    jm = JaxMPTBlock(cfg=jcfg)
    x = rng.normal(size=(b, t, 128)).astype(np.float32)
    cache = JaxKVCache.create(jcfg, b, max_length=s)
    attn, cache = jax_attn_inputs(jnp.ones((b, t), jnp.int32), cache=cache)
    params = jm.init(jax.random.PRNGKey(0), x, attn, cache.layers[0])
    _, kv = jm.apply(params, x, attn, cache.layers[0])                # prefill (t > 1: not fused)
    cache = cache.replace(layers=(kv,), index=cache.index + t)
    xt = rng.normal(size=(b, 1, 128)).astype(np.float32)
    attn1, cache1 = jax_attn_inputs(jnp.ones((b, 1), jnp.int32), cache=cache)
    want, want_kv = jm.apply(params, xt, attn1, cache1.layers[0])

    # the port's cache holds the same prefill K/V, four slots written
    tm = load(MPTBlock(DecoderConfig(**MPT_BLOCK), device="cpu"), params)
    tcache = KVCache.create(DecoderConfig(**MPT_BLOCK), b, s, torch.float32, "cpu")
    tcache.layers[0].k.copy_(torch.from_numpy(np.array(kv.k)))
    tcache.layers[0].v.copy_(torch.from_numpy(np.array(kv.v)))
    tcache.pad_mask[:, :t] = True
    tcache = dataclasses.replace(tcache, index=t, slot=torch.tensor([t], dtype=torch.int32))
    tattn, tcache = make_attn_inputs(torch.ones(b, 1, dtype=torch.long), cache=tcache)
    with torch.no_grad():        # the decode kernels are forward-only (refuse_autograd)
        got, got_kv = tm(torch.from_numpy(xt), tattn, tcache.layers[0])
    assert fused == {"K1": 0, "K2": 1, "K3": 1}
    close(got, want, BLOCK_ATOL)
    close(got_kv.k, want_kv.k, BLOCK_ATOL)
    close(got_kv.v, want_kv.v, BLOCK_ATOL)


def test_gated_xattn_decode_step_matches_jax(rng, fused):
    d, dv, heads, dh = 128, 96, 2, 64
    jm = JaxGated(dim=d, dim_visual=dv, dim_head=dh, heads=heads)
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    media = rng.normal(size=(2, 2, 8, dv)).astype(np.float32)
    text_time = np.array([[1], [0]], np.int32)      # row 1: no preceding image
    params = jm.init(jax.random.PRNGKey(0), x, media, text_time)
    params = jax.tree.map(lambda a: jnp.full_like(a, 0.4) if a.shape == (1,) else a, params)
    _, state = jm.apply(params, x, media, text_time, mutable=["media_kv"])
    mk, mv = jax.tree.leaves(state["media_kv"])
    want = jm.apply(params, x, media, text_time, media_kv=(mk, mv))

    tm = load(GatedCrossAttentionBlock(d, dv, dim_head=dh, heads=heads, device="cpu"), params)
    media_kv = (torch.from_numpy(np.array(mk)), torch.from_numpy(np.array(mv)))
    with torch.no_grad():        # the decode kernels are forward-only (refuse_autograd)
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(media), torch.from_numpy(text_time), media_kv)
    assert fused == {"K1": 0, "K2": 1, "K3": 1}
    close(got, want, BLOCK_ATOL)


# ---------------------------------------------------------------- the slice

VOCAB, MEDIA, EOC, PAD = 64, 5, 6, 1
B, T_TXT, NEW = 2, 10, 5
VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
LM = dict(
    family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    alibi=True, attention_bias=False, ln_no_bias=True, clip_qkv=6.0,
)
FLAMINGO = dict(
    media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1,
    num_vis_latents=4, perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8,
)
JAX_GEN = JaxGenerationConfig(max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2)
GEN = GenerationConfig(max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(1)
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**LM), **FLAMINGO)
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, 2, 1, 14, 14, 3)).astype(np.float32)
    ids = rng.integers(7, VOCAB, size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = MEDIA
    ids[0, 4] = MEDIA
    params = jmodel.init(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO)
    tmodel = load(Flamingo(tcfg, device="cpu"), params)
    return jmodel, params, tmodel, vision_x, ids


def left_pad(ids, cols):
    """Row 0 left-padded by `cols`, row 1 not (right-filled to the width)."""
    ids_p = np.concatenate([np.full((B, cols), PAD, np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, cols), np.int32), np.ones_like(ids)], axis=1)
    ids_p[1] = np.concatenate([ids[1], np.full(cols, 9, np.int32)])
    mask[1] = 1
    return ids_p, mask


def port_generate(tmodel, vision_x, ids, mask):
    return flamingo_generate(tmodel, torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask),
                             GEN, device="cpu").numpy()


@pytest.mark.parametrize("pad_cols", [0, 3])
def test_greedy_tokens_equal_jax(models, fused, monkeypatch, pad_cols):
    jmodel, params, tmodel, vision_x, ids = models
    ids, mask = left_pad(ids, pad_cols)
    want = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, JAX_GEN))
    got = port_generate(tmodel, vision_x, ids, mask)
    steps = NEW - 1
    assert fused == {"K1": steps, "K2": 4 * steps, "K3": 4 * steps}
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", False)      # the port's unfused route
    np.testing.assert_array_equal(port_generate(tmodel, vision_x, ids, mask), want)
    assert fused["K1"] == steps


def test_step_logits_match_jax(models, fused):
    """Prefill's last position, then every decode step fed one token stream
    (JAX's greedy one)."""
    jmodel, params, tmodel, vision_x, ids = models
    mask = np.ones_like(ids)
    s = -(-(T_TXT + NEW) // 16) * 16
    stream = np.zeros((B, NEW), np.int32)

    lat = jmodel.apply(params, vision_x, method=JaxFlamingo.embed_vision)
    (logits, _, cache), variables = jmodel.apply(
        params, None, ids, mask, media_latents=lat, cache=JaxKVCache.create(jmodel.cfg.lm, B, s),
        mutable=["media_kv"])
    cache = cache.replace(media=extract_media_kv(variables, False))
    n_media = jax_count_media(jnp.asarray(ids), MEDIA)
    want = [logits[:, -1]]
    for i in range(NEW - 1):
        stream[:, i] = np.argmax(np.asarray(want[-1]), axis=-1)
        step, cache = jmodel.apply(params, lat, stream[:, i:i + 1], np.ones((B, 1), np.int32), cache, n_media,
                                   method=JaxFlamingo.decode_step)
        want.append(step[:, 0])

    ids_t = torch.from_numpy(ids)
    tlat = tmodel.embed_vision(torch.from_numpy(vision_x))
    logits_t, _, tcache = tmodel(None, ids_t, torch.ones_like(ids_t), media_latents=tlat,
                                 cache=KVCache.create(tmodel.cfg.lm, B, s, torch.float32, "cpu"))
    got = [logits_t[:, -1]]
    t_media = count_media(ids_t, MEDIA)
    for i in range(NEW - 1):
        step, tcache = tmodel.decode_step(tlat, torch.from_numpy(stream[:, i:i + 1]),
                                          torch.ones(B, 1, dtype=torch.long), tcache, t_media)
        got.append(step[:, 0])
    assert fused["K1"] == NEW - 1
    for g, w in zip(got, want):
        close(g, w, LOGITS_ATOL)


def test_scan_layers_model_tokens_equal(models, fused, monkeypatch):
    """The JAX package's stacked-weight decode engine, weights unstacked
    into the port's per-layer modules."""
    from open_flamingo_tpu.models import scan_decode

    engine = scan_decode.scan_fused_decode
    steps = []
    monkeypatch.setattr(scan_decode, "scan_fused_decode", lambda *a, **kw: steps.append(1) or engine(*a, **kw))
    jmodel, params, _, vision_x, ids = models
    scanned = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    s_vars = _scan_variables(params, jmodel)
    assert "groups" in s_vars["params"]["lm"]
    want = np.asarray(jax_generate(scanned, s_vars, vision_x, ids, np.ones_like(ids), JAX_GEN))
    assert steps, "the JAX scan model did not take its stacked-weight decode engine"
    tmodel = load(Flamingo(FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO),
                           device="cpu"), s_vars)
    np.testing.assert_array_equal(port_generate(tmodel, vision_x, ids, np.ones_like(ids)), want)
