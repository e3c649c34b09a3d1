"""Beam search in the port against the JAX package on the CPU.

  * tokens exactly equal to JAX `flamingo_generate(num_beams=3)` on a tiny
    MPT (ALiBi) Flamingo, full and left-padded masks, eos set and None,
    length_penalty 0 and 1, on the einsum route and under the fused hooks
    (the port's `FORCE_FUSED`, JAX `FORCE_FUSED` + `INTERPRET`), with
    `int8_kv` there (the JAX `scan_layers=True` model, its only int8
    cache), and with `next_pixels` (tokens and latents of JAX's serial
    fallback); tests/test_torch_beam_neox.py does the same for GPT-NeoX
    (RoPE), tests/test_torch_sample.py holds sampling;
  * `_gather_beams` on an int8 cache: the scales move with the values, in
    place, slots past the index and the media untouched.

The helpers here serve those two files too. Weights: the JAX init redrawn so that tiny random models emit varied
tokens (`varied`): every kernel N(0, (2 / sqrt(fan_in))^2) with zero-mean
columns (else the MLPs' mean output pulls every row to one token), the
embeddings unit rows times 3, the xattn gates 0.5. fp32 on both sides.
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
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu_torch import generation
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models.decoders.common import KVCache, LayerKV
from open_flamingo_tpu_torch.models.flamingo import Flamingo
from open_flamingo_tpu_torch.ops import dense_stream as port_ds

B, T_TXT, NEW, BEAMS = 2, 10, 8, 3
VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
FAMILIES = {
    "mpt": dict(
        lm=dict(family="mpt", vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                alibi=True, attention_bias=False, ln_no_bias=True, clip_qkv=6.0),
        flamingo=dict(media_token_id=5, eoc_token_id=6, cross_attn_every_n=1, num_vis_latents=4, perceiver_depth=1,
                      perceiver_heads=2, perceiver_dim_head=8),
        pad=1, ids_low=7, seed=0),
    "gptneox": dict(
        lm=dict(family="gptneox", vocab_size=67, hidden_size=160, num_layers=4, num_heads=2, intermediate_size=640,
                rotary_pct=0.5, use_parallel_residual=False, tie_word_embeddings=False),
        flamingo=dict(media_token_id=64, eoc_token_id=65, cross_attn_every_n=2, num_vis_latents=4,
                      perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8),
        pad=66, ids_low=0, seed=2),
}


def varied(params, rng):
    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "gate" in name:
            return jnp.full_like(x, 0.5)
        if "embedding" in name:
            e = rng.normal(size=x.shape).astype(np.float32)
            return jnp.asarray(3.0 * e / np.linalg.norm(e, axis=-1, keepdims=True))
        if x.ndim == 2:
            w = rng.normal(size=x.shape).astype(np.float32)
            return jnp.asarray((w - w.mean(axis=0, keepdims=True)) * 2.0 / np.sqrt(x.shape[0]))
        if name.endswith("['bias']"):
            return jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.1)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


def make_family(name):
    spec = FAMILIES[name]
    rng = np.random.default_rng(spec["seed"])
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**spec["lm"]), **spec["flamingo"])
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, 2, 1, 14, 14, 3)).astype(np.float32)
    media = spec["flamingo"]["media_token_id"]
    ids = rng.integers(spec["ids_low"], 64, size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = media
    ids[0, 4] = media
    params = varied(jax.jit(jmodel.init)(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids)), rng)
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**spec["lm"]), **spec["flamingo"])
    tmodel = Flamingo(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, vision_x, ids


@pytest.fixture(scope="module")
def mpt():
    return make_family("mpt")


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)


def left_pad(spec, ids, cols):
    """Row 0 left-padded by `cols`, row 1 not (right-filled to the width)."""
    if not cols:
        return ids, np.ones_like(ids)
    ids_p = np.concatenate([np.full((B, cols), spec["pad"], np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, cols), np.int32), np.ones_like(ids)], axis=1)
    ids_p[1] = np.concatenate([ids[1], np.full(cols, 9, np.int32)])
    mask[1] = 1
    return ids_p, mask


def t(a):
    return torch.from_numpy(np.asarray(a))


def gen_cfgs(spec, eos, length_penalty, **kw):
    kw = dict(max_new_tokens=NEW, num_beams=BEAMS, pad_token_id=spec["pad"], eos_token_id=eos,
              length_penalty=length_penalty, **kw)
    return JaxGenerationConfig(**kw), GenerationConfig(**kw)


def beams_equal_jax(family, name, cols, eos, lp):
    """Beam tokens of the port and of JAX on one family's models; they vary,
    and with eos a hypothesis finished and won or beams left greedy's path."""
    spec = FAMILIES[name]
    jmodel, params, tmodel, vision_x, ids = family
    ids, mask = left_pad(spec, ids, cols)
    jcfg, pcfg = gen_cfgs(spec, eos, lp)
    want = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, jcfg))
    got = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), pcfg, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    greedy = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), dataclasses.replace(pcfg, num_beams=1),
                               device="cpu").numpy()
    assert len(np.unique(want)) > 2
    if eos is not None:
        assert (want == eos).any() or not np.array_equal(want, greedy)


# left-pad columns, eos (None or a token the beams emit), length_penalty, route
MPT_CASES = {
    "full_eos_lp1": (0, 20, 1.0, "einsum"),
    "pad_eos_lp0": (3, 20, 0.0, "einsum"),
    "pad_noeos_lp1": (3, None, 1.0, "einsum"),
    "pad_eos_lp1_fused": (3, 20, 1.0, "fused"),
    "full_noeos_lp0_fused": (0, None, 0.0, "fused"),
}


@pytest.mark.parametrize("case", list(MPT_CASES))
def test_beam_tokens_equal_jax(mpt, request, case):
    cols, eos, lp, route = MPT_CASES[case]
    if route == "fused":
        request.getfixturevalue("fused")
    beams_equal_jax(mpt, "mpt", cols, eos, lp)


def test_beam_int8_kv_tokens_equal_jax(mpt, fused):
    """int8 K/V and media caches, the gather moving their scales: the JAX
    scan_layers=True model, the only one JAX gives an int8 cache."""
    spec = FAMILIES["mpt"]
    jmodel, params, tmodel, vision_x, ids = mpt
    scanned = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    s_vars = _scan_variables(params, jmodel)
    ids, mask = left_pad(spec, ids, 3)
    jcfg, pcfg = gen_cfgs(spec, 20, 1.0, int8_kv=True)
    created = []
    create = generation.KVCache.create

    def spy(*a, int8=False, **kw):
        created.append(int8)
        return create(*a, int8=int8, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generation.KVCache, "create", staticmethod(spy))
        got = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), pcfg, device="cpu").numpy()
    assert created == [True]
    want = np.asarray(jax_generate(scanned, s_vars, vision_x, ids, mask, jcfg))
    np.testing.assert_array_equal(got, want)


def test_beam_next_pixels_serial_fallback(mpt):
    """Beams take no absorb plan: tokens and latents of JAX's serial
    fallback (the tokens of the call without next_pixels)."""
    spec = FAMILIES["mpt"]
    jmodel, params, tmodel, vision_x, ids = mpt
    ids, mask = left_pad(spec, ids, 3)
    next_px = np.random.default_rng(5).normal(size=(B, 1, 1, 14, 14, 3)).astype(np.float32)
    jcfg, pcfg = gen_cfgs(spec, 20, 1.0)
    want_tok, want_lat = jax_generate(jmodel, params, vision_x, ids, mask, jcfg, next_pixels=next_px)
    got_tok, got_lat = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), pcfg, next_pixels=t(next_px),
                                         device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=1e-5, rtol=1e-5)
    plain = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), pcfg, device="cpu")
    torch.testing.assert_close(got_tok, plain, atol=0, rtol=0)


def test_gather_beams_moves_int8_scales_in_place(rng):
    lm = DecoderConfig(**FAMILIES["mpt"]["lm"])
    b, k, s, n = 2, 3, 16, 11
    cache = KVCache.create(lm, b * k, s, torch.float32, "cpu", int8=True)
    for layer in cache.layers:
        for x in (layer.k, layer.v):
            x.copy_(t(rng.integers(-127, 128, size=x.shape).astype(np.int8)))
        for x in (layer.k_s, layer.v_s):
            x[:, :, :n] = t(rng.uniform(0.01, 1.0, size=x[:, :, :n].shape).astype(np.float32))
    cache.pad_mask[:, :n] = t(rng.random(size=(b * k, n)) < 0.8)
    media = LayerKV(*(t(rng.normal(size=(b * k, 4, 8, 8)).astype(np.float32)) for _ in range(2)))
    cache = dataclasses.replace(cache, index=n, media=(media,))
    before = [[x.clone() for x in (kv.k, kv.v, kv.k_s, kv.v_s)] for kv in cache.layers]
    mask_before, media_before = cache.pad_mask.clone(), media.k.clone()
    ptrs = [x.data_ptr() for kv in cache.layers for x in (kv.k, kv.v, kv.k_s, kv.v_s)]
    idx = torch.tensor([[2, 0, 2], [1, 1, 0]])
    rows = (torch.arange(b)[:, None] * k + idx).reshape(-1)
    out = generation._gather_beams(cache, idx, b, k)
    assert [x.data_ptr() for kv in out.layers for x in (kv.k, kv.v, kv.k_s, kv.v_s)] == ptrs
    for kv, old in zip(out.layers, before):
        for x, o in zip((kv.k, kv.v, kv.k_s, kv.v_s), old):
            torch.testing.assert_close(x[:, :, :n], o[rows][:, :, :n], atol=0, rtol=0)
            torch.testing.assert_close(x[:, :, n:], o[:, :, n:], atol=0, rtol=0)
    torch.testing.assert_close(out.pad_mask, mask_before[rows], atol=0, rtol=0)
    torch.testing.assert_close(out.media[0].k, media_before, atol=0, rtol=0)
