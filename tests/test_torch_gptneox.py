"""The port's GPT-NeoX slice (OF-4B-shaped: RedPajama-INCITE's family,
untied LM head, xattn before every second layer) against the JAX package
on the CPU, at head dim 80 as on the real model.

  * RoPE tables and rotation (`rotary_pct` 1.0 and 0.25);
  * K6: the port's `reference_attend_out` against JAX `attend_out_decode` in
    Pallas interpret mode, with and without the slot write, bias, gate,
    residual, ALiBi, an all-masked row, the slot at 0 and S - 1, and GQA;
  * one GPTNeoXBlock in both residual modes: prefill, and one fused decode
    step (K1, RoPE, K6, K2) with the JAX block under `FORCE_FUSED` +
    `INTERPRET` (the port's `FORCE_FUSED` runs each wrapper's plain
    version on CPU tensors);
  * the slice: greedy tokens exactly equal to JAX `flamingo_generate` on
    the fused and the unfused route, with a left-padded row; the logits of
    prefill and every decode step on both routes; the JAX `scan_layers=True`
    model, whose weights the port reads by unstacking groups of two blocks
    and one xattn block.

fp32 on both sides: atol 1e-6 for RoPE, 2e-5 for K6 and one block (the JAX
package's bound for these steps), 1e-4 for logits through the tiny model.
Biases are drawn at random (flax initialises them to 0) so that every bias
epilogue does work.
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
from open_flamingo_tpu.models.decoders import common as jax_common
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import make_attn_inputs as jax_attn_inputs
from open_flamingo_tpu.models.decoders.gptneox import GPTNeoXBlock as JaxGPTNeoXBlock
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.flamingo import count_media as jax_count_media
from open_flamingo_tpu.models.lm import extract_media_kv
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops.decode_layer import attend_out_decode as jax_attend_out
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models import lm as port_lm
from open_flamingo_tpu_torch.models import xattn as port_xattn
from open_flamingo_tpu_torch.models.decoders import gptneox as port_gptneox
from open_flamingo_tpu_torch.models.decoders.common import KVCache, apply_rope, make_attn_inputs, rope_cos_sin
from open_flamingo_tpu_torch.models.decoders.gptneox import GPTNeoXBlock
from open_flamingo_tpu_torch.models.flamingo import Flamingo, count_media
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops.decode_layer import reference_attend_out

ROPE_ATOL = 1e-6
BLOCK_ATOL = 2e-5
LOGITS_ATOL = 1e-4


@pytest.fixture
def fused(monkeypatch):
    """Both packages on the fused decode route; counts the port's calls of
    each plain version on it (K1 QKV and head, K2, K3 in xattn, K6)."""
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    calls = {"K1": 0, "K2": 0, "K3": 0, "K6": 0}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for module in (port_lm, port_gptneox):
        counted(module, "reference_dense", "K1")
    for module in (port_gptneox, port_xattn):
        counted(module, "reference_mlp", "K2")
    counted(port_xattn, "reference_attn_block", "K3")
    counted(port_gptneox, "reference_attend_out", "K6")
    return calls


def random_biases(params, seed):
    """Every `bias` leaf drawn from N(0, 0.1^2) (numpy, from `seed`)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(rng.normal(size=p.shape) * 0.1, p.dtype)
        if jax.tree_util.keystr(path).endswith("['bias']") else p, params)


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return module


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- RoPE


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_rope_matches_jax(rng, rotary_pct):
    b, tq, h, dh = 2, 12, 3, 80
    rd = int(dh * rotary_pct)
    mask = np.ones((b, tq), np.int32)
    mask[0, :5] = 0                                     # left padding: positions from the mask
    pos = np.clip(np.cumsum(mask, -1) - 1, 0, None) + 17
    q, k = (rng.normal(size=(b, tq, h, dh)).astype(np.float32) for _ in range(2))
    cos_j, sin_j = jax_common.rope_cos_sin(jnp.asarray(pos), rd, 10000.0)
    q_j, k_j = jax_common.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    cos_t, sin_t = rope_cos_sin(torch.from_numpy(pos), rd, 10000.0)
    q_t, k_t = apply_rope(t(q), t(k), cos_t, sin_t)
    for got, want in ((cos_t, cos_j), (sin_t, sin_j), (q_t, q_j), (k_t, k_j)):
        close(got, want, ROPE_ATOL)
    np.testing.assert_array_equal(q_t[..., rd:].numpy(), q[..., rd:])


# ---------------------------------------------------------------- K6

K6_CASES = {
    "media_gate_residual_masked_row": dict(gate=True, residual=True, masked_row=True),
    "media_bare": dict(),
    "update_slot7_alibi_residual": dict(slot=7, alibi=True, residual=True),
    "update_slot0_bias": dict(slot=0, bias=True),
    "update_slotlast_all_epilogue_masked_row": dict(slot=31, bias=True, gate=True, residual=True, masked_row=True),
    "update_gqa2_bias": dict(slot=12, bias=True, n_rep=2),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_reference_attend_out_matches_jax(rng, case):
    opt = K6_CASES[case]
    b, h, dh, s, d = 3, 4, 80, 32, 96
    h_kv = h // opt.get("n_rep", 1)
    update = "slot" in opt

    def rn(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    q, kc, vc = rn(b, h, dh), rn(b, h_kv, s, dh), rn(b, h_kv, s, dh)
    wout = rn(h, dh, d, scale=0.1)                      # JAX's head-sliced (H, Dh, D)
    mask = rng.integers(0, 2, size=(b, s)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if update:
        slot = opt["slot"]
        mask[:, slot] = 1
        kn, vn = rn(b, h_kv, dh), rn(b, h_kv, dh)
        kw_j.update(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), slot=jnp.asarray(slot, jnp.int32))
        kw_t.update(k_new=t(kn), v_new=t(vn), slot=torch.tensor([slot], dtype=torch.int32))
    if opt.get("masked_row"):
        mask[2] = 0                                     # no valid key: the epilogue of a zero attention
    if opt.get("alibi"):
        slopes = np.asarray([0.5 ** (i + 1) for i in range(h)], np.float32)
        kw_j["slopes"], kw_t["slopes"] = slopes, t(slopes)
    for name, shape in (("bias", (d,)), ("gate", (1,)), ("residual", (b, d))):
        if opt.get(name):
            val = rn(*shape)
            kw_j[name], kw_t[name] = jnp.asarray(val), t(val)

    got = jax_attend_out(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mask), jnp.asarray(wout),
                         scale=dh**-0.5, interpret=True, **kw_j)
    kc_t, vc_t = t(kc), t(vc)
    mine = reference_attend_out(t(q), kc_t, vc_t, t(mask), t(wout.reshape(h * dh, d).T), scale=dh**-0.5, **kw_t)
    if update:
        (got, got_k, got_v), (mine, mine_k, mine_v) = got, mine
        np.testing.assert_array_equal(mine_k.numpy(), np.asarray(got_k))
        np.testing.assert_array_equal(mine_v.numpy(), np.asarray(got_v))
        assert mine_k is kc_t and mine_v is vc_t        # written in place
    close(mine, got, BLOCK_ATOL)
    if opt.get("masked_row"):
        y = torch.zeros(d)
        if "bias" in kw_t:
            y = y + kw_t["bias"]
        if "gate" in kw_t:
            y = y * torch.tanh(kw_t["gate"])
        if "residual" in kw_t:
            y = y + kw_t["residual"][2]
        assert torch.equal(mine[2], y)


# ---------------------------------------------------------------- one block

BLOCK = dict(family="gptneox", vocab_size=64, hidden_size=160, num_layers=1, num_heads=2, intermediate_size=640,
             tie_word_embeddings=False)


@pytest.mark.parametrize("parallel", [False, True])
def test_gptneox_block_prefill_and_decode_step_match_jax(rng, fused, parallel):
    b, tq, s = 2, 4, 8
    cfg = dict(BLOCK, use_parallel_residual=parallel)
    jcfg = JaxDecoderConfig(**cfg)
    jm = JaxGPTNeoXBlock(cfg=jcfg)
    x = rng.normal(size=(b, tq, 160)).astype(np.float32)
    am = np.ones((b, tq), np.int32)
    am[1, :2] = 0                                       # row 1 left-padded by 2
    cache = JaxKVCache.create(jcfg, b, max_length=s)
    attn, cache = jax_attn_inputs(jnp.asarray(am), cache=cache)
    params = random_biases(jm.init(jax.random.PRNGKey(0), x, attn, cache.layers[0]), 1)
    want_pre, kv = jm.apply(params, x, attn, cache.layers[0])         # prefill (tq > 1: not fused)
    cache = cache.replace(layers=(kv,), index=cache.index + tq)
    xt = rng.normal(size=(b, 1, 160)).astype(np.float32)
    attn1, cache1 = jax_attn_inputs(jnp.ones((b, 1), jnp.int32), cache=cache)
    want, want_kv = jm.apply(params, xt, attn1, cache1.layers[0])

    tcfg = DecoderConfig(**cfg)
    tm = load(GPTNeoXBlock(tcfg, device="cpu"), params)
    tcache = KVCache.create(tcfg, b, s, torch.float32, "cpu")
    tattn, tcache = make_attn_inputs(t(am), cache=tcache)
    with torch.no_grad():       # the decode kernels are forward-only (refuse_autograd)
        got_pre, _ = tm(t(x), tattn, tcache.layers[0])
        close(got_pre, want_pre, BLOCK_ATOL)
        close(tcache.layers[0].k, kv.k, BLOCK_ATOL)
        close(tcache.layers[0].v, kv.v, BLOCK_ATOL)
        tcache = dataclasses.replace(tcache, index=tq, slot=torch.tensor([tq], dtype=torch.int32))
        tattn1, tcache = make_attn_inputs(torch.ones(b, 1, dtype=torch.long), cache=tcache)
        got, got_kv = tm(t(xt), tattn1, tcache.layers[0])
    assert fused == {"K1": 1, "K2": 1, "K3": 0, "K6": 1}
    close(got, want, BLOCK_ATOL)
    close(got_kv.k, want_kv.k, BLOCK_ATOL)
    close(got_kv.v, want_kv.v, BLOCK_ATOL)


# ---------------------------------------------------------------- the slice

MEDIA, EOC, PAD = 64, 65, 66
VOCAB = 67                                              # 64 + <image>, <|endofchunk|>, pad
B, T_TXT, NEW = 2, 10, 5
VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
LM = dict(family="gptneox", vocab_size=VOCAB, hidden_size=160, num_layers=4, num_heads=2, intermediate_size=640,
          use_parallel_residual=False, tie_word_embeddings=False)
FLAMINGO = dict(media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=2, num_vis_latents=4,
                perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8)
JAX_GEN = JaxGenerationConfig(max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2)
GEN = GenerationConfig(max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2)


def port_model(params):
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO)
    return load(Flamingo(tcfg, device="cpu"), params)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(2)
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**LM), **FLAMINGO)
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, 2, 1, 14, 14, 3)).astype(np.float32)
    ids = rng.integers(0, 64, size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = MEDIA
    ids[0, 4] = MEDIA
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)
    params = random_biases(params, 3)
    return jmodel, params, port_model(params), vision_x, ids


def left_pad(ids, cols):
    """Row 0 left-padded by `cols`, row 1 not (right-filled to the width)."""
    ids_p = np.concatenate([np.full((B, cols), PAD, np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, cols), np.int32), np.ones_like(ids)], axis=1)
    ids_p[1] = np.concatenate([ids[1], np.full(cols, 9, np.int32)])
    mask[1] = 1
    return ids_p, mask


def port_generate(tmodel, vision_x, ids, mask):
    return flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), GEN, device="cpu").numpy()


def test_greedy_tokens_equal_jax(models, fused, monkeypatch):
    """One batch with a left-padded row and a row without padding (the
    unpadded batch is covered by the logits and scan tests)."""
    jmodel, params, tmodel, vision_x, ids = models
    ids, mask = left_pad(ids, 3)
    want = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, JAX_GEN))
    got = port_generate(tmodel, vision_x, ids, mask)
    steps, layers = NEW - 1, LM["num_layers"]
    assert fused == {"K1": steps * (layers + 1), "K2": steps * (layers + layers // 2), "K3": steps * layers // 2,
                     "K6": steps * layers}
    np.testing.assert_array_equal(got, want)
    # the unfused route of both packages (einsum attention over the cache)
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", False)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", False)
    want_u = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, JAX_GEN))
    np.testing.assert_array_equal(port_generate(tmodel, vision_x, ids, mask), want_u)
    np.testing.assert_array_equal(want_u, want)
    assert fused["K6"] == steps * layers


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_step_logits_match_jax(models, fused, monkeypatch, route):
    """Prefill's last position, then every decode step fed one token stream
    (JAX's greedy one)."""
    if route == "unfused":
        monkeypatch.setattr(jax_ds, "FORCE_FUSED", False)
        monkeypatch.setattr(port_ds, "FORCE_FUSED", False)
    jmodel, params, tmodel, vision_x, ids = models
    mask = np.ones_like(ids)
    s = -(-(T_TXT + NEW) // 16) * 16
    stream = np.zeros((B, NEW), np.int32)

    lat = jmodel.apply(params, vision_x, method=JaxFlamingo.embed_vision)
    prefill = jax.jit(lambda p, c: jmodel.apply(p, None, ids, mask, media_latents=lat, cache=c,
                                                mutable=["media_kv"]))
    decode = jax.jit(lambda p, tok, c: jmodel.apply(p, lat, tok, np.ones((B, 1), np.int32), c, n_media,
                                                    method=JaxFlamingo.decode_step))
    (logits, _, cache), variables = prefill(params, JaxKVCache.create(jmodel.cfg.lm, B, s))
    cache = cache.replace(media=extract_media_kv(variables, False))
    n_media = jax_count_media(jnp.asarray(ids), MEDIA)
    want = [logits[:, -1]]
    for i in range(NEW - 1):
        stream[:, i] = np.argmax(np.asarray(want[-1]), axis=-1)
        step, cache = decode(params, stream[:, i:i + 1], cache)
        want.append(step[:, 0])

    ids_t = t(ids)
    tlat = tmodel.embed_vision(t(vision_x))
    logits_t, _, tcache = tmodel(None, ids_t, torch.ones_like(ids_t), media_latents=tlat,
                                 cache=KVCache.create(tmodel.cfg.lm, B, s, torch.float32, "cpu"))
    got = [logits_t[:, -1]]
    t_media = count_media(ids_t, MEDIA)
    for i in range(NEW - 1):
        step, tcache = tmodel.decode_step(tlat, t(stream[:, i:i + 1]), torch.ones(B, 1, dtype=torch.long), tcache,
                                          t_media)
        got.append(step[:, 0])
    assert fused["K6"] == (NEW - 1) * LM["num_layers"] * (route == "fused")
    for g, w in zip(got, want):
        close(g, w, LOGITS_ATOL)


def test_scan_layers_model_tokens_equal(models, fused, monkeypatch):
    """The JAX package's stacked-weight decode engine at cross_attn_every_n
    = 2 (groups of block_0, block_1 and xattn); the port reads its weights
    by unstacking, into the same state_dict as from the unrolled layout."""
    from open_flamingo_tpu.models import scan_decode

    engine = scan_decode.scan_fused_decode
    steps = []
    monkeypatch.setattr(scan_decode, "scan_fused_decode", lambda *a, **kw: steps.append(1) or engine(*a, **kw))
    jmodel, params, tmodel, vision_x, ids = models
    scanned = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    s_vars = _scan_variables(params, jmodel)
    groups = s_vars["params"]["lm"]["groups"]
    assert sorted(groups) == ["block_0", "block_1", "xattn"]
    want = np.asarray(jax_generate(scanned, s_vars, vision_x, ids, np.ones_like(ids), JAX_GEN))
    assert steps, "the JAX scan model did not take its stacked-weight decode engine"
    from_scan = port_model(s_vars)
    unrolled, stacked = tmodel.state_dict(), from_scan.state_dict()
    assert unrolled.keys() == stacked.keys()
    assert all(torch.equal(unrolled[k], stacked[k]) for k in unrolled)
    np.testing.assert_array_equal(port_generate(from_scan, vision_x, ids, np.ones_like(ids)), want)
