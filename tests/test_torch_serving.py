"""The port's continuous-batching `ServingEngine` against the JAX package's
on the CPU: each request's tokens exactly JAX `flamingo_generate`'s greedy
tokens for it alone (the JAX engine's contract, tests/test_serving.py) and
the JAX `ServingEngine`'s on the same workload, whatever the admission
order. One test per case of tests/test_serving.py (all at once, staggered,
EOS retire and reuse, epoch reset, pipelined dispatch at depth 1 / 2 / 4,
pipelined staggered, a JAX `scan_layers=True` model, `int8_kv` on the fused
route, `absorb_vision` at chunks 2 and 3), and beyond them: GPT-NeoX (RoPE
positions from each row's pad_mask sum), per-row `min_new_tokens` through
`_process_logits`'s tensor step, `submit` refusing a request no epoch
holds, and the cache's in-place row surgery (`admit_rows`, `rollback`,
`reset_cache`) on hand-built caches.

Weights come from the JAX init through `convert/from_jax.py`, the xattn
gates at 0.5. The fused route is taken under the hooks of
tests/test_torch_fused_decode.py (`fused`): JAX `FORCE_FUSED` +
`INTERPRET`, the port's `FORCE_FUSED`. JAX references are computed once per
module; a JAX engine runs on the workloads the port's cases share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_layers import _scan_variables
from test_torch_quantize import hold_int8_caches

from open_flamingo_tpu import generation as jax_gen_mod
from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops import vit_attention as jax_va
from open_flamingo_tpu.serving import ServingEngine as JaxServingEngine
from open_flamingo_tpu_torch import generation as port_generation
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import kv_cache_from_jax, state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate, prefill
from open_flamingo_tpu_torch.models import absorb_vit as port_av
from open_flamingo_tpu_torch.models.decoders.common import KVCache, LayerKV, admit_rows, reset_cache, rollback
from open_flamingo_tpu_torch.models.flamingo import Flamingo
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.serving import ServingEngine

VOCAB, MEDIA, EOC = 64, 5, 6
IMG = 14
VIS = dict(image_size=IMG, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
FAMILIES = {
    "mpt": dict(family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                alibi=True, attention_bias=False, ln_no_bias=True),
    "gptneox": dict(family="gptneox", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, rotary_pct=0.25, tie_word_embeddings=False),
}
FLAMINGO = dict(media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1, num_vis_latents=4, perceiver_depth=1,
                perceiver_heads=2, perceiver_dim_head=8)
PROMPT_LENS = (6, 11, 16)     # ragged prompts from few shapes: each JAX prompt length compiles once
N_REQ, NEW = 8, 9


def requests(seed, n=N_REQ, img=IMG):
    """n requests, each one image and a prompt of a length in PROMPT_LENS,
    the image token first."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(10, 40, size=(int(rng.choice(PROMPT_LENS)),)).astype(np.int32)
        ids[0] = MEDIA
        out.append((rng.normal(size=(1, 1, img, img, 3)).astype(np.float32), ids))
    return out


def gates(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)


def load(cfg, params):
    model = Flamingo(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


def jax_refs(jmodel, params, reqs, max_new, eos, min_new=0):
    """JAX flamingo_generate's greedy tokens for each request: one call over
    all of them, each prompt left-padded to the longest (positions and
    attention are per row, so a row's tokens are those of its request
    alone: one compile instead of one per prompt length)."""
    cfg = JaxGenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=eos, min_new_tokens=min_new)
    width = max(len(ids) for _, ids in reqs)
    ids = np.zeros((len(reqs), width), np.int32)
    mask = np.zeros_like(ids)
    for i, (_, row) in enumerate(reqs):
        ids[i, width - len(row):] = row
        mask[i, width - len(row):] = 1
    vision_x = np.stack([vx for vx, _ in reqs])
    return list(np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, cfg)))


class Family:
    """A tiny family's JAX model and params, the port's model with the same
    weights, the module's requests and their JAX references (eos -1 and the
    eos of a token the model emits mid-stream), computed once."""

    def __init__(self, family, seed):
        jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**FAMILIES[family]), **FLAMINGO)
        self.jcfg, self.jmodel = jcfg, JaxFlamingo(cfg=jcfg)
        self.reqs = requests(seed)
        vx, ids = self.reqs[0]
        self.params = gates(jax.jit(self.jmodel.init)(jax.random.PRNGKey(seed), vx[None], ids[None],
                                                      np.ones((1, len(ids)), np.int32)))
        self.cfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**FAMILIES[family]), **FLAMINGO)
        self.tmodel = load(self.cfg, self.params)
        self.want = jax_refs(self.jmodel, self.params, self.reqs, NEW, -1)
        self.eos = int(self.want[0][2])            # a token emitted mid-stream: EOS fires
        self.want_eos = jax_refs(self.jmodel, self.params, self.reqs, NEW, self.eos)


@pytest.fixture(scope="module")
def mpt():
    return Family("mpt", 0)


@pytest.fixture(scope="module")
def neox():
    return Family("gptneox", 3)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(jax_va, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny models run faster on one intra-op thread, which then
    does not contend with XLA's CPU pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE = dict(batch_size=2, max_seq_len=96, max_prompt_len=16)


def gen_cfg(eos, min_new=0, int8_kv=False, jax_side=False):
    cls = JaxGenerationConfig if jax_side else GenerationConfig
    return cls(max_new_tokens=0, pad_token_id=0, eos_token_id=eos, min_new_tokens=min_new, int8_kv=int8_kv)


def serve(engine, reqs, max_new, stagger=False):
    """Submit `reqs` (all at once, or two then one after every step) and
    run; returns each request's tokens in submission order."""
    it = iter(reqs)
    rids = [engine.submit(vx, ids, max_new_tokens=max_new) for vx, ids in (reqs if not stagger else reqs[:2])]
    if not stagger:
        res = engine.run()
    else:
        for _ in range(2):
            next(it)
        alive = True
        while alive:
            alive = engine.step()
            nxt = next(it, None)
            if nxt is not None:
                rids.append(engine.submit(*nxt, max_new_tokens=max_new))
                alive = True
        res = engine._results
    assert sorted(res) == sorted(rids)
    return [np.asarray(res[r]) for r in rids]


def port_serve(fam_or_model, reqs, max_new, eos=-1, stagger=False, min_new=0, **kw):
    model = fam_or_model.tmodel if isinstance(fam_or_model, Family) else fam_or_model
    engine = ServingEngine(model, **{**ENGINE, **kw}, gen=gen_cfg(eos, min_new), device="cpu")
    return serve(engine, reqs, max_new, stagger), engine


def jax_serve(fam, reqs, max_new, eos=-1, stagger=False, model=None, params=None, **kw):
    engine = JaxServingEngine(model or fam.jmodel, params or fam.params, **{**ENGINE, **kw},
                              gen=gen_cfg(eos, jax_side=True))
    return serve(engine, reqs, max_new, stagger), engine


def check(got, want, eos):
    """The engine emits through EOS (no pad tail); generate pads to max_new
    (JAX tests/test_serving.py `_check`)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[:len(g)])
        assert (eos in g) or len(g) == len(w)


def same(got, theirs):
    assert len(got) == len(theirs)
    for g, t in zip(got, theirs):
        np.testing.assert_array_equal(g, t)


# ---------------------------------------------------------------- the JAX cases


def test_serving_matches_generate_all_at_once(mpt):
    reqs = mpt.reqs[:5]
    got, _ = port_serve(mpt, reqs, 7, chunk_tokens=4)
    check(got, [w[:7] for w in mpt.want], -1)
    same(got, jax_serve(mpt, reqs, 7, chunk_tokens=4)[0])


def test_serving_staggered_admissions(mpt):
    """Requests submitted while others decode: late rows are admitted at
    later global slots and stay exact."""
    reqs = mpt.reqs[:6]
    got, engine = port_serve(mpt, reqs, 6, chunk_tokens=3, stagger=True)
    check(got, [w[:6] for w in mpt.want], -1)
    same(got, jax_serve(mpt, reqs, 6, chunk_tokens=3, stagger=True)[0])


def test_serving_eos_retire_and_reuse(mpt):
    """A row retired by EOS is refilled; nothing of the last tenant's cache or
    media leaks into the next."""
    reqs = mpt.reqs[:4]
    got, _ = port_serve(mpt, reqs, 6, eos=mpt.eos, chunk_tokens=4)
    assert any(mpt.eos in g and len(g) < 6 for g in got)
    check(got, [w[:6] for w in mpt.want_eos], mpt.eos)


def test_serving_epoch_reset(mpt):
    """More work than one epoch's slots: max_new 9 with chunk 4 is a 12-slot
    horizon that does not divide the 32 decode slots, so admission stops
    early (the drain) and the epoch resets; tokens and epochs as JAX's."""
    kw = dict(max_seq_len=48, chunk_tokens=4)
    got, engine = port_serve(mpt, mpt.reqs, NEW, **kw)
    assert engine.epochs >= 1
    check(got, mpt.want, -1)
    theirs, jengine = jax_serve(mpt, mpt.reqs, NEW, **kw)
    same(got, theirs)
    assert engine.epochs == jengine.epochs


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_serving_pipelined_dispatch_exact(mpt, depth):
    """Chunks in flight before their tokens are read: exact across EOS
    retires, re-tenancy and epoch resets (the dispatch-time tenancy keeps a
    finished tenant's pads out of the next tenant's stream)."""
    kw = dict(max_seq_len=48, chunk_tokens=4, pipeline_depth=depth)
    got, engine = port_serve(mpt, mpt.reqs, NEW, eos=mpt.eos, **kw)
    check(got, mpt.want_eos, mpt.eos)
    if depth == 2:
        same(got, jax_serve(mpt, mpt.reqs, NEW, eos=mpt.eos, **kw)[0])


def test_serving_pipelined_staggered(mpt):
    reqs = mpt.reqs[:6]
    got, _ = port_serve(mpt, reqs, 6, chunk_tokens=3, pipeline_depth=2, stagger=True)
    check(got, [w[:6] for w in mpt.want], -1)


def test_serving_scan_layout(mpt):
    """A JAX scan_layers=True model (its stacked weights unstacked into the
    port's per-layer modules): the port's engine against the scanned JAX
    model's generate and engine."""
    scanned = JaxFlamingo(cfg=dataclasses.replace(mpt.jcfg, scan_layers=True))
    s_vars = _scan_variables(mpt.params, mpt.jmodel)
    reqs = mpt.reqs[:3]
    got, _ = port_serve(load(mpt.cfg, s_vars), reqs, 6, chunk_tokens=3)
    check(got, [w[:6] for w in mpt.want], -1)
    same(got, jax_serve(mpt, reqs, 6, chunk_tokens=3, model=scanned, params=s_vars)[0])


def test_serving_int8_kv_matches_generate_int8(mpt, fused, monkeypatch):
    """int8 K/V and media caches on the fused route (engaged: the engine's
    cache is int8): the port's engine equals the port's
    flamingo_generate(int8_kv=True) per request, and the JAX engine on its
    scan_layers=True model, whose int8 cache is the one JAX engages; where
    the packages part (rounding boundaries of the int8 caches, see
    tests/test_torch_quantize.py) the request's caches after prefill are
    held by `hold_int8_caches`."""
    reqs = mpt.reqs[:3]
    engine = ServingEngine(mpt.tmodel, **ENGINE, chunk_tokens=3, gen=gen_cfg(-1, int8_kv=True), device="cpu")
    got = serve(engine, reqs, 6)
    assert engine._int8_kv and engine._cache.layers[0].k.dtype == torch.int8
    assert engine._cache.media[0].k.dtype == torch.int8
    gcfg = GenerationConfig(max_new_tokens=6, pad_token_id=0, eos_token_id=-1, int8_kv=True)
    for g, (vx, ids) in zip(got, reqs):
        want = flamingo_generate(mpt.tmodel, torch.from_numpy(vx[None]), torch.from_numpy(ids[None]).long(),
                                 torch.ones(1, len(ids), dtype=torch.long), gcfg, device="cpu")[0].numpy()
        np.testing.assert_array_equal(g, want)
    scanned = JaxFlamingo(cfg=dataclasses.replace(mpt.jcfg, scan_layers=True))
    s_vars = _scan_variables(mpt.params, mpt.jmodel)
    jengine = JaxServingEngine(scanned, s_vars, **ENGINE, chunk_tokens=3, gen=gen_cfg(-1, int8_kv=True, jax_side=True))
    theirs = serve(jengine, reqs, 6)
    assert jengine._int8_kv
    for g, t, (vx, ids) in zip(got, theirs, reqs):
        if np.array_equal(g, t):
            continue
        # parted at a rounding boundary: the prefill caches one step apart
        jcache = jax_prefill_cache(scanned, s_vars, vx, ids)
        _, pcache = prefill(mpt.tmodel, mpt.tmodel.embed_vision(torch.from_numpy(vx[None])),
                            torch.from_numpy(ids[None]).long(), torch.ones(1, len(ids), dtype=torch.long),
                            jcache.max_length, True)
        hold_int8_caches(pcache, jcache)


def jax_prefill_cache(jmodel, variables, vx, ids):
    """JAX's int8 prefill cache of one request as JAX generate builds it, read
    into the port's layout."""
    from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
    from open_flamingo_tpu.models.decoders.common import LayerKV as JaxLayerKV
    from open_flamingo_tpu.models.decoders.common import kv_scale_layout, quantize_kv
    from open_flamingo_tpu.models.lm import extract_media_kv

    cfg = jmodel.cfg
    s = -(-(len(ids) + 6) // 16) * 16
    groups = cfg.lm.num_layers // cfg.cross_attn_every_n
    lat = jmodel.apply(variables, vx[None], method=JaxFlamingo.embed_vision)
    (_, _, cache), mv = jmodel.apply(variables, None, ids[None], np.ones((1, len(ids)), np.int32), media_latents=lat,
                                     cache=JaxKVCache.create(cfg.lm, 1, s, scan_groups=groups, int8=True),
                                     mutable=["media_kv"])
    media = tuple(JaxLayerKV(k=kq, v=vq, k_s=kv_scale_layout(ks), v_s=kv_scale_layout(vs))
                  for (kq, ks), (vq, vs) in ((quantize_kv(m.k), quantize_kv(m.v))
                                             for m in extract_media_kv(mv, cfg.scan_layers)))
    return kv_cache_from_jax(jax.tree.map(np.asarray, cache.replace(media=media)))


# the geometry of tests/test_serving.py's absorb case: 8 slots a ViT layer,
# macro 4 of the 4 groups, 4 ViT layers at one a step: a 4-step cycle
ABSORB_VIS = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64)
ABSORB_LM = dict(family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
                 alibi=True, attention_bias=False, ln_no_bias=True)


@pytest.fixture(scope="module")
def absorb_family():
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**ABSORB_VIS), lm=JaxDecoderConfig(**ABSORB_LM), **FLAMINGO,
                             scan_layers=True)
    unrolled = JaxFlamingo(cfg=dataclasses.replace(jcfg, scan_layers=False))
    reqs = requests(5, n=6, img=16)
    vx, ids = reqs[0]
    params = gates(jax.jit(unrolled.init)(jax.random.PRNGKey(0), vx[None], ids[None],
                                          np.ones((1, len(ids)), np.int32)))
    s_vars = _scan_variables(params, unrolled)
    tcfg = FlamingoConfig(vision=VisionConfig(**ABSORB_VIS), lm=DecoderConfig(**ABSORB_LM), **FLAMINGO)
    return reqs, load(tcfg, s_vars), jax_refs(unrolled, params, reqs, 4, -1)


@pytest.mark.parametrize("chunk", [2, 3])
def test_serving_absorb_vision_exact(absorb_family, fused, monkeypatch, chunk):
    """absorb_vision: the queued requests' ViT rides the decode chunks as
    side tiles (cycles across chunk boundaries; chunk 3 ends a cycle inside
    a chunk) and admissions take the pooled latents: tokens exactly JAX
    generate's per request and the plain engine's, every side slot taken,
    the plan engaged (4 steps) and the pool serving admissions."""
    reqs, tmodel, want = absorb_family
    taken = []
    take = port_av.VitSideFeed.take
    monkeypatch.setattr(port_av.VitSideFeed, "take", lambda self, so: taken.append(1) or take(self, so))
    kw = dict(chunk_tokens=chunk, absorb_vision=True, absorb_batch=2)
    engine = ServingEngine(tmodel, **ENGINE, **kw, gen=gen_cfg(-1), device="cpu")
    assert engine._absorb_on
    got = serve(engine, reqs, 4)
    check(got, want, -1)
    plan = engine._abs_plan
    assert plan is not None and plan.n_steps == 4
    assert engine.absorb_hits > 0
    assert len(taken) % (plan.slots_per_layer * plan.n_vit_layers) == 0 and taken
    plain, _ = port_serve(tmodel, reqs, 4, chunk_tokens=chunk)
    same(got, plain)


# ---------------------------------------------------------------- beyond the JAX cases


@pytest.mark.parametrize("route", ["einsum", "fused"])
def test_serving_gptneox_rope_positions(neox, monkeypatch, route):
    """GPT-NeoX: RoPE positions come from each row's pad_mask sum, so a
    tenant admitted at a later global slot (staggered, through an epoch
    reset) must still rotate from its own position 0; on both decode routes
    (the fused one runs K1 + K6 + K2's plain versions)."""
    if route == "fused":
        monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    got, engine = port_serve(neox, neox.reqs, NEW, max_seq_len=48, chunk_tokens=4, stagger=True)
    assert engine.epochs >= 1
    check(got, neox.want, -1)


def test_process_logits_per_row_step(rng, mpt):
    """`_process_logits` with a (B, 1) step tensor forbids EOS row by row, bit
    for bit JAX's with a vector step; the int step is unchanged; the engine's
    tenants honour min_new_tokens each from their own step."""
    logits = rng.normal(size=(5, VOCAB)).astype(np.float32)
    step = np.array([[0], [2], [3], [5], [1]], np.int32)
    cfg = GenerationConfig(max_new_tokens=8, min_new_tokens=3, eos_token_id=EOC)
    jcfg = JaxGenerationConfig(max_new_tokens=8, min_new_tokens=3, eos_token_id=EOC)
    got = port_generation._process_logits(torch.from_numpy(logits), torch.from_numpy(step).long(), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_gen_mod._process_logits(logits, step, jcfg)))
    for s in (0, 3):
        np.testing.assert_array_equal(port_generation._process_logits(torch.from_numpy(logits), s, cfg).numpy(),
                                      np.asarray(jax_gen_mod._process_logits(logits, np.int32(s), jcfg)))
    # eos a token emitted at step 1: min_new 3 forbids it there; against the
    # port's flamingo_generate (held to JAX's with min_new_tokens in
    # tests/test_torch_generate.py)
    eos = int(mpt.want[1][1])
    gcfg = GenerationConfig(max_new_tokens=6, pad_token_id=0, eos_token_id=eos, min_new_tokens=3)
    want = [flamingo_generate(mpt.tmodel, torch.from_numpy(vx[None]), torch.from_numpy(ids[None]).long(),
                              torch.ones(1, len(ids), dtype=torch.long), gcfg, device="cpu")[0].numpy()
            for vx, ids in mpt.reqs[:4]]
    assert any(w[1] != eos for w in want)
    got, _ = port_serve(mpt, mpt.reqs[:4], 6, eos=eos, min_new=3, chunk_tokens=4, stagger=True)
    check(got, want, eos)


def test_submit_refuses_what_no_epoch_holds(mpt):
    engine = ServingEngine(mpt.tmodel, batch_size=2, max_seq_len=48, max_prompt_len=16, chunk_tokens=4,
                           gen=gen_cfg(-1), device="cpu")
    vx, ids = mpt.reqs[0]
    with pytest.raises(ValueError, match="cannot fit an epoch"):
        engine.submit(vx, ids, max_new_tokens=33)       # 16 + 36 > 48
    engine.submit(vx, ids, max_new_tokens=32)           # 16 + 32 = 48 fits
    with pytest.raises(ValueError, match="max_prompt_len"):
        engine.submit(vx, np.ones(17, np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="t_img"):
        engine.submit(np.concatenate([vx, vx]), ids, max_new_tokens=4)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(mpt.tmodel, **ENGINE, gen=GenerationConfig(max_new_tokens=0, num_beams=2), device="cpu")


def hand_cache(gen, b, s, int8, media=True):
    """A KVCache of 2 layers (B, 2 heads, S, Dh 4) and 2 media layers (S_m 3)
    filled with distinct random values; pad_mask random."""
    def layer(slots):
        shape = (b, 2, slots, 4)
        if int8:
            return LayerKV(torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8),
                           torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8),
                           torch.rand(shape[:3], generator=gen), torch.rand(shape[:3], generator=gen))
        return LayerKV(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))

    return KVCache(layers=(layer(s), layer(s)), index=0, slot=torch.zeros(1, dtype=torch.int32),
                   pad_mask=torch.rand(b, s, generator=gen) > 0.5, media=(layer(3), layer(3)) if media else None)


def fields(cache):
    return [x for layer in cache.layers + (cache.media or ()) for x in (layer.k, layer.v, layer.k_s, layer.v_s)
            if x is not None]


@pytest.mark.parametrize("int8", [False, True])
def test_row_surgery_in_place(int8):
    """admit_rows writes pre's rows right-aligned before `index` into the
    chosen rows (K/V, int8 scales, media, the pad_mask window, zeros
    elsewhere in the row) and leaves every other row and slot; rollback sets
    index and the device slot together and clears the rejected window;
    reset_cache zeroes in place. Every tensor keeps its address."""
    gen = torch.Generator().manual_seed(0)
    big, pre = hand_cache(gen, 4, 16, int8), hand_cache(gen, 3, 6, int8)
    big.index = 10
    big.slot.fill_(10)
    before = [x.clone() for x in fields(big)]
    mask_before = big.pad_mask.clone()
    ptrs = [x.data_ptr() for x in fields(big)]
    rows, src = torch.tensor([3, 0]), torch.tensor([2, 0])
    admit_rows(big, pre, rows, src)
    assert [x.data_ptr() for x in fields(big)] == ptrs
    for got, was, p in zip(fields(big), before, fields(pre)):
        media = got.shape[2] == 3 and p.shape[2] == 3
        for r in range(4):
            if r not in (3, 0):
                assert torch.equal(got[r], was[r])
                continue
            s = {3: 2, 0: 0}[r]
            if media:
                assert torch.equal(got[r], p[s])
            else:
                assert torch.equal(got[r, :, 4:10], p[s])
                assert torch.equal(got[r, :, :4], was[r, :, :4]) and torch.equal(got[r, :, 10:], was[r, :, 10:])
    for r, s in ((3, 2), (0, 0)):
        assert not big.pad_mask[r, :4].any() and not big.pad_mask[r, 10:].any()
        assert torch.equal(big.pad_mask[r, 4:10], pre.pad_mask[s])
    assert torch.equal(big.pad_mask[1:3], mask_before[1:3])
    with pytest.raises(ValueError, match="does not fit"):
        admit_rows(dataclasses.replace(big, index=5), pre, rows, src)

    big.pad_mask[:] = True
    rollback(big, start=8, keep=3, window=5)
    assert big.index == 11 and int(big.slot) == 11
    assert big.pad_mask[:, :11].all() and not big.pad_mask[:, 11:13].any() and big.pad_mask[:, 13:].all()

    reset_cache(big, 16)
    assert big.index == 16 and int(big.slot) == 16 and not big.pad_mask.any()
    assert [x.data_ptr() for x in fields(big)] == ptrs
    for layer in big.layers + big.media:
        assert not layer.k.any() and not layer.v.any()
        if int8:
            assert (layer.k_s == 1).all() and (layer.v_s == 1).all()


def test_engine_keeps_its_addresses_and_slot(mpt, monkeypatch):
    """On the fused route (K3 writes at the device `slot`): after every chunk
    the cache's slot equals its index, and the cache, media, latents and
    logits keep the addresses of the first admission through re-tenancy and
    an epoch reset."""
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    engine = ServingEngine(mpt.tmodel, **{**ENGINE, "max_seq_len": 48}, chunk_tokens=4, gen=gen_cfg(-1),
                           device="cpu")
    for vx, ids in mpt.reqs:
        engine.submit(vx, ids, max_new_tokens=NEW)
    ptrs = None
    while engine.step():
        if engine._cache is None or engine._cache.media is None:
            continue
        assert int(engine._cache.slot) == engine._cache.index
        now = [x.data_ptr() for x in fields(engine._cache) + [engine._latents, engine._logits]]
        ptrs = ptrs or now
        assert now == ptrs
    assert engine.epochs >= 1
