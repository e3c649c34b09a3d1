"""The port's cross-batch absorbed ViT (`models/absorb_vit.py`, K8
`flat_vit_attention`, K2b side tiles of `fused_mlp`) against the JAX
package's on the CPU.

  * `make_plan` field by field against JAX's (a `scan_layers=True` model,
    the layout JAX plans for) on the geometries of tests/test_absorb_vit.py
    and more: split 1 and 2, pad slots, n = 4, too few steps, beams, the
    flat attention's column rule, OF-3B;
  * `reference_flat_vit_attention` against JAX `flat_vit_attention` in
    Pallas interpret mode, fp32, with pad keys, on the paired-head and the
    whole-width column blocks (1e-5: both fp32, sums in another order);
  * `fused_mlp` with side operands (its plain version on CPU tensors)
    against JAX `fused_mlp` with side operands in interpret mode, each slot
    kind and main weights fp32 and int8 (2e-5, K2's tolerance in
    tests/test_torch_dense_stream.py), the main output equal to the call
    without a side tile;
  * absorbed `flamingo_generate(next_pixels=)`: tokens exactly equal to the
    port's own call without next_pixels and to JAX's absorbed call,
    next_latents within 1e-4 of JAX's and of the port's `embed_vision` (the
    JAX test's tolerance), and every slot of the schedule taken; the
    serial fallback; GPT-NeoX, llama and OPT blocks carrying tiles;
  * `ATTN_CARRIERS` (K3 launches carrying tiles, K2b-attn): `make_plan`
    field by field against JAX's with the knob on both sides, and absorbed
    generate against JAX's with it, with the int8 ViT side-car (the W8A8
    side tiles, JAX `SIDE_INT8`) and with both: tokens equal to JAX's and
    to the call without next_pixels, K3 carrying half the tiles, next
    latents within 1e-4 of JAX's.

Hooks: JAX `dense_stream.FORCE_FUSED` + `INTERPRET` and
`vit_attention.INTERPRET`; the port's `FORCE_FUSED` (its wrappers run
their plain versions on CPU tensors).
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
from open_flamingo_tpu import quantize as jq
from open_flamingo_tpu.models import absorb_vit as jax_av
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops import vit_attention as jax_va
from open_flamingo_tpu_torch import configs
from open_flamingo_tpu_torch.convert.from_jax import decode_weights_from_jax, state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models import absorb_vit as port_av
from open_flamingo_tpu_torch.models import xattn as port_xattn
from open_flamingo_tpu_torch.models.flamingo import Flamingo, init_random
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops.vit_attention import flat_vit_attention, reference_flat_vit_attention
from open_flamingo_tpu_torch.models.decoders import mpt as port_mpt
from open_flamingo_tpu_torch.quantize import attach_decode_weights, quantize_weight

VOCAB, MEDIA, EOC = 128, 3, 4
LATENT_ATOL = 1e-4
# the geometry of tests/test_absorb_vit.py: ViT D 32 / I 64 -> n_fc1 2,
# 8 slots per layer; n 1 -> 2 carriers per group -> macro 4; 2 ViT layers
VIS = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
LM = dict(family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
          alibi=True, attention_bias=False, ln_no_bias=True)
FLAMINGO = dict(media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1, num_vis_latents=4, perceiver_depth=1,
                perceiver_heads=2, perceiver_dim_head=8)
PLAN_FIELDS = ("b", "t", "f", "s_real", "s_pad", "m_f", "d", "heads", "n_fc1", "n_fc2", "act", "eps", "macro",
               "per_step", "n_steps", "n_vit_layers", "split", "slots_per_layer", "side_groups", "bv", "attn_carriers")


def jax_cfg(vis=None, lm=None, **kw):
    """The tiny geometry with overrides, as a JAX scan_layers model's config."""
    return JaxFlamingoConfig(vision=JaxVisionConfig(**{**VIS, **(vis or {})}),
                             lm=JaxDecoderConfig(**{**LM, **(lm or {})}), **{**FLAMINGO, **kw, "scan_layers": True})


def convert_cfg(cfg, flamingo_cls, vision_cls, decoder_cls):
    """`cfg` (either package's FlamingoConfig) as the other package's: the
    fields the target classes have."""
    def same(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})

    rest = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(flamingo_cls)
            if f.name not in ("vision", "lm") and hasattr(cfg, f.name)}
    return flamingo_cls(vision=same(vision_cls, cfg.vision), lm=same(decoder_cls, cfg.lm), **rest)


def port_cfg(jcfg):
    return convert_cfg(jcfg, configs.FlamingoConfig, configs.VisionConfig, configs.DecoderConfig)


# ---------------------------------------------------------------- the plan

SPLIT2 = dict(vis=dict(hidden_size=256, intermediate_size=256), lm=dict(num_layers=6, hidden_size=64, num_heads=1))
GEOMETRIES = {
    "base": ({}, (2, 1, 1), 4, 1),
    "too_few_steps": ({}, (2, 1, 1), 1, 1),
    "beams": ({}, (2, 1, 1), 4, 3),
    "steps_eq_new": ({}, (2, 1, 1), 2, 1),
    "lm8_plain_tail": (dict(lm=dict(num_layers=8)), (3, 1, 1), 4, 1),
    "pad_slots_n2": (dict(lm=dict(num_layers=6), cross_attn_every_n=2), (2, 1, 1), 4, 1),
    "n4_too_few_groups": (dict(vis=dict(intermediate_size=128), cross_attn_every_n=4), (2, 1, 1), 32, 1),
    "n4_pad_slots": (dict(vis=dict(intermediate_size=128), lm=dict(num_layers=20), cross_attn_every_n=4),
                     (2, 1, 1), 32, 1),
    "multi_image": ({}, (2, 2, 1), 4, 1),
    "split2": (SPLIT2, (2, 1, 1), 4, 1),
    "column_rule": (dict(vis=dict(hidden_size=192, num_heads=3, intermediate_size=384)), (2, 1, 1), 4, 1),
    "ragged_mlp": (dict(vis=dict(intermediate_size=48)), (2, 1, 1), 4, 1),
    "ragged_lm": (dict(lm=dict(num_layers=5), cross_attn_every_n=2), (2, 1, 1), 4, 1),
}


def geometry_cfg(name):
    over, shape, max_new, beams = GEOMETRIES[name]
    return jax_cfg(**over), shape, max_new, beams


@pytest.mark.parametrize("name", list(GEOMETRIES) + ["split2_preferred", "of3b"])
def test_make_plan_matches_jax(name, monkeypatch):
    if name == "of3b":     # the released geometry: 12 slots on 6 groups of OF-3B's 24, 24 absorbing steps
        pcfg = configs.flamingo_config("OF-3B")
        jcfg = dataclasses.replace(convert_cfg(pcfg, JaxFlamingoConfig, JaxVisionConfig, JaxDecoderConfig),
                                   scan_layers=True)
        shape, max_new, beams = (8, 1, 1), 32, 1
    else:
        jcfg, shape, max_new, beams = geometry_cfg("split2" if name == "split2_preferred" else name)
        pcfg = port_cfg(jcfg)
    if name == "split2_preferred":
        monkeypatch.setattr(jax_av, "PREFER_SPLIT", (2,))
        monkeypatch.setattr(port_av, "PREFER_SPLIT", (2,))
    want = jax_av.make_plan(jcfg, shape, max_new, num_beams=beams)
    got = port_av.make_plan(pcfg, shape, max_new, num_beams=beams)
    expect = {"base": 1, "too_few_steps": 0, "beams": 0, "steps_eq_new": 1, "lm8_plain_tail": 1, "pad_slots_n2": 1,
              "n4_too_few_groups": 0, "n4_pad_slots": 1, "multi_image": 1, "split2": 1, "column_rule": 0,
              "ragged_mlp": 0, "ragged_lm": 0, "split2_preferred": 1, "of3b": 1}[name]
    assert (want is not None) == bool(expect), "the geometry no longer exercises what its name says"
    if want is None:
        assert got is None
        return
    assert got is not None
    for field in PLAN_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.m_pad % port_av.SIDE_ROWS == 0 and got.m_f <= got.m_pad < got.m_f + port_av.SIDE_ROWS
    if name == "split2_preferred":
        assert got.split == 2 and got.slots_per_layer == 12 and got.macro == 6
    if name in ("pad_slots_n2", "n4_pad_slots"):
        assert got.macro * (jcfg.cross_attn_every_n + 1) > got.slots_per_layer
    if name == "of3b":
        assert (got.macro, got.per_step, got.n_steps, got.slots_per_layer, got.m_f) == (6, 1, 24, 12, 2112)


@pytest.mark.parametrize("name", ["base", "lm8_plain_tail", "pad_slots_n2", "n4_pad_slots", "multi_image", "split2",
                                  "gptneox", "of3b"])
def test_make_plan_attn_carriers_matches_jax(name, monkeypatch):
    """With ATTN_CARRIERS in both packages: K3 launches join the carriers
    (the gated block's in every family, MPT's self-attention), field by
    field. OF-3B: 4 carriers a group (xattn K3, xattn K2, MPT K3, MPT K2),
    macro 3."""
    monkeypatch.setattr(jax_av, "ATTN_CARRIERS", True)
    monkeypatch.setattr(port_av, "ATTN_CARRIERS", True)
    if name == "of3b":
        pcfg = configs.flamingo_config("OF-3B")
        jcfg = dataclasses.replace(convert_cfg(pcfg, JaxFlamingoConfig, JaxVisionConfig, JaxDecoderConfig),
                                   scan_layers=True)
        shape, max_new = (64, 1, 1), 32
    elif name == "gptneox":
        jcfg, shape, max_new = jax_cfg(lm=dict(family="gptneox", alibi=False, num_layers=6),
                                       cross_attn_every_n=2), (2, 1, 1), 4
        pcfg = port_cfg(jcfg)
    else:
        jcfg, shape, max_new, _ = geometry_cfg(name)
        pcfg = port_cfg(jcfg)
    want = jax_av.make_plan(jcfg, shape, max_new)
    got = port_av.make_plan(pcfg, shape, max_new)
    assert want is not None and got is not None and got.attn_carriers
    for field in PLAN_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    if name == "of3b":
        assert (got.n_steps, got.slots_per_layer, got.macro, got.m_f) == (24, 12, 3, 16896)
    if name == "gptneox":     # the gated block's K3 alone joins: n + 2 carriers a group
        assert got.macro == -(-got.slots_per_layer // 4)


def test_unported_knobs_raise(monkeypatch):
    """Both knobs are ported: ATTN_CARRIERS plans attention carriers and
    SIDE_INT8 is on by default, as in JAX. What raises now is a malformed
    W8A8 tile: an int8 side_w without its scale, a scale beside a float
    side_w or of the wrong shape."""
    pcfg = port_cfg(jax_cfg())
    assert port_av.SIDE_INT8 and jax_av.SIDE_INT8 and not port_av.ATTN_CARRIERS
    monkeypatch.setattr(port_av, "ATTN_CARRIERS", True)
    plan = port_av.make_plan(pcfg, (2, 1, 1), 4)
    assert plan.attn_carriers and plan.macro == 2      # 8 slots on 4 carriers a group (MPT n 1)
    x, w, w8 = torch.zeros(2, 16), torch.zeros(24, 16), torch.zeros(24, 16, dtype=torch.int8)
    sx = torch.zeros(8, 16)
    for kw, match in ((dict(side_w=w8), "side_w_scale goes with an int8 side_w"),
                      (dict(side_w=w, side_w_scale=torch.ones(24)), "side_w_scale goes with an int8 side_w"),
                      (dict(side_w=w8, side_w_scale=torch.ones(23)), r"side_w_scale must be \(24,\)")):
        with pytest.raises(ValueError, match=match):
            port_ds.fused_mlp(x, w, w.t(), side_x=sx, **kw)


# ---------------------------------------------------------------- K8


@pytest.mark.parametrize("case", ["hpb_pair", "w_eq_d"])
def test_flat_attention_matches_jax(rng, case):
    """Paired heads (Dh 64: two heads per 128-wide column block) and the
    whole width (D 32 <= 128: one block of every head); s_real < S_pad."""
    b, s_pad, s_real, d, heads = (2, 24, 17, 256, 4) if case == "hpb_pair" else (3, 8, 5, 32, 2)
    q, k, v = (rng.normal(size=(b, s_pad, d)).astype(np.float32) for _ in range(3))
    scale = (d // heads) ** -0.5
    want = jax_va.flat_vit_attention(q, k, v, scale, heads=heads, s_real=s_real, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = reference_flat_vit_attention(tq, tk, tv, scale, heads=heads, s_real=s_real)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(flat_vit_attention(tq, tk, tv, scale, heads=heads, s_real=s_real), got)   # CPU: plain
    assert np.isfinite(got[:, s_real:].numpy()).all()     # pad query rows: finite, over the real keys


# ---------------------------------------------------------------- K2b

SLOTS = {
    "ln_bias": dict(ln=True, bias=True),                       # q/k/v, fc1
    "residual": dict(bias=True, residual=True),                # out-projection
    "act_bias": dict(act="quick_gelu", bias=True, residual=True),   # fc2, slice 0
    "act": dict(act="quick_gelu", residual=True),              # fc2, later slices
}


@pytest.mark.parametrize("main", ["fp32", "int8"])
@pytest.mark.parametrize("slot", list(SLOTS))
def test_side_tile_matches_jax(rng, slot, main):
    b, k, k2, n, m, sk, sn = 4, 64, 128, 64, 40, 64, 32
    kind = SLOTS[slot]

    def rn(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x, w1, w2 = rn(b, k), rn(k, k2, scale=k**-0.5), rn(k2, n, scale=k2**-0.5)   # JAX layout (in, out)
    ln_s, ln_b, res = 1 + rn(k, scale=0.1), rn(k, scale=0.1), rn(b, n)
    side_x, side_w = rn(m, sk, scale=2.0), rn(sk, sn, scale=sk**-0.5)
    # the port's (SN, SK) side_w: a column block of a wider weight, as fc2's slices
    s_ln = (1 + rn(sk, scale=0.1), rn(sk, scale=0.1)) if kind.get("ln") else None
    s_b = rn(sn, scale=0.1) if kind.get("bias") else None
    s_res = rn(m, sn) if kind.get("residual") else None
    main_kw = dict(ln_scale=ln_s, ln_bias=ln_b, residual=res)
    jw1, jw2, pw1, pw2 = w1, w2, torch.from_numpy(w1.T.copy()), torch.from_numpy(w2.T.copy())
    if main == "int8":
        q1, s1 = quantize_weight(pw1)
        q2, s2 = quantize_weight(pw2)
        pw1, pw2 = q1, q2
        jw1, jw2 = np.asarray(q1).T.copy(), np.asarray(q2).T.copy()
        main_kw_j = dict(main_kw, w1_scale=s1.numpy(), w2_scale=s2.numpy())
        main_kw_p = dict(main_kw, w1_scale=s1, w2_scale=s2)
    else:
        main_kw_j = main_kw_p = main_kw
    side = dict(side_ln=s_ln, side_act=kind.get("act"), side_b=s_b, side_residual=s_res, side_eps=1e-5)
    want_y, want_so = jax_ds.fused_mlp(x, jnp.asarray(jw1), jnp.asarray(jw2), side_x=side_x, side_w=side_w,
                                       interpret=True, **main_kw_j, **side)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    wide = torch.from_numpy(np.concatenate([rn(sn, sk), side_w.T], axis=1))
    p_side = dict(side_x=t(side_x), side_w=wide[:, sk:],
                  side_ln=None if s_ln is None else (t(s_ln[0]), t(s_ln[1])), side_act=kind.get("act"),
                  side_b=t(s_b), side_residual=t(s_res), side_eps=1e-5)
    p_main = {kk: t(vv) if isinstance(vv, np.ndarray) else vv for kk, vv in main_kw_p.items()}
    got_y, got_so = port_ds.fused_mlp(t(x), pw1, pw2, **p_main, **p_side)
    np.testing.assert_allclose(got_so.numpy(), np.asarray(want_so), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-5, rtol=0)
    assert torch.equal(got_y, port_ds.fused_mlp(t(x), pw1, pw2, **p_main))   # the side tile leaves y as it was


def test_side_operands_checked():
    x, w = torch.zeros(2, 16), torch.zeros(24, 16)
    with pytest.raises(ValueError, match="side operands need side_x"):
        port_ds.fused_mlp(x, w, w.t(), side_w=w)
    with pytest.raises(ValueError, match="side_residual"):
        port_ds.fused_mlp(x, w, w.t(), side_x=torch.zeros(8, 16), side_w=w, side_residual=torch.zeros(8, 23))
    with pytest.raises(ValueError, match="side_w_scale"):
        port_ds.fused_mlp(x, w, w.t(), side_x=torch.zeros(8, 16), side_w=w, side_w_scale=torch.ones(24))


# ---------------------------------------------------------------- the slice


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(jax_va, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)


@pytest.fixture
def slots(monkeypatch):
    """Counts the side tiles the port's schedule takes."""
    taken = []
    take = port_av.VitSideFeed.take
    monkeypatch.setattr(port_av.VitSideFeed, "take", lambda self, so: taken.append(1) or take(self, so))
    return taken


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return module


# (geometry overrides, next pixels (b, t, f), max_new_tokens)
GENERATE = {
    "mpt_n1_lm4": ({}, (3, 1, 1), 4),
    "mpt_n1_lm8_plain_tail": (dict(lm=dict(num_layers=8)), (3, 1, 1), 4),
    "split2": (SPLIT2, (2, 1, 1), 4),
    "pad_slots": (dict(lm=dict(num_layers=6), cross_attn_every_n=2), (2, 1, 1), 4),
    "multi_image_next": ({}, (2, 2, 1), 4),
    "steps_eq_new": ({}, (2, 1, 1), 2),
    "serial_fallback": ({}, (2, 1, 1), 1),
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_absorbed_generate_matches_jax(case, fused, slots, monkeypatch):
    over, next_shape, max_new = GENERATE[case]
    if case == "split2":
        monkeypatch.setattr(jax_av, "PREFER_SPLIT", (2,))
        monkeypatch.setattr(port_av, "PREFER_SPLIT", (2,))
    rng = np.random.default_rng(7)
    jcfg = jax_cfg(**over)
    unrolled = JaxFlamingo(cfg=dataclasses.replace(jcfg, scan_layers=False))
    vision_x = rng.normal(size=(2, 1, 1, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(7, VOCAB, size=(2, 6)).astype(np.int32)
    ids[:, 0] = MEDIA
    mask = np.ones_like(ids)
    params = unrolled.init(jax.random.PRNGKey(0), vision_x, ids, mask)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)
    s_vars = _scan_variables(params, unrolled)
    next_pixels = rng.normal(size=(*next_shape, 16, 16, 3)).astype(np.float32)
    plan = jax_av.make_plan(jcfg, next_shape, max_new)
    assert (plan is None) == (case == "serial_fallback")

    jgen = JaxGenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=-1)
    want_tok, want_lat = jax_generate(JaxFlamingo(cfg=jcfg), s_vars, vision_x, ids, mask, jgen,
                                      next_pixels=next_pixels)
    tmodel = load(Flamingo(port_cfg(jcfg), device="cpu"), s_vars)
    gen = GenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=-1)
    args = (torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask), gen)
    plain = flamingo_generate(tmodel, *args, device="cpu")
    got_tok, got_lat = flamingo_generate(tmodel, *args, next_pixels=torch.from_numpy(next_pixels), device="cpu")
    assert len(slots) == (0 if plan is None else plan.slots_per_layer * plan.n_vit_layers)
    np.testing.assert_array_equal(got_tok.numpy(), plain.numpy())
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    with torch.no_grad():
        serial = tmodel.embed_vision(torch.from_numpy(next_pixels))
    assert got_lat.shape == serial.shape == (*next_shape[:2], FLAMINGO["num_vis_latents"], jcfg.vision.hidden_size)
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(got_lat.numpy(), serial.numpy(), atol=LATENT_ATOL, rtol=0)


FORMS = {
    "attn_carriers": dict(attn=True, int8=False),
    "int8_side_car": dict(attn=False, int8=True),
    "attn_carriers_int8": dict(attn=True, int8=True),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_absorbed_generate_forms_match_jax(form, fused, slots, monkeypatch):
    """Absorbed generate with K3 carrying tiles (ATTN_CARRIERS) and with the
    int8 ViT side-car (the W8A8 side tiles, LM decode int8), against JAX's
    absorbed call: tokens equal to JAX's and to the port's call without
    next_pixels, every slot taken, K3 and K2 carrying the plan's share, the
    next latents within 1e-4 of JAX's; without the side-car within 1e-4 of
    embed_vision, with it away from it (the W8A8 tiles engaged)."""
    kind = FORMS[form]
    monkeypatch.setattr(jax_av, "ATTN_CARRIERS", kind["attn"])
    monkeypatch.setattr(port_av, "ATTN_CARRIERS", kind["attn"])
    over, next_shape, max_new = GENERATE["mpt_n1_lm4"]
    rng = np.random.default_rng(11)
    jcfg = jax_cfg(**over)
    unrolled = JaxFlamingo(cfg=dataclasses.replace(jcfg, scan_layers=False))
    vision_x = rng.normal(size=(2, 1, 1, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(7, VOCAB, size=(2, 6)).astype(np.int32)
    ids[:, 0] = MEDIA
    mask = np.ones_like(ids)
    params = unrolled.init(jax.random.PRNGKey(1), vision_x, ids, mask)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)
    s_vars = _scan_variables(params, unrolled)
    if kind["int8"]:
        s_vars = jq.quantize_prefill_params(s_vars)
    next_pixels = rng.normal(size=(*next_shape, 16, 16, 3)).astype(np.float32)
    plan = jax_av.make_plan(jcfg, next_shape, max_new)
    assert plan.attn_carriers == kind["attn"]
    jgen = JaxGenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=-1)
    want_tok, want_lat = jax_generate(JaxFlamingo(cfg=jcfg), s_vars, vision_x, ids, mask, jgen,
                                      next_pixels=next_pixels)
    tmodel = load(Flamingo(port_cfg(jcfg), device="cpu"), s_vars)
    if kind["int8"]:
        attach_decode_weights(tmodel, decode_weights_from_jax(jax.tree.map(np.asarray, s_vars)))
    gen = GenerationConfig(max_new_tokens=max_new, pad_token_id=0, eos_token_id=-1)
    args = (torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask), gen)
    plain = flamingo_generate(tmodel, *args, device="cpu")
    calls = []
    for module in (port_mpt, port_xattn):
        for name in ("reference_attn_block", "reference_mlp"):
            real = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, real=real, name=name, **kw: calls.append(
                (name, kw.get("side_w") is not None, kw.get("side_w_scale") is not None)) or real(*a, **kw))
    got_tok, got_lat = flamingo_generate(tmodel, *args, next_pixels=torch.from_numpy(next_pixels), device="cpu")
    tiles = plan.slots_per_layer * plan.n_vit_layers
    assert len(slots) == tiles
    carried = [c for c in calls if c[1]]
    assert all(c[2] == kind["int8"] for c in carried)              # the W8A8 tile exactly with the side-car
    k3 = sum(c[0] == "reference_attn_block" for c in carried)
    assert (k3, len(carried)) == ((tiles // 2 if kind["attn"] else 0), tiles)
    np.testing.assert_array_equal(got_tok.numpy(), plain.numpy())
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=LATENT_ATOL, rtol=0)
    with torch.no_grad():
        serial = tmodel.embed_vision(torch.from_numpy(next_pixels))
    err = np.abs(got_lat.numpy() - serial.numpy()).max()
    assert (err > 10 * LATENT_ATOL) if kind["int8"] else (err <= LATENT_ATOL), err


FAMILIES = {
    "gptneox": dict(family="gptneox", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, use_parallel_residual=False, tie_word_embeddings=False),
    "llama": dict(family="llama", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  intermediate_size=48, attention_bias=False, tie_word_embeddings=False, hidden_act="silu",
                  layer_norm_eps=1e-6),
    "opt": dict(family="opt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_blocks_carry_tiles(family, slots, monkeypatch):
    """Each family's fused MLP launch carries tiles: 4 decoder layers at n 1
    give 8 carriers a step (4 xattn FFs, 4 block MLPs) for a ViT layer's 8
    slots, 2 absorbing steps."""
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    cfg = configs.FlamingoConfig(vision=configs.VisionConfig(**VIS),
                                 lm=configs.DecoderConfig(**{**FAMILIES[family], "num_layers": 4}), **FLAMINGO)
    model = init_random(cfg, 3, device="cpu")
    rng = np.random.default_rng(3)
    vision_x = torch.from_numpy(rng.normal(size=(2, 1, 1, 16, 16, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(7, VOCAB, size=(2, 6)))
    ids[:, 0] = MEDIA
    mask = torch.ones_like(ids)
    next_pixels = torch.from_numpy(rng.normal(size=(2, 1, 1, 16, 16, 3)).astype(np.float32))
    gen = GenerationConfig(max_new_tokens=3, pad_token_id=0, eos_token_id=-1)
    plan = port_av.make_plan(cfg, (2, 1, 1), 3)
    assert plan is not None and plan.side_groups == 4
    calls = []
    mlp = port_ds.reference_mlp
    block = type(model.lm.blocks[0])
    monkeypatch.setattr(f"open_flamingo_tpu_torch.models.decoders.{family}.reference_mlp",
                        lambda *a, **kw: calls.append("side_x" in kw) or mlp(*a, **kw))
    plain = flamingo_generate(model, vision_x, ids, mask, gen, device="cpu")
    calls.clear()
    tok, lat = flamingo_generate(model, vision_x, ids, mask, gen, next_pixels=next_pixels, device="cpu")
    assert len(slots) == plan.slots_per_layer * plan.n_vit_layers
    assert sum(calls) == 2 * 4, f"{block.__name__}: MLP launches carrying tiles"     # 4 per absorbing step
    assert torch.equal(tok, plain)
    with torch.no_grad():
        serial = model.embed_vision(next_pixels)
    np.testing.assert_allclose(lat.numpy(), serial.numpy(), atol=LATENT_ATOL, rtol=0)
