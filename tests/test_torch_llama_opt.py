"""The port's LLaMA and OPT slice against the JAX package on the CPU.

  * K1 `fused_dense`'s plain version with the RMSNorm prologue and every
    activation (none, exact GELU, gelu_new, relu, quick_gelu, silu), with
    and without bias, clip, residual and gate, over weights in x's dtype,
    int8 and packed int4, against JAX `fused_dense` in Pallas interpret
    mode; the LayerNorm prologue with the new activations too;
  * K2 `fused_mlp`'s plain version: SwiGLU (`w1_gate`, RMSNorm, silu) over
    weights in x's dtype, int8 and int4 with a ragged hidden size (the JAX
    kernel masks its last hidden block), OPT's relu MLP with b1/b2, and
    gelu_new and quick_gelu;
  * the refusals: `ln_bias` with an RMSNorm, a mixed `w1`/`w1_gate` stored
    type, an unknown activation or norm;
  * `repeat_kv` (query head h reads KV head h // n_rep);
  * one LlamaBlock with grouped-query attention (4 heads over 2 KV heads)
    and one OPTBlock: prefill's output and cache, and one fused decode step
    (llama: three K1 with RMSNorm, RoPE, K6 over the grouped cache, K2
    SwiGLU; OPT: three K1 with LN + bias, K6 with the out_proj bias, K2
    relu) with the JAX block under `FORCE_FUSED` + `INTERPRET`;
  * the slice: tiny GQA llama (untied head, RMSNorm eps 1e-6, xattn every
    second layer) and tiny OPT (learned positions at +2, tied head, xattn
    every layer) Flamingo models: greedy tokens exactly equal to JAX
    `flamingo_generate` on the fused and the unfused route, with and
    without a left-padded row, and the logits of prefill and every decode
    step; llama with int8, int4 and int8 weights + the int8 K/V and media
    caches against the JAX `scan_layers=True` model (the int8 cache held as
    tests/test_torch_quantize.py holds it: one-step entries at rounding
    boundaries after prefill, each decode step from JAX's cache).

fp32 on both sides. Tolerances: 2e-5 for kernel outputs and one block (the
JAX package's bound for these kernels), 1e-4 for logits through the tiny
models. Biases are drawn at random (flax initialises them to 0) so that
every bias epilogue does work.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_layers import _scan_variables
from test_torch_quantize import (VIS, gen_cfgs, grid_weight, hold_int8_caches, jax_step_logits, jax_w, left_pad,
                                 make_family, port_step_logits, port_w, random_biases)

from open_flamingo_tpu import quantize as jq
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders import common as jax_common
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import make_attn_inputs as jax_attn_inputs
from open_flamingo_tpu.models.decoders.llama import LlamaBlock as JaxLlamaBlock
from open_flamingo_tpu.models.decoders.opt import OPTBlock as JaxOPTBlock
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops.dense_stream import fused_dense as jax_dense
from open_flamingo_tpu.ops.dense_stream import fused_mlp as jax_mlp
from open_flamingo_tpu_torch import quantize as tq
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import decode_weights_from_jax, kv_cache_from_jax, state_dict_from_jax
from open_flamingo_tpu_torch.generation import flamingo_generate, prefill
from open_flamingo_tpu_torch.models import lm as port_lm
from open_flamingo_tpu_torch.models import xattn as port_xattn
from open_flamingo_tpu_torch.models.decoders import llama as port_llama
from open_flamingo_tpu_torch.models.decoders import opt as port_opt
from open_flamingo_tpu_torch.models.decoders.common import KVCache, make_attn_inputs, repeat_kv
from open_flamingo_tpu_torch.models.decoders.llama import LlamaBlock
from open_flamingo_tpu_torch.models.decoders.opt import OPTBlock
from open_flamingo_tpu_torch.models.flamingo import Flamingo
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp

ATOL = 2e-5
LOGITS_ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def normal(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def weight(rng, n, k, bits):
    """(port operand (N, K), JAX operand (K, N), scale or None): fp32, or
    int8 / int4 on the grid with its per-channel scale."""
    if bits is None:
        w = normal(rng, n, k, scale=k**-0.5)
        return t(w), jnp.asarray(w.T), None
    q, s = grid_weight(rng, n, k, bits)
    return port_w(q, bits), jax_w(q, bits), s


# ---------------------------------------------------------------- K1

BD, KD, N = 8, 256, 384
DENSE_CASES = {
    "rms_float": dict(norm="rms", act=None, bits=None),
    "rms_silu_bias_int8": dict(norm="rms", act="silu", bits=8, bias=True),
    "rms_gelu_new_residual_gate_int4": dict(norm="rms", act="gelu_new", bits=4, residual=True, gate=True),
    "rms_relu_clip_bias_float": dict(norm="rms", act="relu", bits=None, clip=0.3, bias=True),
    "rms_quick_gelu_residual_int8": dict(norm="rms", act="quick_gelu", bits=8, residual=True),
    "rms_gelu_gate_int4": dict(norm="rms", act="gelu", bits=4, gate=True),
    "rms_head_ragged_int8": dict(norm="rms", act=None, bits=8, n=300, transposed=True),
    "rms_head_ragged_float": dict(norm="rms", act=None, bits=None, n=300, transposed=True),
    "layer_bias_relu_float": dict(norm="layer", act="relu", bits=None, bias=True, ln_bias=True),
    "layer_bias_int4": dict(norm="layer", act=None, bits=4, bias=True, ln_bias=True),
    "layer_silu_residual_int8": dict(norm="layer", act="silu", bits=8, residual=True, ln_bias=True),
    "layer_gelu_new_float": dict(norm="layer", act="gelu_new", bits=None),
    "layer_quick_gelu_bias_int4": dict(norm="layer", act="quick_gelu", bits=4, bias=True),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_norms_and_acts_match_pallas(rng, case):
    opt = DENSE_CASES[case]
    n = opt.get("n", N)
    x, ln = normal(rng, BD, KD, scale=1.5), normal(rng, KD, scale=1.0)
    w_t, w_j, s = weight(rng, n, KD, opt["bits"])
    kw_j, kw_t = dict(ln_scale=jnp.asarray(ln)), dict(ln_scale=t(ln))
    if s is not None:
        kw_j["w_scale"], kw_t["w_scale"] = jnp.asarray(s), t(s)
    for name, shape, on in (("ln_bias", (KD,), opt.get("ln_bias")), ("bias", (n,), opt.get("bias")),
                            ("residual", (BD, n), opt.get("residual")), ("gate", (1,), opt.get("gate"))):
        if on:
            val = normal(rng, *shape)
            kw_j[name], kw_t[name] = jnp.asarray(val), t(val)
    if opt.get("transposed"):     # the head: the (V, D) table streamed as the transposed weight
        w_j = w_j.T
    want = jax_dense(jnp.asarray(x), w_j, norm=opt["norm"], act=opt["act"], clip=opt.get("clip"), eps=1e-6,
                     w_transposed=bool(opt.get("transposed")), block_n=128, interpret=True, **kw_j)
    got = fused_dense(t(x), w_t, norm=opt["norm"], act=opt["act"], clip=opt.get("clip"), eps=1e-6, **kw_t)
    close(got, want)


# ---------------------------------------------------------------- K2

K2_RAGGED = 344                  # 2 * 128 + 88: the JAX kernel's last hidden block is ragged


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_mlp_swiglu_matches_pallas(rng, bits):
    """llama's MLP: RMSNorm, silu(x @ gate.T) * (x @ up.T), down, residual
    (b1, b2 and the gate in the fp32 weights' case)."""
    x, ln, res = normal(rng, BD, KD, scale=1.5), normal(rng, KD, scale=1.0), normal(rng, BD, N)
    (g_t, g_j, sg), (u_t, u_j, su), (d_t, d_j, sd) = (weight(rng, *shape, bits) for shape in
                                                       ((K2_RAGGED, KD), (K2_RAGGED, KD), (N, K2_RAGGED)))
    kw = dict(ln_scale=ln, residual=res)
    if bits is None:
        kw.update(b1=normal(rng, K2_RAGGED, scale=0.1), b2=normal(rng, N, scale=0.1), gate=np.array([0.4], np.float32))
    else:
        kw.update(w1_scale=sg, w1_gate_scale=su, w2_scale=sd)
    want = jax_mlp(jnp.asarray(x), g_j, d_j, w1_gate=u_j, norm="rms", act="silu", eps=1e-6, block_k2=128,
                   interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = fused_mlp(t(x), g_t, d_t, w1_gate=u_t, norm="rms", act="silu", eps=1e-6, **{k: t(v) for k, v in kw.items()})
    close(got, want)


MLP_CASES = {
    "relu_b1_b2_float": dict(act="relu", bits=None, biases=True),
    "relu_b1_b2_int8": dict(act="relu", bits=8, biases=True),
    "gelu_new_float": dict(act="gelu_new", bits=None),
    "quick_gelu_int4": dict(act="quick_gelu", bits=4),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_acts_match_pallas(rng, case):
    """OPT's MLP (LN with bias, fc1 + b1, relu, fc2 + b2, residual) and the
    gelu_new / quick_gelu epilogues, at the ragged hidden size."""
    opt = MLP_CASES[case]
    x, res = normal(rng, BD, KD), normal(rng, BD, N)
    (w1_t, w1_j, s1), (w2_t, w2_j, s2) = weight(rng, K2_RAGGED, KD, opt["bits"]), weight(rng, N, K2_RAGGED, opt["bits"])
    kw = dict(ln_scale=normal(rng, KD, scale=1.0), ln_bias=normal(rng, KD, scale=0.1), residual=res)
    if opt.get("biases"):
        kw.update(b1=normal(rng, K2_RAGGED, scale=0.1), b2=normal(rng, N, scale=0.1))
    if s1 is not None:
        kw.update(w1_scale=s1, w2_scale=s2)
    want = jax_mlp(jnp.asarray(x), w1_j, w2_j, act=opt["act"], block_k2=128, interpret=True,
                   **{k: jnp.asarray(v) for k, v in kw.items()})
    close(fused_mlp(t(x), w1_t, w2_t, act=opt["act"], **{k: t(v) for k, v in kw.items()}), want)


@pytest.mark.parametrize("call", ["rms_ln_bias", "mixed_gate_type", "unknown_act", "unknown_norm",
                                  "gate_scale_without_gate", "gate_shape", "mlp_rms_ln_bias"])
def test_refusals(call):
    x, w, ones = torch.zeros(2, 16), torch.zeros(24, 16), torch.ones(16)
    w8 = torch.zeros(24, 16, dtype=torch.int8)
    calls = {
        "rms_ln_bias": lambda: fused_dense(x, w, ln_scale=ones, ln_bias=ones, norm="rms"),
        "mixed_gate_type": lambda: fused_mlp(x, w, w.t(), w1_gate=w8, w1_gate_scale=torch.ones(24)),
        "unknown_act": lambda: fused_dense(x, w, act="swish"),
        "unknown_norm": lambda: fused_mlp(x, w, w.t(), ln_scale=ones, norm="group"),
        "gate_scale_without_gate": lambda: fused_mlp(x, w, w.t(), w1_gate_scale=torch.ones(24)),
        "gate_shape": lambda: fused_mlp(x, w, w.t(), w1_gate=w[:20]),
        "mlp_rms_ln_bias": lambda: fused_mlp(x, w, w.t(), w1_gate=w, ln_scale=ones, ln_bias=ones, norm="rms"),
    }
    with pytest.raises(ValueError):
        calls[call]()


@pytest.mark.parametrize("head_axis", [1, 2])
def test_repeat_kv_matches_jax(rng, head_axis):
    x = normal(rng, 2, 3, 5, 4) if head_axis == 2 else normal(rng, 2, 3, 5, 4).transpose(0, 2, 1, 3).copy()
    got = repeat_kv(t(x), 3, head_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_common.repeat_kv(jnp.asarray(x), 3, head_axis)))
    h = 4                                                # query head h reads KV head h // 3
    assert torch.equal(got.select(head_axis, h), t(x).select(head_axis, h // 3))


# ---------------------------------------------------------------- one block


@pytest.fixture
def fused(monkeypatch):
    """Both packages on the fused decode route; counts the port's calls of
    each plain version on it (K1 q/k/v and head, K2, K3 in xattn, K6)."""
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

    for module in (port_lm, port_llama, port_opt):
        counted(module, "reference_dense", "K1")
    for module in (port_llama, port_opt, port_xattn):
        counted(module, "reference_mlp", "K2")
    counted(port_xattn, "reference_attn_block", "K3")
    for module in (port_llama, port_opt):
        counted(module, "reference_attend_out", "K6")
    return calls


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return module


BLOCKS = {
    "llama_gqa": (dict(family="llama", vocab_size=64, hidden_size=128, num_layers=1, num_heads=4, num_kv_heads=2,
                       intermediate_size=K2_RAGGED, layer_norm_eps=1e-6, attention_bias=False,
                       tie_word_embeddings=False, hidden_act="silu"), JaxLlamaBlock, LlamaBlock),
    "opt": (dict(family="opt", vocab_size=64, hidden_size=128, num_layers=1, num_heads=4, intermediate_size=K2_RAGGED,
                 max_position_embeddings=64), JaxOPTBlock, OPTBlock),
}


@pytest.mark.parametrize("family", list(BLOCKS))
def test_block_prefill_and_decode_step_match_jax(rng, fused, family):
    cfg, jax_cls, port_cls = BLOCKS[family]
    b, tq, s, d = 2, 4, 8, cfg["hidden_size"]
    jcfg = JaxDecoderConfig(**cfg)
    jm = jax_cls(cfg=jcfg)
    x = rng.normal(size=(b, tq, d)).astype(np.float32)
    am = np.ones((b, tq), np.int32)
    am[1, :2] = 0                                       # row 1 left-padded by 2
    cache = JaxKVCache.create(jcfg, b, max_length=s)
    attn, cache = jax_attn_inputs(jnp.asarray(am), cache=cache)
    params = random_biases(jm.init(jax.random.PRNGKey(0), x, attn, cache.layers[0]), 1)
    params = jax.tree_util.tree_map_with_path(          # norm scales away from 1
        lambda path, p: p + jnp.asarray(rng.normal(size=p.shape) * 0.2, p.dtype)
        if jax.tree_util.keystr(path).endswith("['scale']") else p, params)
    want_pre, kv = jm.apply(params, x, attn, cache.layers[0])         # prefill (tq > 1: not fused)
    cache = cache.replace(layers=(kv,), index=cache.index + tq)
    xt = rng.normal(size=(b, 1, d)).astype(np.float32)
    attn1, cache1 = jax_attn_inputs(jnp.ones((b, 1), jnp.int32), cache=cache)
    want, want_kv = jm.apply(params, xt, attn1, cache1.layers[0])

    tcfg = DecoderConfig(**cfg)
    tm = load(port_cls(tcfg, device="cpu"), params)
    tcache = KVCache.create(tcfg, b, s, torch.float32, "cpu")
    assert tcache.layers[0].k.shape[1] == tcfg.kv_heads
    tattn, tcache = make_attn_inputs(t(am), cache=tcache)
    with torch.no_grad():
        got_pre, _ = tm(t(x), tattn, tcache.layers[0])
        close(got_pre, want_pre)
        close(tcache.layers[0].k, kv.k)
        close(tcache.layers[0].v, kv.v)
        tcache = dataclasses.replace(tcache, index=tq, slot=torch.tensor([tq], dtype=torch.int32))
        tattn1, tcache = make_attn_inputs(torch.ones(b, 1, dtype=torch.long), cache=tcache)
        got, got_kv = tm(t(xt), tattn1, tcache.layers[0])
    assert fused == {"K1": 3, "K2": 1, "K3": 0, "K6": 1}
    close(got, want)
    close(got_kv.k, want_kv.k)
    close(got_kv.v, want_kv.v)


# ---------------------------------------------------------------- the slice

FLAMINGO = dict(num_vis_latents=4, perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8)
SPECS = {
    "llama": dict(
        lm=dict(family="llama", vocab_size=67, hidden_size=128, num_layers=4, num_heads=4, num_kv_heads=2,
                intermediate_size=K2_RAGGED, layer_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=False,
                hidden_act="silu"),
        flamingo=dict(media_token_id=64, eoc_token_id=65, cross_attn_every_n=2, **FLAMINGO),
        pad=66, ids_low=0, seed=4,
    ),
    "opt": dict(
        lm=dict(family="opt", vocab_size=67, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256,
                max_position_embeddings=64),
        flamingo=dict(media_token_id=64, eoc_token_id=65, cross_attn_every_n=1, **FLAMINGO),
        pad=66, ids_low=0, seed=5,
    ),
}
B, NEW = 2, 5


def port_model(spec, params, qvars=None):
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**spec["lm"]), **spec["flamingo"])
    model = load(Flamingo(tcfg, device="cpu"), params)
    if qvars is not None:
        tq.attach_decode_weights(model, decode_weights_from_jax(jax.tree.map(np.asarray, qvars)))
    return model


@pytest.fixture(scope="module")
def families():
    out = {}
    for name, spec in SPECS.items():
        jmodel, params, vision_x, ids = make_family(spec)
        params = random_biases(params, 6)
        out[name] = (jmodel, params, port_model(spec, params), vision_x, ids)
    return out


def port_generate(tmodel, spec, vision_x, ids, mask, int8_kv=False):
    return flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), gen_cfgs(spec, int8_kv)[1], device="cpu").numpy()


@pytest.mark.parametrize("family", list(SPECS))
def test_greedy_tokens_equal_jax(families, fused, monkeypatch, family):
    """With and without a left-padded row, on the fused route (K1, K6, K2 per
    layer; K3, K2 per xattn block; K1 for the head) and the unfused one."""
    spec = SPECS[family]
    jmodel, params, tmodel, vision_x, ids = families[family]
    jgen = gen_cfgs(spec, False)[0]
    layers, every = spec["lm"]["num_layers"], spec["flamingo"]["cross_attn_every_n"]
    xattn = layers // every
    cases = [left_pad(spec, ids, 3), (ids, np.ones_like(ids))]
    for ids_c, mask in cases:
        for k in fused:
            fused[k] = 0
        want = np.asarray(jax_generate(jmodel, params, vision_x, ids_c, mask, jgen))
        np.testing.assert_array_equal(port_generate(tmodel, spec, vision_x, ids_c, mask), want)
        steps = NEW - 1
        assert fused == {"K1": steps * (3 * layers + 1), "K2": steps * (layers + xattn), "K3": steps * xattn,
                         "K6": steps * layers}
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", False)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", False)
    for ids_c, mask in cases:
        want = np.asarray(jax_generate(jmodel, params, vision_x, ids_c, mask, jgen))
        np.testing.assert_array_equal(port_generate(tmodel, spec, vision_x, ids_c, mask), want)
    assert fused["K6"] == (NEW - 1) * layers                # the unfused calls took no fused kernel


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("family", list(SPECS))
def test_step_logits_match_jax(families, fused, monkeypatch, family, route):
    """Prefill's last position, then every decode step fed JAX's greedy
    token stream, a left-padded row included."""
    if route == "unfused":
        monkeypatch.setattr(jax_ds, "FORCE_FUSED", False)
        monkeypatch.setattr(port_ds, "FORCE_FUSED", False)
    spec = SPECS[family]
    jmodel, params, tmodel, vision_x, ids = families[family]
    ids, mask = left_pad(spec, ids, 3)
    stream = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, gen_cfgs(spec, False)[0]))
    want = jax_step_logits(jmodel, params, vision_x, ids, mask, stream, False)
    got = port_step_logits(tmodel, vision_x, ids, mask, stream, False)
    assert fused["K6"] == (NEW - 1) * spec["lm"]["num_layers"] * (route == "fused")
    for g, w in zip(got, want):
        close(g, w, LOGITS_ATOL)


QUANT = {"int8": (8, False), "int4": (4, False), "int8_int8kv": (8, True)}


@pytest.mark.parametrize("case", list(QUANT))
def test_llama_quantized_matches_jax(families, fused, case):
    """int8 / int4 weights (gate_proj and up_proj streamed through K2's
    gated form, the head int8) and int8 weights with the int8 K/V and media
    caches, against the JAX scan_layers=True model read across by from_jax:
    tokens exactly equal with a left-padded row, the logits of prefill and
    every decode step (over the int8 cache from shared states)."""
    bits, int8_kv = QUANT[case]
    spec = SPECS["llama"]
    jmodel, params, _, vision_x, ids = families["llama"]
    params = _scan_variables(params, jmodel)
    jmodel = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    qvars = jq.quantize_decode_params(params, bits)
    tmodel = port_model(spec, params, qvars)
    assert tmodel.lm.blocks[0].up_proj.weight_q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    jgen = gen_cfgs(spec, int8_kv)[0]
    ids_p, mask = left_pad(spec, ids, 3)
    want = np.asarray(jax_generate(jmodel, qvars, vision_x, ids_p, mask, jgen))
    np.testing.assert_array_equal(port_generate(tmodel, spec, vision_x, ids_p, mask, int8_kv), want)
    mask = np.ones_like(ids)
    stream = np.asarray(jax_generate(jmodel, qvars, vision_x, ids, mask, jgen))
    if not int8_kv:
        want = jax_step_logits(jmodel, qvars, vision_x, ids, mask, stream, False)
        got = port_step_logits(tmodel, vision_x, ids, mask, stream, False)
        for g, w in zip(got, want):
            close(g, w, LOGITS_ATOL)
        return
    want, got, jax_cache = jax_step_logits(jmodel, qvars, vision_x, ids, mask, stream, True, port=tmodel)
    for g, w in zip(got, want[1:]):
        close(g, w, LOGITS_ATOL)
    s = -(-(ids.shape[1] + NEW) // 16) * 16
    _, cache = prefill(tmodel, tmodel.embed_vision(t(vision_x)), t(ids), t(mask), s, True)
    hold_int8_caches(cache, kv_cache_from_jax(jax.tree.map(np.asarray, jax_cache)))
    want = jax_step_logits(jmodel, qvars, vision_x, ids, mask, stream[:, :1], False)
    close(port_step_logits(tmodel, vision_x, ids, mask, stream[:, :1], False)[0], want[0], LOGITS_ATOL)
