"""Quantized decode in the port (int8 / packed int4 weight streaming, the int8
K/V and media caches) against the JAX package on the CPU.

  * the quantizers bit for bit: `quantize_weight` (bits 8 and 4, a zero
    channel, values on .5 after the division), `quantize_kv` (a zero row),
    `pack_int4`/`unpack_int4`;
  * the side-car: `quantize_decode_weights` against JAX
    `quantize_decode_params`, and JAX's `qparams` read by
    `convert.from_jax.decode_weights_from_jax` from the unrolled and the
    scanned layout: the same modules, head included, the same tensors;
  * the plain versions of K1, K2, K3 and K6 with int8/int4 weights and the
    int8 cache against the JAX kernels in Pallas interpret mode; the written
    int8 K/V and their scales exactly equal;
  * the int8 cache's quantize-and-write (`update_layer_kv`) bit for bit
    on the same K/V inputs, the dequantized K/V it returns included;
  * the slice: greedy tokens exactly equal to JAX `flamingo_generate` and
    the logits of prefill and every decode step, for MPT with int8 and with
    int4 weights (the unrolled JAX model), MPT int8 + `int8_kv` and GPT-NeoX
    int8 + `int8_kv` (the JAX `scan_layers=True` model, the only one for
    which the JAX package engages the int8 cache, read into the port by
    `from_jax`). Over the int8 cache the two packages part at rounding
    boundaries: their fp32 K/V agree to ~1e-6, but sums taken in another
    order put an entry whose value lies within that of a half step one
    quantization step apart, and every later layer reads it. So the caches
    after prefill are held equal but for such one-step entries (at most
    0.1% of them, `chip_smoke.py`'s rule), each decode step's logits are
    compared from one shared state (JAX's cache of that step, read across
    by `convert.from_jax.kv_cache_from_jax`), and prefill's logits with a
    model-dtype cache;
  * the round trip: on `dequantize_roundtrip` weights the port's quantized
    decode gives the tokens of its unquantized decode.

fp32 on both sides. Tolerances: 2e-5 for kernel outputs (the JAX package's
bound for these kernels), 2e-4 where an int8 cache is read (as
tests/test_int8_kv.py), 1e-4 for logits through the tiny models. Where the
written int8 cache must match bit for bit, K3's inputs sit on a coarse grid
(x = +-1 per row, eps 0) so that both packages compute the projection
exactly: a sum taken in another order would move a scale by one ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_layers import _scan_variables

from open_flamingo_tpu import quantize as jq
from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import LayerKV as JaxLayerKV
from open_flamingo_tpu.models.decoders.common import kv_scale_layout
from open_flamingo_tpu.models.decoders.common import make_attn_inputs as jax_attn_inputs
from open_flamingo_tpu.models.decoders.common import quantize_kv as jax_quantize_kv
from open_flamingo_tpu.models.decoders.common import update_layer_kv as jax_update_layer_kv
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.flamingo import count_media as jax_count_media
from open_flamingo_tpu.models.lm import extract_media_kv
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops.decode_layer import attend_out_decode as jax_attend_out
from open_flamingo_tpu.ops.decode_layer import attn_block_decode as jax_attn_block
from open_flamingo_tpu.ops.dense_stream import fused_dense as jax_dense
from open_flamingo_tpu.ops.dense_stream import fused_mlp as jax_mlp
from open_flamingo_tpu_torch import generation as port_generation
from open_flamingo_tpu_torch import quantize as tq
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import decode_weights_from_jax, kv_cache_from_jax, state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate, prefill
from open_flamingo_tpu_torch.models.decoders.common import (KVCache, alibi_slopes, make_attn_inputs, quantize_kv,
                                                            update_layer_kv)
from open_flamingo_tpu_torch.models.flamingo import Flamingo, count_media
from open_flamingo_tpu_torch.ops import decode_layer as port_dl
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops.decode_layer import attend_out_decode, attn_block_decode
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp

ATOL = 2e-5
KV_ATOL = 2e-4
LOGITS_ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def normal(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- quantizers


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_bit_exact(rng, bits):
    qmax = 127 if bits == 8 else 7
    w = normal(rng, 12, 40)                               # (N, K), the port's layout
    w[3] = 0.0                                            # a zero channel: scale 1
    w[5, :6] = [qmax, 0.5, 1.5, 2.5, -2.5, -0.5]          # scale 1: quotients on .5, half to even
    w[7, :4] = [qmax * 3.0, 1.5 * 3.0, 4.5 * 3.0, -3.5 * 3.0]
    q, s = tq.quantize_weight(torch.from_numpy(w), bits)
    q_j, s_j = jq.quantize_weight(jnp.asarray(w.T), axis=0, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s[3] == 1.0 and (q[3] == 0).all()
    assert q[5, :6].tolist() == [qmax, 0, 2, 2, -2, 0]


def test_quantize_kv_bit_exact(rng):
    x = normal(rng, 2, 3, 5, 16, scale=2.0)
    x[1, 2, 4] = 0.0                                      # a zero row: scale 1
    q, s = quantize_kv(torch.from_numpy(x))
    q_j, s_j = jax_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert s[1, 2, 4] == 1.0 and (q[1, 2, 4] == 0).all()


@pytest.mark.parametrize("slot", [0, 5])
def test_update_layer_kv_int8_bit_exact(rng, slot):
    """The int8 cache's prefill write on the same K/V inputs: the int8 rows,
    their scales and the dequantized K/V returned for this call's attention
    equal JAX's bit for bit (a zero row: scale 1)."""
    b, tq, h, dh, s = 2, 4, 3, 16, 12
    k, v = normal(rng, b, tq, h, dh, scale=2.0), normal(rng, b, tq, h, dh, scale=2.0)
    k[1, 2, 0] = 0.0
    am = np.ones((b, tq), np.int32)
    am[0, 0] = 0
    cfg = dict(family="gptneox", vocab_size=8, hidden_size=h * dh, num_layers=1, num_heads=h, intermediate_size=8)
    jcache = JaxKVCache.create(JaxDecoderConfig(**cfg), b, s, int8=True).replace(index=jnp.asarray(slot, jnp.int32))
    jattn, jcache = jax_attn_inputs(jnp.asarray(am), cache=jcache)
    jk, jv, jl = jax_update_layer_kv(jcache.layers[0], jnp.asarray(k), jnp.asarray(v), jattn)
    cache = KVCache.create(DecoderConfig(**cfg), b, s, torch.float32, "cpu", int8=True)
    cache = dataclasses.replace(cache, index=slot, slot=torch.tensor([slot], dtype=torch.int32))
    attn, cache = make_attn_inputs(t(am), cache=cache)
    pk, pv, pl = update_layer_kv(cache.layers[0], t(k), t(v), attn)
    for mine, theirs in ((pl.k, jl.k), (pl.v, jl.v), (pk, jk), (pv, jv)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for mine, theirs in ((pl.k_s, jl.k_s), (pl.v_s, jl.v_s)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(kv_scale_layout(theirs)))
    assert pl.k_s[1, 0, slot + 2] == 1.0 and (pl.k[1, 0, slot + 2] == 0).all()


def test_pack_int4_round_trip(rng):
    q = torch.from_numpy(rng.integers(-8, 8, size=(5, 24)).astype(np.int8))
    p = tq.pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (5, 12)
    assert torch.equal(tq.unpack_int4(p), q)
    # element 2j in the low nibble, 2j + 1 in the high one, two's complement
    assert int(p[0, 0]) == (int(q[0, 0]) & 0xF) | ((int(q[0, 1]) & 0xF) << 4)
    with pytest.raises(ValueError):
        tq.pack_int4(q[:, :5])


# ---------------------------------------------------------------- tiny models

VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
MPT = dict(
    lm=dict(family="mpt", vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            alibi=True, attention_bias=False, ln_no_bias=True, clip_qkv=6.0),
    flamingo=dict(media_token_id=5, eoc_token_id=6, cross_attn_every_n=1, num_vis_latents=4, perceiver_depth=1,
                  perceiver_heads=2, perceiver_dim_head=8),
    pad=1, ids_low=7, seed=1,
)
NEOX = dict(
    lm=dict(family="gptneox", vocab_size=67, hidden_size=160, num_layers=4, num_heads=2, intermediate_size=640,
            use_parallel_residual=False, tie_word_embeddings=False),
    flamingo=dict(media_token_id=64, eoc_token_id=65, cross_attn_every_n=2, num_vis_latents=4, perceiver_depth=1,
                  perceiver_heads=2, perceiver_dim_head=8),
    pad=66, ids_low=0, seed=2,
)
B, T_TXT, NEW = 2, 10, 5


def random_biases(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(rng.normal(size=p.shape) * 0.1, p.dtype)
        if jax.tree_util.keystr(path).endswith("['bias']") else p, params)


def make_family(spec):
    rng = np.random.default_rng(spec["seed"])
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**spec["lm"]), **spec["flamingo"])
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, 2, 1, 14, 14, 3)).astype(np.float32)
    media = spec["flamingo"]["media_token_id"]
    ids = rng.integers(spec["ids_low"], 64, size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = media
    ids[0, 4] = media
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)
    if spec["lm"]["family"] == "gptneox":
        params = random_biases(params, 3)
    return jmodel, params, vision_x, ids


@pytest.fixture(scope="module")
def mpt():
    return make_family(MPT)


@pytest.fixture(scope="module")
def neox():
    return make_family(NEOX)


def port_model(spec, params, qvars=None):
    """The port's Flamingo with JAX `params`, and the quantized copies of the
    JAX `qparams` in `qvars` when given."""
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**spec["lm"]), **spec["flamingo"])
    model = Flamingo(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    if qvars is not None:
        tq.attach_decode_weights(model, decode_weights_from_jax(jax.tree.map(np.asarray, qvars)))
    return model


# ---------------------------------------------------------------- side-car


@pytest.mark.parametrize("family,bits", [("mpt", 8), ("mpt", 4), ("gptneox", 8)])
def test_sidecar_matches_jax(mpt, neox, family, bits):
    """The port's quantized copies equal JAX's qparams read through from_jax,
    unrolled and scanned, over the same set of modules, head included."""
    spec, (jmodel, params, _, _) = (MPT, mpt) if family == "mpt" else (NEOX, neox)
    mine = tq.decode_weights(tq.quantize_decode_weights(port_model(spec, params), bits))
    head = "lm.wte" if spec["lm"].get("tie_word_embeddings", True) else "lm.lm_head"
    assert head in mine and mine[head][0].dtype == torch.int8            # the head stays int8
    assert any(n.endswith("attn.to_q") for n in mine) and not any(n.endswith("to_kv") for n in mine)
    for variables in (params, _scan_variables(params, jmodel)):
        theirs = decode_weights_from_jax(jax.tree.map(np.asarray, jq.quantize_decode_params(variables, bits)))
        assert theirs.keys() == mine.keys()
        for name, (q, s) in mine.items():
            assert q.dtype == theirs[name][0].dtype, name
            assert torch.equal(q, theirs[name][0]) and torch.equal(s, theirs[name][1]), name
        if bits == 4:
            assert mine["lm.blocks.0.up_proj"][0].dtype == torch.uint8


# ---------------------------------------------------------------- plain vs Pallas

BD, KD, N = 8, 256, 384


def grid_weight(rng, n, k, bits):
    """(q (N, K) int8 on the bits' grid, scale (N,) fp32)."""
    qmax = 127 if bits == 8 else 7
    q = rng.integers(-qmax, qmax + 1, size=(n, k)).astype(np.int8)
    return q, (2.0 ** rng.integers(-12, -9, size=n) * (16 if bits == 4 else 1)).astype(np.float32)


def jax_w(q, bits):
    """The JAX kernels' weight operand for port-layout q (N, K): (K, N)."""
    return jnp.asarray(q.T, jnp.int8 if bits == 8 else jnp.int4)


def port_w(q, bits):
    return torch.from_numpy(q) if bits == 8 else tq.pack_int4(torch.from_numpy(q))


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_quantized_matches_pallas(rng, bits):
    # the ragged transposed head (N = 300, as tests/test_quantize.py) ...
    x, ln = normal(rng, BD, KD), normal(rng, KD, scale=1.0)
    q, s = grid_weight(rng, 300, KD, bits)
    want = jax_dense(jnp.asarray(x), jnp.asarray(q, jnp.int8 if bits == 8 else jnp.int4), w_scale=jnp.asarray(s),
                     ln_scale=jnp.asarray(ln), w_transposed=True, block_n=128, interpret=True)
    close(fused_dense(t(x), port_w(q, bits), w_scale=t(s), ln_scale=t(ln)), want)
    # ... and bias + clip + gate + residual
    q, s = grid_weight(rng, N, KD, bits)
    ops = dict(bias=normal(rng, N, scale=0.1), residual=normal(rng, BD, N), gate=np.array([0.7], np.float32))
    want = jax_dense(jnp.asarray(x), jax_w(q, bits), w_scale=jnp.asarray(s), clip=0.8, block_n=128, interpret=True,
                     **{k: jnp.asarray(v) for k, v in ops.items()})
    got = fused_dense(t(x), port_w(q, bits), w_scale=t(s), clip=0.8, **{k: t(v) for k, v in ops.items()})
    close(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_mlp_quantized_matches_pallas(rng, bits):
    k2 = 512
    x, res = normal(rng, BD, KD), normal(rng, BD, N)
    (q1, s1), (q2, s2) = grid_weight(rng, k2, KD, bits), grid_weight(rng, N, k2, bits)
    ops = dict(b1=normal(rng, k2, scale=0.1), b2=normal(rng, N, scale=0.1), ln_scale=normal(rng, KD, scale=1.0),
               ln_bias=normal(rng, KD, scale=0.1), residual=res, gate=np.array([-0.3], np.float32))
    want = jax_mlp(jnp.asarray(x), jax_w(q1, bits), jax_w(q2, bits), w1_scale=jnp.asarray(s1),
                   w2_scale=jnp.asarray(s2), act="gelu", block_k2=128, interpret=True,
                   **{k: jnp.asarray(v) for k, v in ops.items()})
    got = fused_mlp(t(x), port_w(q1, bits), port_w(q2, bits), w1_scale=t(s1), w2_scale=t(s2), act="gelu",
                    **{k: t(v) for k, v in ops.items()})
    close(got, want)


H, DH, D, S = 4, 16, 64, 48


def cache_pair(rng, b, h, s, dh, int8):
    """(JAX operands, port operands) of a random cache: fp32, or int8 with
    scales in JAX's head-leading (H, B, S) and the port's (B, H, S) layout."""
    kf, vf = normal(rng, b, h, s, dh, scale=1.0), normal(rng, b, h, s, dh, scale=1.0)
    if not int8:
        return (jnp.asarray(kf), jnp.asarray(vf), None, None), (t(kf), t(vf), None, None)
    (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(kf)), jax_quantize_kv(jnp.asarray(vf))
    jax_ops = (kq, vq, kv_scale_layout(ks), kv_scale_layout(vs))
    return jax_ops, tuple(t(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("slot", [0, 40, S - 1])
def test_attn_block_self_quantized_matches_pallas(rng, bits, int8_kv, slot):
    """K3 fused QKV with clip and ALiBi, int weights, with and without the
    int8 cache: output, and the caches (and scales) exactly."""
    b = 3
    # x = +-1 per row (mean 0, variance 1, eps 0), grid LN and weights: the
    # projection is exact in both packages
    x = np.where(rng.integers(0, 2, size=(b, D)) == 1, 1.0, -1.0).astype(np.float32)
    x[:, :D // 2] = np.abs(x[:, :D // 2])
    x[:, D // 2:] = -x[:, :D // 2]
    ln = (rng.integers(1, 8, size=D) / 4).astype(np.float32)
    (qq, sq), (qo, so) = grid_weight(rng, 3 * H * DH, D, bits), grid_weight(rng, D, H * DH, bits)
    sq *= 16
    (jk, jv, jks, jvs), (pk, pv, pks, pvs) = cache_pair(rng, b, H, S, DH, int8_kv)
    mask = np.zeros((b, S), np.int32)
    mask[:, : slot + 1] = 1
    mask[1, : min(slot, 4)] = 0
    kw = dict(heads=H, head_dim=DH, scale=DH**-0.5, fused_qkv=True, clip=4.0, eps=0.0)
    want = jax_attn_block(jnp.asarray(x), jnp.asarray(ln), None, jax_w(qq, bits), jax_w(qo, bits), jk, jv,
                          jnp.asarray(mask), slot=slot, slopes=alibi_slopes(H), wq_scale=jnp.asarray(sq),
                          wout_scale=jnp.asarray(so), k_scale=jks, v_scale=jvs, interpret=True, **kw)
    got = attn_block_decode(t(x), t(ln), None, port_w(qq, bits), port_w(qo, bits), pk, pv, t(mask).bool(),
                            slot=torch.tensor([slot], dtype=torch.int32), slopes=t(alibi_slopes(H)), wq_scale=t(sq),
                            wout_scale=t(so), k_scale=pks, v_scale=pvs, **kw)
    assert got[1] is pk and got[2] is pv                  # written in place
    close(got[0], want[0], KV_ATOL if int8_kv else ATOL)
    if int8_kv:
        np.testing.assert_array_equal(pk.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(pks.numpy(), np.asarray(kv_scale_layout(want[3])))
        np.testing.assert_array_equal(pvs.numpy(), np.asarray(kv_scale_layout(want[4])))
    else:
        close(pk, want[1])
        close(pv, want[2])


@pytest.mark.parametrize("bits", [8, 4])
def test_attn_block_xattn_int8_media_matches_pallas(rng, bits):
    """K3 q-only with a gate over an int8 media cache; row 1 has no valid
    key: zeros before the out-projection, so y == x there."""
    b, s = 3, 16
    x, ln, ln_b = normal(rng, b, D), normal(rng, D, scale=1.0), normal(rng, D, scale=0.1)
    (qq, sq), (qo, so) = grid_weight(rng, H * DH, D, bits), grid_weight(rng, D, H * DH, bits)
    (jk, jv, jks, jvs), (pk, pv, pks, pvs) = cache_pair(rng, b, H, s, DH, True)
    text_time = np.array([1, 0, 2])
    mask = (text_time[:, None] == np.arange(s)[None, :] // 8 + 1).astype(np.int32)
    gate = np.array([0.6], np.float32)
    kw = dict(heads=H, head_dim=DH, scale=DH**-0.5)
    want = jax_attn_block(jnp.asarray(x), jnp.asarray(ln), jnp.asarray(ln_b), jax_w(qq, bits), jax_w(qo, bits), jk,
                          jv, jnp.asarray(mask), gate=jnp.asarray(gate), wq_scale=jnp.asarray(sq),
                          wout_scale=jnp.asarray(so), k_scale=jks, v_scale=jvs, interpret=True, **kw)
    k0, ks0 = pk.clone(), pks.clone()
    got = attn_block_decode(t(x), t(ln), t(ln_b), port_w(qq, bits), port_w(qo, bits), pk, pv, t(mask).bool(),
                            gate=t(gate), wq_scale=t(sq), wout_scale=t(so), k_scale=pks, v_scale=pvs, **kw)
    close(got, want, KV_ATOL)
    assert torch.equal(got[1], t(x)[1])
    assert torch.equal(pk, k0) and torch.equal(pks, ks0)  # the media cache is read only


K6_CASES = {
    "int8_w_int8kv_gqa2_bias_gate_residual": dict(bits=8, int8_kv=True, n_rep=2, epilogue=True),
    "int4_w_int8kv_slot0": dict(bits=4, int8_kv=True, slot=0),
    "int8_w_float_cache_bias": dict(bits=8, int8_kv=False, epilogue=True),
    "int8kv_q_only_masked_row": dict(bits=8, int8_kv=True, slot=None, masked_row=True),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_attend_out_quantized_matches_pallas(rng, case):
    opt = K6_CASES[case]
    b, h, dh, s, d = 3, 4, 80, 32, 96
    bits, h_kv = opt["bits"], h // opt.get("n_rep", 1)
    slot = opt.get("slot", 12)
    q = normal(rng, b, h, dh, scale=1.0)
    (jk, jv, jks, jvs), (pk, pv, pks, pvs) = cache_pair(rng, b, h_kv, s, dh, opt["int8_kv"])
    qo, so = grid_weight(rng, d, h * dh, bits)
    mask = rng.integers(0, 2, size=(b, s)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if slot is not None:
        mask[:, slot] = 1
        kn, vn = normal(rng, b, h_kv, dh, scale=1.0), normal(rng, b, h_kv, dh, scale=1.0)
        kw_j.update(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), slot=jnp.asarray(slot, jnp.int32))
        kw_t.update(k_new=t(kn), v_new=t(vn), slot=torch.tensor([slot], dtype=torch.int32))
    if opt.get("masked_row"):
        mask[2] = 0
    if opt.get("epilogue"):
        for name, shape in (("bias", (d,)), ("gate", (1,)), ("residual", (b, d))):
            val = normal(rng, *shape)
            kw_j[name], kw_t[name] = jnp.asarray(val), t(val)
    wout_j = jnp.asarray(qo.T.reshape(h, dh, d), jnp.int8 if bits == 8 else jnp.int4)
    want = jax_attend_out(jnp.asarray(q), jk, jv, jnp.asarray(mask), wout_j, scale=dh**-0.5, wout_scale=jnp.asarray(so),
                          k_scale=jks, v_scale=jvs, interpret=True, **kw_j)
    got = attend_out_decode(t(q), pk, pv, t(mask), port_w(qo, bits), scale=dh**-0.5, wout_scale=t(so), k_scale=pks,
                            v_scale=pvs, **kw_t)
    atol = KV_ATOL if opt["int8_kv"] else ATOL
    if slot is None:
        close(got, want, atol)
        assert (got[2] == 0).all()                        # no valid key, no epilogue
        return
    close(got[0], want[0], atol)
    for mine, theirs in zip((pk, pv), want[1:3]):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    if opt["int8_kv"]:
        np.testing.assert_array_equal(pks.numpy(), np.asarray(kv_scale_layout(want[3])))
        np.testing.assert_array_equal(pvs.numpy(), np.asarray(kv_scale_layout(want[4])))


# ---------------------------------------------------------------- the slice


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)


def left_pad(spec, ids, cols):
    """Row 0 left-padded by `cols`, row 1 not (right-filled to the width)."""
    ids_p = np.concatenate([np.full((B, cols), spec["pad"], np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, cols), np.int32), np.ones_like(ids)], axis=1)
    ids_p[1] = np.concatenate([ids[1], np.full(cols, 9, np.int32)])
    mask[1] = 1
    return ids_p, mask


def gen_cfgs(spec, int8_kv):
    kw = dict(max_new_tokens=NEW, pad_token_id=spec["pad"], eos_token_id=spec["flamingo"]["eoc_token_id"],
              min_new_tokens=2, int8_kv=int8_kv)
    return JaxGenerationConfig(**kw), GenerationConfig(**kw)


def jax_step_logits(jmodel, variables, vision_x, ids, mask, stream, int8_kv, port=None):
    """JAX logits of prefill and of each decode step fed `stream`, built as
    JAX flamingo_generate builds its cache (scan layout and int8 media when
    int8_kv). With `port` (the port's model), each decode step also runs in
    the port from JAX's cache of that step, read across by
    `kv_cache_from_jax`: returns (JAX logits, the port's logits of the
    decode steps, JAX's cache after prefill)."""
    cfg = jmodel.cfg
    s = -(-(ids.shape[1] + NEW) // 16) * 16
    groups = cfg.lm.num_layers // cfg.cross_attn_every_n if cfg.scan_layers else None
    variables = jq.activate_int4_stream(variables)
    lat = jmodel.apply(variables, vision_x, method=JaxFlamingo.embed_vision)
    n_media = jax_count_media(jnp.asarray(ids), cfg.media_token_id)
    jax_prefill = jax.jit(lambda v, c: jmodel.apply(v, None, ids, mask, media_latents=lat, cache=c,
                                                    mutable=["media_kv"]))
    decode = jax.jit(lambda v, tok, c: jmodel.apply(v, lat, tok, np.ones((B, 1), np.int32), c, n_media,
                                                    method=JaxFlamingo.decode_step))
    (logits, _, cache), mv = jax_prefill(variables, JaxKVCache.create(cfg.lm, B, s, scan_groups=groups, int8=int8_kv))
    media = extract_media_kv(mv, cfg.scan_layers)
    if int8_kv:
        media = tuple(JaxLayerKV(k=kq, v=vq, k_s=kv_scale_layout(ks), v_s=kv_scale_layout(vs))
                      for (kq, ks), (vq, vs) in ((jax_quantize_kv(m.k), jax_quantize_kv(m.v)) for m in media))
    cache = cache.replace(media=media)
    out, shared, prefilled = [logits[:, -1]], [], cache
    if port is not None:
        p_lat, p_media = port.embed_vision(t(vision_x)), count_media(t(ids), cfg.media_token_id)
    for i in range(stream.shape[1] - 1):
        if port is not None:
            p_cache = kv_cache_from_jax(jax.tree.map(np.asarray, cache))
            shared.append(port.decode_step(p_lat, t(stream[:, i:i + 1]), torch.ones(B, 1, dtype=torch.long), p_cache,
                                           p_media)[0][:, 0])
        step, cache = decode(variables, stream[:, i:i + 1], cache)
        out.append(step[:, 0])
    return out if port is None else (out, shared, prefilled)


def port_step_logits(model, vision_x, ids, mask, stream, int8_kv):
    s = -(-(ids.shape[1] + NEW) // 16) * 16
    lat = model.embed_vision(t(vision_x))
    logits, cache = prefill(model, lat, t(ids), t(mask), s, int8_kv)
    assert (cache.layers[0].k.dtype == torch.int8) == int8_kv and (cache.media[0].k.dtype == torch.int8) == int8_kv
    out = [logits[:, -1]]
    n_media = count_media(t(ids), model.cfg.media_token_id)
    for i in range(stream.shape[1] - 1):
        step, cache = model.decode_step(lat, t(stream[:, i:i + 1]), torch.ones(B, 1, dtype=torch.long), cache,
                                        n_media)
        out.append(step[:, 0])
    return out


def hold_int8_caches(got, want):
    """The int8 K/V and media caches after prefill, the port's against
    JAX's: entries at most one quantization step apart, in at most 0.1% of
    them (values at a rounding boundary), and the scales within KV_ATOL
    relative (a flipped entry moves the K/V of every later layer by ~1e-2 of
    a step)."""
    diffs = []
    for mine, theirs in zip(got.layers + got.media, want.layers + want.media):
        assert mine.k.dtype == theirs.k.dtype == torch.int8
        diffs += [(mine.k.int() - theirs.k.int()).abs().flatten(), (mine.v.int() - theirs.v.int()).abs().flatten()]
        for a, b in ((mine.k_s, theirs.k_s), (mine.v_s, theirs.v_s)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=KV_ATOL, atol=0)
    diff = torch.cat(diffs)
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 1e-3 * diff.numel()


SLICE = {
    "mpt_int8": ("mpt", 8, False),
    "mpt_int4": ("mpt", 4, False),
    "mpt_int8_int8kv_scanned": ("mpt", 8, True),
    "gptneox_int8_int8kv_scanned": ("gptneox", 8, True),
}


@pytest.fixture
def streamed(monkeypatch):
    """Counts the dtypes of the weights the port's plain decode versions
    stream, and records whether generate made an int8 cache."""
    seen = {"weights": {}, "int8_cache": []}
    for module in (port_ds, port_dl):
        real = module.weight_values

        def spy(w, real=real):
            seen["weights"][w.dtype] = seen["weights"].get(w.dtype, 0) + 1
            return real(w)
        monkeypatch.setattr(module, "weight_values", spy)
    create = KVCache.create

    def spy_create(*a, int8=False, **kw):
        seen["int8_cache"].append(int8)
        return create(*a, int8=int8, **kw)
    monkeypatch.setattr(port_generation.KVCache, "create", staticmethod(spy_create))
    return seen


@pytest.mark.parametrize("case", list(SLICE))
def test_quantized_slice_matches_jax(mpt, neox, fused, streamed, case):
    """Greedy tokens exactly equal to JAX flamingo_generate (with and without
    a left-padded row) and the logits of prefill and every decode step on
    JAX's token stream within 1e-4. The int8 cache runs on the JAX
    scan_layers=True model, read into the port through from_jax; its caches
    after prefill are held by `hold_int8_caches`, each decode step from
    JAX's cache of that step, and prefill with a model-dtype cache."""
    family, bits, int8_kv = SLICE[case]
    spec, (jmodel, params, vision_x, ids) = (MPT, mpt) if family == "mpt" else (NEOX, neox)
    if int8_kv:
        params = _scan_variables(params, jmodel)
        jmodel = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    qvars = jq.quantize_decode_params(params, bits)
    tmodel = port_model(spec, params, qvars)
    jgen, pgen = gen_cfgs(spec, int8_kv)
    for cols in ((0, 3) if not int8_kv else (3,)):
        ids_p, mask = left_pad(spec, ids, cols) if cols else (ids, np.ones_like(ids))
        want = np.asarray(jax_generate(jmodel, qvars, vision_x, ids_p, mask, jgen))
        got = flamingo_generate(tmodel, t(vision_x), t(ids_p), t(mask), pgen, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    # the port streamed the quantized copies (the head int8 in int4 mode)
    # and made an int8 cache exactly when asked
    assert set(streamed["int8_cache"]) == {int8_kv}
    assert streamed["weights"].get(torch.int8, 0) > 0 and torch.float32 not in streamed["weights"]
    assert (streamed["weights"].get(torch.uint8, 0) > 0) == (bits == 4)
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
    got = port_step_logits(tmodel, vision_x, ids, mask, stream[:, :1], False)
    close(got[0], want[0], LOGITS_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_quantized_decode_equals_unquantized(mpt, fused, bits):
    """On dequant(quant(w)) weights, streaming the quantized copies gives the
    tokens of streaming the weights themselves (JAX tests/test_quantize.py
    test_generate_int8_matches_roundtripped_bf16)."""
    _, params, vision_x, ids = mpt
    model = tq.dequantize_roundtrip(port_model(MPT, params), bits)
    _, gen = gen_cfgs(MPT, False)
    want = flamingo_generate(model, t(vision_x), t(ids), t(np.ones_like(ids)), gen, device="cpu")
    got = flamingo_generate(tq.quantize_decode_weights(model, bits), t(vision_x), t(ids), t(np.ones_like(ids)), gen,
                            device="cpu")
    assert torch.equal(got, want)
