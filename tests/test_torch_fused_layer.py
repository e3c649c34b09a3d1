"""K11 `fused_layer_decode` (a whole decode layer in one launch) in the port
against the JAX package on the CPU.

  * `reference_fused_layer`, the plain version the wrapper runs on CPU
    tensors, against JAX `fused_layer_decode(..., interpret=True)` on the
    same numpy inputs: the MPT form with ALiBi + clip 6.0 and with neither,
    the gated cross-attention form with an all-masked row, int8 and packed
    int4 weights, and SwiGLU with b1/b2 (the kernel computes it; JAX has no
    caller for it). fp32, atol 3e-5 for y and 1e-6 for the written caches:
    JAX's own bounds for this kernel (tests/test_fused_layer.py).
  * in fp32 the plain version equals K3 then K2 (`reference_attn_block` ->
    `reference_mlp`) bit for bit; in bf16 it keeps x2 in fp32 where K3
    rounds it;
  * the wrapper's refusals: layer_idx, an int8 cache, autograd, weights of
    mixed stored types;
  * a tiny OF-3B-like model (MPT with ALiBi and clip_qkv, gated
    cross-attention before every layer): greedy tokens exactly equal to JAX
    `flamingo_generate`, and prefill's and every decode step's logits within
    1e-4, with `fused_layer.DISABLE = False` and, separately, `XATTN_ONLY =
    True` in both packages (JAX `FORCE_FUSED` + `INTERPRET`, the port's
    `FORCE_FUSED`); spies count the port's K11 route (2 x layers x steps, or
    layers x steps) and its K3 + K2 route;
  * the int8-KV steps and the absorbing steps keep K3 + K2.
The model's weights cross over through `convert/from_jax.py`; the kernel
cases hand the same numpy arrays to both packages in their own layouts (JAX
(K, N), the port's nn.Linear (N, K); int4 as jnp.int4 and `pack_int4`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_decode import B as MB
from test_torch_fused_decode import GEN, JAX_GEN, MEDIA, NEW, T_TXT, close, left_pad, models, port_generate  # noqa: F401

from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import alibi_slopes
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import count_media as jax_count_media
from open_flamingo_tpu.models.lm import extract_media_kv
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops import fused_layer as jax_fl
from open_flamingo_tpu.ops.fused_layer import fused_layer_decode as jax_fused_layer
from open_flamingo_tpu_torch import configs
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models import xattn as port_xattn
from open_flamingo_tpu_torch.models.absorb_vit import make_plan
from open_flamingo_tpu_torch.models.decoders import mpt as port_mpt
from open_flamingo_tpu_torch.models.decoders.common import KVCache
from open_flamingo_tpu_torch.models.flamingo import count_media, init_random
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops import fused_layer as port_fl
from open_flamingo_tpu_torch.ops.decode_layer import reference_attn_block
from open_flamingo_tpu_torch.ops.dense_stream import reference_mlp
from open_flamingo_tpu_torch.ops.fused_layer import fused_layer_decode, reference_fused_layer
from open_flamingo_tpu_torch.quantize import pack_int4

B, D, H, DH, S, K2, SLOT = 4, 64, 4, 16, 32, 128, 5
Y_ATOL, KV_ATOL = 3e-5, 1e-6


def normal(rng, *shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def weight(rng, n, k, bits):
    """An (N, K) weight as (the port's operand, JAX's (K, N) operand, its
    (N,) scale or None): fp32, or on the int8 / int4 grid."""
    if bits is None:
        w = normal(rng, n, k)
        return torch.tensor(w), jnp.asarray(w.T), None
    qmax = 127 if bits == 8 else 7
    q = rng.integers(-qmax, qmax + 1, size=(n, k)).astype(np.int8)
    s = (2.0 ** rng.integers(-12, -9, size=n) * (16 if bits == 4 else 1)).astype(np.float32)
    port = torch.tensor(q) if bits == 8 else pack_int4(torch.tensor(q))
    return port, jnp.asarray(q.T, jnp.int8 if bits == 8 else jnp.int4), s


def layer_case(rng, *, fused_qkv, bits=None, alibi=False, clip=None, swiglu=False, biases=False, act="gelu"):
    """One layer's operands: (positional, keyword) for the port and for JAX,
    each from the same numpy arrays."""
    inner = H * DH
    x = normal(rng, B, D, scale=1.0)
    ln1s, ln1b, ln2s, ln2b = normal(rng, D, scale=1.0) + 1, normal(rng, D), normal(rng, D, scale=1.0) + 1, normal(rng, D)
    shapes = dict(wq=((3 if fused_qkv else 1) * inner, D), wout=(D, inner), w1=(K2, D), w2=(D, K2))
    if swiglu:
        shapes["w1_gate"] = (K2, D)
    ws = {name: weight(rng, n, k, bits) for name, (n, k) in shapes.items()}
    kc, vc = normal(rng, B, H, S, DH, scale=1.0), normal(rng, B, H, S, DH, scale=1.0)
    mask = np.ones((B, S), np.int32)
    if fused_qkv:
        mask[:, SLOT + 1:] = 0       # slots not written yet
        mask[1, :2] = 0              # a left-padded row
    else:
        mask[0] = 0                  # text before any image: exact zeros before the out-projection
    opts = dict(heads=H, head_dim=DH, scale=DH**-0.5, act=act, fused_qkv=fused_qkv, clip=clip, eps=1e-5)
    vecs = {}
    if not fused_qkv:
        vecs.update(gate=np.array([0.7], np.float32), gate2=np.array([-0.3], np.float32))
    if biases:
        vecs.update(b1=normal(rng, K2), b2=normal(rng, D))
    scales = {f"{name}_scale": s for name, (_, _, s) in ws.items() if s is not None}
    port = ([torch.tensor(a) for a in (x, ln1s, ln1b)] + [ws["wq"][0], ws["wout"][0]]
            + [torch.tensor(kc), torch.tensor(vc), torch.tensor(mask).bool(), ws["w1"][0], ws["w2"][0]]
            + [torch.tensor(ln2s), torch.tensor(ln2b)])
    port_kw = dict(opts, **{k: torch.tensor(v) for k, v in {**vecs, **scales}.items()})
    jax_args = ([jnp.asarray(a) for a in (x, ln1s, ln1b)] + [ws["wq"][1], ws["wout"][1]]
                + [jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mask), ws["w1"][1], ws["w2"][1]]
                + [jnp.asarray(ln2s), jnp.asarray(ln2b)])
    jax_kw = dict(opts, block_k2=64, interpret=True, **{k: jnp.asarray(v) for k, v in {**vecs, **scales}.items()})
    if swiglu:
        port_kw["w1_gate"], jax_kw["w1_gate"] = ws["w1_gate"][0], ws["w1_gate"][1]
    if fused_qkv:
        port_kw["slot"], jax_kw["slot"] = torch.tensor([SLOT], dtype=torch.int32), jnp.int32(SLOT)
    if alibi:
        port_kw["slopes"], jax_kw["slopes"] = torch.from_numpy(alibi_slopes(H)), alibi_slopes(H)
    return port, port_kw, jax_args, jax_kw


def check_against_jax(port, port_kw, jax_args, jax_kw):
    want = jax_fused_layer(*jax_args, **jax_kw)
    got = reference_fused_layer(*port, **port_kw)
    if port_kw["fused_qkv"]:
        (got, got_k, got_v), (want, want_k, want_v) = got, want
        close(got_k, want_k, KV_ATOL)
        close(got_v, want_v, KV_ATOL)
    close(got, want, Y_ATOL)
    return got


@pytest.mark.parametrize("alibi,clip", [(True, 6.0), (False, None)])
def test_mpt_form_matches_jax(rng, alibi, clip):
    check_against_jax(*layer_case(rng, fused_qkv=True, alibi=alibi, clip=clip))


def test_gated_xattn_form_matches_jax(rng):
    port, port_kw, *jax_case = layer_case(rng, fused_qkv=False, biases=True)
    got = check_against_jax(port, port_kw, *jax_case)
    # the all-masked row attends to nothing: x2 = x there, and y is x plus its FF alone
    x0 = port[0][0:1]
    want0 = reference_mlp(x0, port[8], port[9], ln_scale=port[10], ln_bias=port[11], b1=port_kw["b1"],
                          b2=port_kw["b2"], residual=x0, gate=port_kw["gate2"])
    close(got[0:1], want0.numpy(), 1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_match_jax(rng, bits):
    check_against_jax(*layer_case(rng, fused_qkv=True, bits=bits, alibi=True, clip=6.0))


def test_swiglu_with_biases_matches_jax(rng):
    check_against_jax(*layer_case(rng, fused_qkv=True, alibi=True, swiglu=True, biases=True, act="silu"))


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_fp32_equals_k3_then_k2_and_bf16_keeps_x2_fp32(rng, fused_qkv):
    port, kw, _, _ = layer_case(rng, fused_qkv=fused_qkv, alibi=fused_qkv, biases=True)

    def run(dtype, fused):
        """(y, k cache, v cache) of one layer in `dtype`: K11's plain version,
        or K3's then K2's."""
        x, ln1s, ln1b, wq, wout, kc, vc, mask, w1, w2, ln2s, ln2b = (
            t if t.dtype == torch.bool else t.to(dtype) for t in port)
        o = {k: v.to(dtype) if isinstance(v, torch.Tensor) and k not in ("slot", "slopes") else v
             for k, v in kw.items()}
        if fused:
            y = reference_fused_layer(x, ln1s, ln1b, wq, wout, kc, vc, mask, w1, w2, ln2s, ln2b, **o)
        else:
            attn = {k: v for k, v in o.items() if k not in ("act", "gate2", "b1", "b2")}
            x2 = reference_attn_block(x, ln1s, ln1b, wq, wout, kc, vc, mask, **attn)
            x2 = x2[0] if fused_qkv else x2
            y = reference_mlp(x2, w1, w2, b1=o["b1"], b2=o["b2"], ln_scale=ln2s, ln_bias=ln2b, act="gelu",
                              residual=x2, gate=o.get("gate2"))
        return (y[0] if fused and fused_qkv else y), kc, vc

    one, two = run(torch.float32, True), run(torch.float32, False)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    # bf16: K3 rounds x2 to bf16 before LN2 and the last residual, K11 does not
    y1, y2 = run(torch.bfloat16, True)[0], run(torch.bfloat16, False)[0]
    assert not torch.equal(y1, y2)
    torch.testing.assert_close(y1.float(), y2.float(), atol=5e-2, rtol=2e-2)


def test_refusals(rng):
    port, kw, _, _ = layer_case(rng, fused_qkv=True, alibi=True)
    with pytest.raises(ValueError, match="layer_idx"):
        fused_layer_decode(*port, layer_idx=0, **kw)
    int8 = list(port)
    int8[5], int8[6] = port[5].to(torch.int8), port[6].to(torch.int8)
    with pytest.raises(TypeError, match="int8 cache"):
        fused_layer_decode(*int8, **kw)
    with pytest.raises(TypeError, match="int8 cache"):
        reference_fused_layer(*int8, **kw)
    grad = list(port)
    grad[3] = port[3].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_layer_decode(*grad, **kw)
    mixed = list(port)
    mixed[8] = port[8].to(torch.int8)
    with pytest.raises(ValueError):
        fused_layer_decode(*mixed, **dict(kw, w1_scale=torch.ones(K2)))
    bad_mask = list(port)
    bad_mask[7] = port[7][:, :-1]
    with pytest.raises(ValueError, match="mask"):
        fused_layer_decode(*bad_mask, **kw)
    with torch.no_grad():                                      # the wrapper runs the plain version on CPU tensors
        got = fused_layer_decode(*[t.clone() for t in port], **kw)[0]
    torch.testing.assert_close(got, reference_fused_layer(*[t.clone() for t in port], **kw)[0], atol=0, rtol=0)


# ---------------------------------------------------------------- the slice

FORMS = {"fused_layer": ("DISABLE", False), "xattn_only": ("XATTN_ONLY", True)}


@pytest.fixture(params=list(FORMS))
def layer_route(request, monkeypatch):
    """Both packages on the fused decode route with the K11 form `param`;
    counts the port's K11 calls and its K3 / K2 calls."""
    hook, value = FORMS[request.param]
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(jax_fl, hook, value)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(port_fl, hook, value)
    calls = {"form": request.param, "K11": 0, "K3": 0, "K2": 0, "jax_K11": 0}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(jax_fl, "fused_layer_decode", "jax_K11")     # JAX's callers look it up at call time
    for module in (port_mpt, port_xattn):
        counted(module, "reference_fused_layer", "K11")
        counted(module, "reference_attn_block", "K3")
        counted(module, "reference_mlp", "K2")
    return calls


def expected_calls(form, layers, steps):
    """K11 / K3 / K2 calls of `steps` decode steps of a model with a gated
    cross-attention block before each of its `layers` MPT blocks."""
    k11 = (2 if form == "fused_layer" else 1) * layers * steps
    rest = 2 * layers * steps - k11
    return {"K11": k11, "K3": rest, "K2": rest}


def counts(calls):
    return {k: calls[k] for k in ("K11", "K3", "K2")}


@pytest.mark.parametrize("pad_cols", [0, 3])
def test_greedy_tokens_equal_jax(models, layer_route, pad_cols):
    jmodel, params, tmodel, vision_x, ids = models
    ids, mask = left_pad(ids, pad_cols)
    want = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, JAX_GEN))
    got = port_generate(tmodel, vision_x, ids, mask)
    assert counts(layer_route) == expected_calls(layer_route["form"], tmodel.cfg.lm.num_layers, NEW - 1)
    assert layer_route["jax_K11"] > 0
    np.testing.assert_array_equal(got, want)


def test_step_logits_match_jax(models, layer_route):
    """Prefill's last position, then every decode step fed one token stream
    (JAX's greedy one)."""
    jmodel, params, tmodel, vision_x, ids = models
    mask = np.ones_like(ids)
    s = -(-(T_TXT + NEW) // 16) * 16
    stream = np.zeros((MB, NEW), np.int32)

    lat = jmodel.apply(params, vision_x, method=JaxFlamingo.embed_vision)
    (logits, _, cache), variables = jmodel.apply(
        params, None, ids, mask, media_latents=lat, cache=JaxKVCache.create(jmodel.cfg.lm, MB, s),
        mutable=["media_kv"])
    cache = cache.replace(media=extract_media_kv(variables, False))
    n_media = jax_count_media(jnp.asarray(ids), MEDIA)
    want = [logits[:, -1]]
    for i in range(NEW - 1):
        stream[:, i] = np.argmax(np.asarray(want[-1]), axis=-1)
        step, cache = jmodel.apply(params, lat, stream[:, i:i + 1], np.ones((MB, 1), np.int32), cache, n_media,
                                   method=JaxFlamingo.decode_step)
        want.append(step[:, 0])

    ids_t = torch.from_numpy(ids)
    tlat = tmodel.embed_vision(torch.from_numpy(vision_x))
    logits_t, _, tcache = tmodel(None, ids_t, torch.ones_like(ids_t), media_latents=tlat,
                                 cache=KVCache.create(tmodel.cfg.lm, MB, s, torch.float32, "cpu"))
    got = [logits_t[:, -1]]
    t_media = count_media(ids_t, MEDIA)
    with torch.no_grad():
        for i in range(NEW - 1):
            step, tcache = tmodel.decode_step(tlat, torch.from_numpy(stream[:, i:i + 1]),
                                              torch.ones(MB, 1, dtype=torch.long), tcache, t_media)
            got.append(step[:, 0])
    assert counts(layer_route) == expected_calls(layer_route["form"], tmodel.cfg.lm.num_layers, NEW - 1)
    for g, w in zip(got, want):
        close(g, w, 1e-4)


def test_int8_kv_steps_keep_k3_and_k2(models, layer_route):
    """Over an int8 K/V and media cache every block runs K3 + K2 (K11 has no
    cache-scale operand; JAX's callers check `not kv.int8`)."""
    _, _, tmodel, vision_x, ids = models
    mask = np.ones_like(ids)
    cfg = dataclasses.replace(GEN, int8_kv=True)
    flamingo_generate(tmodel, torch.from_numpy(vision_x), torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                      device="cpu")
    steps, layers = NEW - 1, tmodel.cfg.lm.num_layers
    assert counts(layer_route) == {"K11": 0, "K3": 2 * layers * steps, "K2": 2 * layers * steps}


# the absorbing geometry of tests/test_torch_absorb_vit.py (its plan carries the
# next batch's 2 ViT layers on the first decode steps)
ABSORB_VIS = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
ABSORB_LM = dict(family="mpt", vocab_size=128, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
                 alibi=True, attention_bias=False, ln_no_bias=True)


def test_absorbing_steps_keep_k3_and_k2(layer_route):
    """An absorbing decode step (a side hook on every block) runs K3 + K2,
    as JAX's callers check `hook is None`; the steps after it take K11, and
    the tokens are those of the call with K11 off (fp32: the same sums)."""
    cfg = configs.FlamingoConfig(vision=configs.VisionConfig(**ABSORB_VIS), lm=configs.DecoderConfig(**ABSORB_LM),
                                 media_token_id=3, eoc_token_id=4, cross_attn_every_n=1, num_vis_latents=4,
                                 perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8)
    model = init_random(cfg, 0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    b, new = 2, 8
    vision_x = torch.from_numpy(rng.normal(size=(b, 1, 1, 16, 16, 3)).astype(np.float32))
    next_px = torch.from_numpy(rng.normal(size=(b, 1, 1, 16, 16, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(7, 128, size=(b, 6)))
    ids[:, 0] = 3
    mask = torch.ones_like(ids)
    gcfg = GenerationConfig(max_new_tokens=new, pad_token_id=0, eos_token_id=-1)
    plan = make_plan(cfg, next_px.shape[:3], new)
    steps = max(new - 1, plan.n_steps)
    assert 0 < plan.n_steps < steps
    tokens, _ = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device="cpu")
    want = expected_calls(layer_route["form"], cfg.lm.num_layers, steps - plan.n_steps)
    absorbing = 2 * cfg.lm.num_layers * plan.n_steps
    assert counts(layer_route) == {"K11": want["K11"], "K3": want["K3"] + absorbing, "K2": want["K2"] + absorbing}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_fl, "DISABLE", True)
        mp.setattr(port_fl, "XATTN_ONLY", False)
        plain, _ = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device="cpu")
    assert torch.equal(tokens, plain)
