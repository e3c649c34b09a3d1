"""The port's ViT kernels K9 (`ops.vit_attention`) and K10 (`ops.layer_norm`)
against the JAX package on the CPU, with the JAX kernels in Pallas
interpret mode.

  * the plain versions against JAX `vit_attention` (the JAX test's cases and
    a ragged S 17 at Dh 64) and JAX `layer_norm` (with and without bias, a
    row whose fast variance cancels below 0), fp32 and bf16;
  * the gradients of `LayerNormFn` and `VitAttentionFn` against `jax.grad`
    through `layer_norm_vjp` and the `vit_attention` custom_vjp;
  * the JAX test's tiny ViT (`tests/test_layer_norm_kernel.py`) with weights
    carried by `convert.from_jax`: the port's forward under the `FORCE`
    hooks against the hooks off, and both against JAX with its hooks forced;
  * the slice: a tiny OF-3B-shaped Flamingo with the ViT hooks forced in
    both packages (ViT S 17, Dh 16), greedy tokens exactly equal to JAX
    `flamingo_generate`, prefill's and every decode step's logits, and one
    train step's losses, gradients and parameters against JAX
    `make_train_step`, the method of tests/test_torch_train.py;
  * routing: CPU tensors take the plain path unless `FORCE`, `DISABLE` wins
    over `FORCE`.

On CPU tensors the wrappers run their plain versions, so the port's side of
every case is the plain PyTorch code the card's kernels are held to.
Tolerances: fp32 2e-5 for one kernel (the JAX tests' own; the two packages
sum in different orders), 3e-5 for the gradients and the ViT (the JAX
tests' own); bf16: equal after the cast, or one bf16 ulp of the output apart
where a different summation order flips a rounding; the slice as
tests/test_torch_generate.py (logits 2e-5 / 1e-5) and
tests/test_torch_train.py (loss 1e-5, gradients and parameters 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_flamingo_tpu.ops.layer_norm as jax_ln
import open_flamingo_tpu.ops.vit_attention as jax_va
import open_flamingo_tpu_torch.models.vit as port_vit
import open_flamingo_tpu_torch.ops.layer_norm as port_ln
import open_flamingo_tpu_torch.ops.vit_attention as port_va
from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.flamingo import count_media as jax_count_media
from open_flamingo_tpu.models.lm import extract_media_kv
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models.decoders.common import KVCache
from open_flamingo_tpu_torch.models.flamingo import Flamingo, count_media
from open_flamingo_tpu_torch.models.vit import VisionTransformer

from test_torch_train import FLAMINGO, LM, compare, jax_run, make_batches, port_run, set_gates

ATOL = 2e-5          # one kernel, fp32
GRAD_ATOL = 3e-5     # gradients and the tiny ViT
LOGITS_ATOL, LOGITS_RTOL = 2e-5, 1e-5
MEDIA, EOC, PAD = FLAMINGO["media_token_id"], FLAMINGO["eoc_token_id"], 1
# ViT S = 4 * 4 + 1 = 17 (ragged, as ViT-L/14's 257), Dh 16, widths that the card kernels take
VIS = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
B, T_IMG, T_TXT, NEW = 2, 2, 10, 6


def t(a):
    return torch.from_numpy(np.array(a))


def bf16_close(got, want):
    """bf16 results (as fp32 arrays) equal, or one bf16 ulp of `want` apart
    (8 significant bits; results 0 in `want` must be 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny))) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), f"{bad.sum()} entries more than one bf16 ulp apart, max {np.abs(got - want).max()}"


@pytest.fixture
def hooks(monkeypatch):
    """Both packages' ViT hooks on: JAX's kernels in Pallas interpret mode,
    the port's wrappers on CPU tensors. Counts the calls each package's ViT
    makes (JAX's at trace time)."""
    calls = {"jax_attn": 0, "jax_ln": 0, "port_attn": 0, "port_ln": 0}
    for module in (jax_ln, jax_va):
        monkeypatch.setattr(module, "FORCE", True)
        monkeypatch.setattr(module, "INTERPRET", True)
    for module in (port_ln, port_va):
        monkeypatch.setattr(module, "FORCE", True)

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(jax_va, "vit_attention", "jax_attn")
    counted(jax_ln, "layer_norm_vjp", "jax_ln")
    counted(port_vit, "vit_attention_heads", "port_attn")
    counted(port_vit, "layer_norm", "port_ln")
    return calls


# ---------------------------------------------------------------- K9


@pytest.mark.parametrize("bh,s,d", [(8, 27, 16), (4, 24, 16), (16, 16, 32), (6, 17, 64)])
def test_vit_attention_plain_matches_jax(rng, bh, s, d):
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3))
    want = jax_va.vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5, 4, True)
    got = port_va.vit_attention(t(q), t(k), t(v), d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    torch.testing.assert_close(port_va.reference_vit_attention(t(q), t(k), t(v), d**-0.5), got, atol=0, rtol=0)
    # bf16 operands, cast from the same fp32 values on both sides
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_va.vit_attention(qb, kb, vb, d**-0.5, 4, True)
    got = port_va.vit_attention(*(t(x).to(torch.bfloat16) for x in (q, k, v)), d**-0.5)
    assert got.dtype == torch.bfloat16
    bf16_close(got.float().numpy(), np.asarray(want, np.float32))


def test_vit_attention_heads_layout(rng):
    """(B, S, H, Dh) strided views of a (B, S, H*Dh) projection give the
    (BH, S, Dh) result, rearranged."""
    b, s, h, d = 2, 17, 4, 16
    q, k, v = (t(rng.normal(size=(b, s, h * d)).astype(np.float32)).view(b, s, h, d) for _ in range(3))
    got = port_va.vit_attention_heads(q, k, v, d**-0.5)

    def flat(x):
        return x.transpose(1, 2).reshape(b * h, s, d)
    want = port_va.vit_attention(flat(q), flat(k), flat(v), d**-0.5).view(b, h, s, d).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert got.shape == (b, s, h, d)


# ---------------------------------------------------------------- K10

# NO_BIAS_NOTE: JAX `layer_norm(x, scale, None)` raises in Pallas interpret
# mode (`_ln_kernel` takes a bias ref that the call does not pass when
# has_bias is False). The JAX ViT always has a bias, so its path is not
# affected; the no-bias cases compare with the JAX package's `_reference_ln`.


def ln_inputs(rng, m, d):
    x = (rng.normal(size=(m, d)) * 2 + 1).astype(np.float32)
    # row 0: a constant 1000.078125, whose fast variance E[x^2] - E[x]^2
    # cancels below -eps in fp32: only the clamp at 0 keeps it finite
    x[0] = 1000.078125
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_jax(rng, with_bias, dtype):
    m, d = 24, 64
    x, scale, bias = ln_inputs(rng, m, d)
    x32 = t(x)
    raw_var = (x32.square().mean(-1) - x32.mean(-1).square())[0].item()
    assert raw_var < -1e-5, raw_var
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, js = jnp.asarray(x, jdt), jnp.asarray(scale, jdt)
    if with_bias:
        want = jax_ln.layer_norm(jx, js, jnp.asarray(bias, jdt), eps=1e-5, block_m=8, interpret=True)
    else:   # the JAX kernel fails without a bias (NO_BIAS_NOTE): its reference formula
        want = jax_ln._reference_ln(jx, js, None, 1e-5)
    want = np.asarray(want, np.float32)
    got = port_ln.layer_norm(t(x).to(tdt), t(scale).to(tdt), t(bias).to(tdt) if with_bias else None, 1e-5)
    assert got.dtype == tdt
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        bf16_close(got, want)


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_fn_gradients_match_jax(rng, monkeypatch, with_bias):
    monkeypatch.setattr(jax_ln, "INTERPRET", True)
    x = (rng.normal(size=(16, 32))).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(32,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    args = [jnp.asarray(x), jnp.asarray(scale)] + ([jnp.asarray(bias)] if with_bias else [])

    def loss(x, s, b=None):
        if b is None:   # the JAX kernel fails without a bias (NO_BIAS_NOTE): its reference formula
            return jnp.sum(jax_ln._reference_ln(x, s, None, 1e-5) ** 2)
        return jnp.sum(jax_ln.layer_norm_vjp(x, s, b, 1e-5, 8) ** 2)
    want = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    tensors = [t(a).requires_grad_(True) for a in args]
    y = port_ln.layer_norm(tensors[0], tensors[1], tensors[2] if with_bias else None, 1e-5)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    (y**2).sum().backward()
    for got, w in zip(tensors, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)


def test_vit_attention_fn_gradients_match_jax(rng):
    bh, s, d = 4, 12, 16
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3))

    def loss(q, k, v):
        return jnp.sum(jax_va.vit_attention(q, k, v, 0.5, 4, True) ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tensors = [t(a).requires_grad_(True) for a in (q, k, v)]
    y4 = port_va.vit_attention_heads(*(x[:, :, None] for x in tensors), 0.5)
    assert type(y4.grad_fn).__name__ == "VitAttentionFnBackward"
    (y4[:, :, 0] ** 2).sum().backward()
    for got, w in zip(tensors, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)


# ---------------------------------------------------------------- one ViT


def test_tiny_vit_both_routes_match_jax(rng, hooks, monkeypatch):
    """The JAX test's tiny ViT (image 28, patch 7: S 17; 4 heads of Dh 16)."""
    cfg = dict(image_size=28, patch_size=7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    jvit = JaxVisionTransformer(cfg=JaxVisionConfig(**cfg))
    x = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    params = jvit.init(jax.random.PRNGKey(0), jnp.asarray(x))
    hooks.update(jax_attn=0, jax_ln=0)
    want = np.asarray(jax.jit(jvit.apply)(params, jnp.asarray(x)))     # hooks forced, interpret
    assert hooks["jax_attn"] == 2 and hooks["jax_ln"] == 4
    vit = VisionTransformer(VisionConfig(**cfg), device="cpu")
    vit.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = vit(t(x))
        assert hooks["port_attn"] == 2 and hooks["port_ln"] == 4
        monkeypatch.setattr(port_va, "FORCE", False)      # the hooks off
        monkeypatch.setattr(port_ln, "FORCE", False)
        plain = vit(t(x))
        assert hooks["port_attn"] == 2 and hooks["port_ln"] == 4
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=GRAD_ATOL, rtol=0)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jcfg = JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**LM), **FLAMINGO)
    jmodel = JaxFlamingo(cfg=jcfg)
    vision_x = rng.normal(size=(B, T_IMG, 1, 28, 28, 3)).astype(np.float32)
    ids = rng.integers(7, LM["vocab_size"], size=(B, T_TXT)).astype(np.int32)
    ids[:, 0] = MEDIA
    ids[:, 4] = MEDIA
    params = set_gates(jax.jit(jmodel.init)(jax.random.PRNGKey(0), vision_x, ids, np.ones_like(ids)))
    return jmodel, params, vision_x, ids


def port_model(params):
    tcfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO)
    model = Flamingo(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


def test_greedy_tokens_and_step_logits_match_jax(models, hooks):
    jmodel, params, vision_x, ids = models
    tmodel = port_model(params)
    layers = VIS["num_layers"]
    # row 0 left-padded by 3
    ids_p = np.concatenate([np.full((B, 3), PAD, np.int32), ids], axis=1)
    mask = np.concatenate([np.zeros((B, 3), np.int32), np.ones_like(ids)], axis=1)
    ids_p[1], mask[1] = np.concatenate([ids[1], np.full(3, 9, np.int32)]), 1
    want = jax_generate(jmodel, params, vision_x, ids_p, mask, JaxGenerationConfig(
        max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2))
    got = flamingo_generate(tmodel, t(vision_x), t(ids_p), t(mask), GenerationConfig(
        max_new_tokens=NEW, pad_token_id=PAD, eos_token_id=EOC, min_new_tokens=2), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert hooks["jax_attn"] == layers and hooks["jax_ln"] == 2 * layers
    assert hooks["port_attn"] == layers and hooks["port_ln"] == 2 * layers      # the vision encoded once

    # latents, prefill's last logits and every decode step's on JAX's greedy stream
    mask = np.ones_like(ids)
    s = -(-(T_TXT + NEW) // 16) * 16
    jlat = jax.jit(lambda p, x: jmodel.apply(p, x, method=JaxFlamingo.embed_vision))(params, vision_x)
    prefill = jax.jit(lambda p, c: jmodel.apply(p, None, ids, mask, media_latents=jlat, cache=c,
                                                mutable=["media_kv"]))
    decode = jax.jit(lambda p, tok, c: jmodel.apply(p, jlat, tok, np.ones((B, 1), np.int32), c, n_media,
                                                    method=JaxFlamingo.decode_step))
    (logits, _, cache), variables = prefill(params, JaxKVCache.create(jmodel.cfg.lm, B, s))
    cache = cache.replace(media=extract_media_kv(variables, False))
    n_media = jax_count_media(jnp.asarray(ids), MEDIA)
    want = [logits[:, -1]]
    stream = np.zeros((B, NEW), np.int32)
    for i in range(NEW - 1):
        stream[:, i] = np.argmax(np.asarray(want[-1]), axis=-1)
        step, cache = decode(params, stream[:, i:i + 1], cache)
        want.append(step[:, 0])

    with torch.no_grad():
        ids_t = t(ids)
        tlat = tmodel.embed_vision(t(vision_x))
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
        logits_t, _, tcache = tmodel(None, ids_t, torch.ones_like(ids_t), media_latents=tlat,
                                     cache=KVCache.create(tmodel.cfg.lm, B, s, torch.float32, "cpu"))
        got = [logits_t[:, -1]]
        t_media = count_media(ids_t, MEDIA)
        for i in range(NEW - 1):
            step, tcache = tmodel.decode_step(tlat, t(stream[:, i:i + 1]), torch.ones(B, 1, dtype=torch.long),
                                              tcache, t_media)
            got.append(step[:, 0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGITS_ATOL, rtol=LOGITS_RTOL)


def test_train_step_matches_jax(models, hooks):
    """One step of both packages' `make_train_step` with the ViT hooks forced:
    the LAION and MMC4 batches of tests/test_torch_train.py at this ViT's
    image size. The ViT is frozen, so K9/K10 run forward only."""
    jmodel, params, _, _ = models
    rng = np.random.default_rng(1)
    bl, bm = make_batches(rng)
    for batch in (bl, bm):
        shape = batch["vision_x"].shape[:3] + (28, 28, 3)
        batch["vision_x"] = rng.normal(size=shape).astype(np.float32)
    jax_result = jax_run(jmodel, params, bl, bm, 1)
    assert hooks["jax_attn"] and hooks["jax_ln"]
    port_result = port_run(port_model(params), bl, bm, 1)
    # two ViT forwards (LAION, MMC4) per step
    assert hooks["port_attn"] == 2 * VIS["num_layers"] and hooks["port_ln"] == 4 * VIS["num_layers"]
    compare(jax_result, port_result)


# ---------------------------------------------------------------- routing


def test_routing_hooks(monkeypatch):
    cpu = torch.empty(1)
    for module, use in ((port_ln, port_ln.use_ln_kernel), (port_va, port_va.use_vit_kernel)):
        assert not use(cpu)
        monkeypatch.setattr(module, "FORCE", True)
        assert use(cpu)
        monkeypatch.setattr(module, "DISABLE", True)
        assert not use(cpu)                       # DISABLE wins over FORCE
        monkeypatch.setattr(module, "FORCE", False)
        assert not use(cpu)


def test_wrappers_refuse_unsupported_shapes():
    """Inputs the CUDA kernels do not take raise before any launch (the
    checks run for CUDA tensors only; they are called directly here)."""
    x = torch.zeros(4, 20)
    with pytest.raises(ValueError, match="multiple of 8"):
        port_ln._check(x, torch.ones(20), None)
    with pytest.raises(ValueError, match="scale"):
        port_ln._check(torch.zeros(4, 16), torch.ones(8), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port_ln._check(torch.zeros(4, 16, dtype=torch.float16), torch.ones(16, dtype=torch.float16), None)
    q = torch.zeros(1, 17, 2, 48)
    with pytest.raises(ValueError, match="Dh"):
        port_va._check(q, q, q)
    q = torch.zeros(1, 273, 2, 64)
    with pytest.raises(ValueError, match="S in"):
        port_va._check(q, q, q)
    with pytest.raises(TypeError, match="share dtype"):
        port_va._check(torch.zeros(1, 17, 2, 64), torch.zeros(1, 17, 2, 64, dtype=torch.bfloat16),
                       torch.zeros(1, 17, 2, 64))


# ---------------------------------------------------------------- what the kernel takes

# (B, S, H, Dh) at the edges of what csrc/vit_attention.cu takes: S 1..272, Dh 16/32/64, up to 65,535
# (image, head) instances a launch
ACCEPTED = {"S1_Dh16": (1, 1, 1, 16), "S272_Dh32": (2, 272, 3, 32), "S257_Dh64": (8, 257, 16, 64),
            "instances_65535": (4369, 1, 15, 16)}
REFUSED = {"S273": ((1, 273, 2, 64), "S in"), "Dh48": ((1, 17, 2, 48), "Dh"), "Dh128": ((1, 17, 2, 128), "Dh"),
           "Dh8": ((1, 17, 2, 8), "Dh"), "instances_65536": ((4096, 1, 16, 16), "instances")}


@pytest.mark.parametrize("case", list(ACCEPTED))
def test_wrapper_takes_the_kernels_edges(case):
    q = torch.zeros(ACCEPTED[case])
    port_va._check(q, q, q)


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Refused in Python, with a message, before any launch (the C entry
    refuses the same shapes with a CUDA error)."""
    shape, match = REFUSED[case]
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        port_va._check(q, q, q)
