"""The port's `speculative_generate` against the JAX package's on the CPU:
the same tokens (exactly JAX `flamingo_generate`'s greedy tokens, whatever
the draft proposes) and the same number of draft + verify iterations, for
the cases of tests/test_speculative.py: a random draft at gamma 1 / 2 / 4,
full acceptance (draft = target), EOS with a left-padded row,
min_new_tokens, a JAX `scan_layers=True` target, `return_stats` with
`media_latents`, and D 7 (an 8-token verify window, where the card's
verify takes K4 / K5).

Weights from the JAX init through `convert/from_jax.py`, the xattn gates at
0.5 (the tiny MPT of JAX tests/test_quantize.py `_tiny_family_model`, B 2,
T 6; the draft its own init). Every case makes 8 new tokens (D 7's 12), so
JAX compiles each of its calls once. The port runs each case on its einsum route and on the fused decode
route (`ops.dense_stream.FORCE_FUSED`: the draft's single-token steps
through K1-K3's plain versions, which write at the cache's device `slot`,
so a rollback that left `slot` behind `index` would show); JAX on its
einsum route.
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
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.speculative import speculative_generate as jax_speculative
from open_flamingo_tpu_torch import speculative as port_spec
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.generation import GenerationConfig
from open_flamingo_tpu_torch.models.flamingo import Flamingo
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.speculative import speculative_generate


def gates(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.full_like(p, 0.5) if "gate" in jax.tree_util.keystr(path) else p, params)


def port_cfg(jcfg):
    def same(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})

    rest = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(FlamingoConfig)
            if f.name not in ("vision", "lm") and hasattr(jcfg, f.name)}
    return FlamingoConfig(vision=same(VisionConfig, jcfg.vision), lm=same(DecoderConfig, jcfg.lm), **rest)


def load(jcfg, params):
    model = Flamingo(port_cfg(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


VOCAB, MEDIA, EOC, NEW = 128, 3, 4, 8
VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32)
MPT = dict(family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           alibi=True, attention_bias=False, ln_no_bias=True, clip_qkv=6.0)
FLAMINGO = dict(media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1, num_vis_latents=4, perceiver_depth=1,
                perceiver_heads=2, perceiver_dim_head=8)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jmodel = JaxFlamingo(cfg=JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**MPT),
                                               **FLAMINGO))
    vision_x = rng.normal(size=(2, 1, 1, 14, 14, 3)).astype(np.float32)
    ids = rng.integers(7, VOCAB, size=(2, 6)).astype(np.int32)
    ids[:, 0] = MEDIA
    mask = np.ones_like(ids)
    init = jax.jit(jmodel.init)
    params = gates(init(jax.random.PRNGKey(0), vision_x, ids, mask))
    dparams = gates(init(jax.random.PRNGKey(7), vision_x, ids, mask))
    return dict(jmodel=jmodel, params=params, dparams=dparams, target=load(jmodel.cfg, params),
                draft=load(jmodel.cfg, dparams), vision_x=vision_x, ids=ids, mask=mask, jax={}, scan={}, init=init)


@pytest.fixture(params=["einsum", "fused"])
def route(request, monkeypatch):
    if request.param == "fused":
        monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    return request.param


def cfgs(max_new, eos=-1, min_new=0):
    kw = dict(max_new_tokens=max_new, pad_token_id=0, eos_token_id=eos, min_new_tokens=min_new)
    return JaxGenerationConfig(**kw), GenerationConfig(**kw)


def t(x):
    return torch.from_numpy(np.array(x))


def held(m, jax_target, jax_draft, port_target, port_draft, jcfg, pcfg, d, mask=None, vision_x=None,
         media_latents=None):
    """JAX's speculative tokens and iterations against the port's, and both
    against JAX flamingo_generate's greedy tokens."""
    mask = m["mask"] if mask is None else mask
    vx = m["vision_x"] if vision_x is None else vision_x
    key = (id(jax_target[1]), id(jax_draft[1]), jcfg, d, mask.tobytes(), media_latents is None)
    if key not in m["jax"]:      # JAX's side once for both of the port's routes
        want = np.asarray(jax_generate(jax_target[0], jax_target[1], m["vision_x"], m["ids"], mask, jcfg))
        jtok, jstats = jax_speculative(jax_target[0], jax_target[1], jax_draft[0], jax_draft[1], vx, m["ids"], mask,
                                       jcfg, num_draft_tokens=d, return_stats=True,
                                       media_latents=None if media_latents is None else np.asarray(media_latents))
        m["jax"][key] = want, np.asarray(jtok), int(jstats["iters"])
    want, jtok, jiters = m["jax"][key]
    got, stats = speculative_generate(port_target, port_draft, None if vx is None else t(vx), t(m["ids"]).long(),
                                      t(mask).long(), pcfg, num_draft_tokens=d, return_stats=True,
                                      media_latents=None if media_latents is None else t(media_latents),
                                      device="cpu")
    np.testing.assert_array_equal(jtok, want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["iters"] == jiters
    return stats["iters"]


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_speculative_exact_vs_greedy_random_draft(models, route, gamma):
    m = models
    jcfg, pcfg = cfgs(NEW)
    held(m, (m["jmodel"], m["params"]), (m["jmodel"], m["dparams"]), m["target"], m["draft"], jcfg, pcfg, gamma)


def test_speculative_exact_full_acceptance(models, route):
    m = models
    jcfg, pcfg = cfgs(NEW)
    iters = held(m, (m["jmodel"], m["params"]), (m["jmodel"], m["params"]), m["target"], m["target"], jcfg, pcfg, 3)
    assert iters == 2        # 1 token from prefill, then 4 a window


def test_speculative_eos_and_padding(models, route):
    """EOS mid-stream and a left-padded row: pad after EOS exactly as the
    greedy loop."""
    m = models
    mask = m["mask"].copy()
    mask[0, :2] = 0
    probe = np.asarray(jax_generate(m["jmodel"], m["params"], m["vision_x"], m["ids"], mask, cfgs(NEW)[0]))
    jcfg, pcfg = cfgs(NEW, eos=int(probe[0, 2]))
    held(m, (m["jmodel"], m["params"]), (m["jmodel"], m["dparams"]), m["target"], m["draft"], jcfg, pcfg, 3,
         mask=mask)


def test_speculative_min_new_tokens(models, route):
    m = models
    probe = np.asarray(jax_generate(m["jmodel"], m["params"], m["vision_x"], m["ids"], m["mask"], cfgs(NEW)[0]))
    jcfg, pcfg = cfgs(NEW, eos=int(probe[0, 1]), min_new=4)
    held(m, (m["jmodel"], m["params"]), (m["jmodel"], m["dparams"]), m["target"], m["draft"], jcfg, pcfg, 2)


def test_speculative_scan_target(models, route):
    """A JAX scan_layers=True target (weights unstacked into the port's
    modules) and an unrolled draft."""
    m = models
    if not m["scan"]:
        m["scan"].update(model=JaxFlamingo(cfg=dataclasses.replace(m["jmodel"].cfg, scan_layers=True)),
                         vars=_scan_variables(m["params"], m["jmodel"]),
                         dparams=gates(m["init"](jax.random.PRNGKey(3), m["vision_x"], m["ids"], m["mask"])))
    sc = m["scan"]
    jcfg, pcfg = cfgs(NEW)
    held(m, (sc["model"], sc["vars"]), (m["jmodel"], sc["dparams"]), load(m["jmodel"].cfg, sc["vars"]),
         load(m["jmodel"].cfg, sc["dparams"]), jcfg, pcfg, 3)


def test_speculative_return_stats_and_latents(models, route):
    """A self-draft commits D + 1 tokens a window: 8 tokens in 2 iterations;
    a random draft needs at least as many; precomputed media_latents skip
    the vision encode and give the same tokens."""
    m = models
    jcfg, pcfg = cfgs(NEW)
    target = (m["jmodel"], m["params"])
    assert held(m, target, target, m["target"], m["target"], jcfg, pcfg, 3) == 2
    assert held(m, target, (m["jmodel"], m["dparams"]), m["target"], m["draft"], jcfg, pcfg, 3) >= 2
    with torch.no_grad():
        latents = m["target"].embed_vision(t(m["vision_x"]))
    jlat = m["jmodel"].apply(m["params"], m["vision_x"], method=JaxFlamingo.embed_vision)
    np.testing.assert_allclose(latents.numpy(), np.asarray(jlat), atol=1e-5, rtol=0)
    calls = []
    embed = Flamingo.embed_vision
    try:
        Flamingo.embed_vision = lambda self, x: calls.append(1) or embed(self, x)
        held(m, target, (m["jmodel"], m["dparams"]), m["target"], m["draft"], jcfg, pcfg, 3, vision_x=None,
             media_latents=latents)
    finally:
        Flamingo.embed_vision = embed
    assert not calls


@pytest.mark.parametrize("draft", ["random", "self"])
def test_speculative_d7_window(models, route, draft):
    """D 7: a verify window of 8 tokens (K4 / K5 on the card), 12 new tokens."""
    m = models
    jcfg, pcfg = cfgs(12)
    dp, dm = (m["dparams"], m["draft"]) if draft == "random" else (m["params"], m["target"])
    iters = held(m, (m["jmodel"], m["params"]), (m["jmodel"], dp), m["target"], dm, jcfg, pcfg, 7)
    if draft == "self":
        assert iters == 2    # ceil((12 - 1) / 8)


def test_speculative_reads_the_host_once_an_iteration(models, monkeypatch):
    """The loop's one host read per iteration (the accepted count with the
    condition), plus the first condition: counted on `Tensor.tolist`,
    `bool` and `item`."""
    m = models
    reads = []
    for name in ("tolist", "__bool__", "item"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, real=real, name=name: reads.append(name) or
                            real(self, *a))
    _, pcfg = cfgs(NEW)
    _, stats = speculative_generate(m["target"], m["draft"], t(m["vision_x"]), t(m["ids"]).long(),
                                    t(m["mask"]).long(), pcfg, num_draft_tokens=3, return_stats=True, device="cpu")
    assert reads.count("tolist") == stats["iters"] and reads.count("__bool__") == 1 and "item" not in reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny models run faster on one intra-op thread, which then
    does not contend with XLA's CPU pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_speculative_is_greedy_only(models):
    m = models
    for kw in (dict(do_sample=True), dict(num_beams=2)):
        with pytest.raises(ValueError, match="greedy-only"):
            port_spec.speculative_generate(m["target"], m["draft"], t(m["vision_x"]), t(m["ids"]), t(m["mask"]),
                                           GenerationConfig(max_new_tokens=4, **kw), device="cpu")
