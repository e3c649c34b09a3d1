"""Sampling in the port against the JAX package on the CPU:
`_filter_logits` bit for bit the logits JAX `_sample_token` hands
`jax.random.categorical` (temperature, top-k with ties at the k-th value,
top-p), the draw equal to JAX's for JAX's Gumbel noise, and a whole sampled
`flamingo_generate` fed JAX's per-step noise (the `split` chain from
PRNGKey(1)) through the `generation.gumbel_noise` hook equal to JAX's
tokens, on the einsum route and under the fused hooks. The tiny MPT
Flamingo and its varied weights are tests/test_torch_beam_sample.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_beam_sample import B, FAMILIES, NEW, T_TXT, fused, left_pad, make_family, t  # noqa: F401 (fixture)

from open_flamingo_tpu import generation as jax_generation
from open_flamingo_tpu.generation import GenerationConfig as JaxGenerationConfig
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu_torch import generation
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate


@pytest.fixture(scope="module")
def mpt():
    return make_family("mpt")


FILTERS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.9),
    "all": dict(temperature=0.7, top_k=20, top_p=0.8),
}


def jax_filtered(logits, key, cfg, monkeypatch):
    """The logits JAX `_sample_token` hands `jax.random.categorical`."""
    seen = []
    categorical = jax.random.categorical
    monkeypatch.setattr(jax.random, "categorical", lambda k, l, axis=-1: seen.append(l) or categorical(k, l, axis))
    tok = jax_generation._sample_token(jnp.asarray(logits), key, cfg)
    return np.asarray(seen[0]), np.asarray(tok)


@pytest.mark.parametrize("name", list(FILTERS))
def test_filters_bit_exact_and_draw_equal(rng, monkeypatch, name):
    # rounded logits: ties, also at the k-th value
    logits = np.round(rng.normal(size=(6, 64)).astype(np.float32) * 3, 1)
    key = jax.random.PRNGKey(7)
    want_l, want_tok = jax_filtered(logits, key, JaxGenerationConfig(max_new_tokens=1, do_sample=True,
                                                                      **FILTERS[name]), monkeypatch)
    cfg = GenerationConfig(max_new_tokens=1, do_sample=True, **FILTERS[name])
    got_l = generation._filter_logits(t(logits), cfg).numpy()
    np.testing.assert_array_equal(got_l, want_l)
    assert (want_l == generation.NEG_INF).any() == (name != "temperature")
    gumbel = t(jax.random.gumbel(key, logits.shape, jnp.float32))
    np.testing.assert_array_equal(generation._sample_token(t(logits), cfg, gumbel).numpy(), want_tok)


def jax_noise(seed):
    """JAX greedy_or_sample's per-step Gumbel noise: step i draws from the
    i-th `split` of the chain from PRNGKey(seed)."""
    keys, rng = [], jax.random.PRNGKey(seed)
    for _ in range(NEW):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return lambda step, shape: t(jax.random.gumbel(keys[step], tuple(shape), jnp.float32))


@pytest.mark.parametrize("route", ["einsum", "fused"])
def test_sampled_generate_equals_jax(mpt, request, monkeypatch, route):
    if route == "fused":
        request.getfixturevalue("fused")
    spec = FAMILIES["mpt"]
    jmodel, params, tmodel, vision_x, ids = mpt
    ids, mask = left_pad(spec, ids, 3)
    kw = dict(max_new_tokens=NEW, do_sample=True, temperature=0.7, top_k=20, top_p=0.9, pad_token_id=spec["pad"],
              eos_token_id=6, min_new_tokens=2)
    want = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask, JaxGenerationConfig(**kw),
                                   rng=jax.random.PRNGKey(1)))
    monkeypatch.setattr(generation, "gumbel_noise", lambda gen: jax_noise(1))
    got = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), GenerationConfig(**kw), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    greedy = np.asarray(jax_generate(jmodel, params, vision_x, ids, mask,
                                     JaxGenerationConfig(**dict(kw, do_sample=False))))
    assert not np.array_equal(want, greedy)      # the draw mattered


def test_sampling_generator_seeds_the_draw(mpt):
    """No generator: the draws of a generator seeded 0 (JAX's PRNGKey(0)
    default); another seed gives another sample."""
    _, _, tmodel, vision_x, ids = mpt
    cfg = GenerationConfig(max_new_tokens=NEW, do_sample=True, temperature=1.5, pad_token_id=1)

    def run(gen=None):
        return flamingo_generate(tmodel, t(vision_x), t(ids), torch.ones(B, T_TXT), cfg, generator=gen,
                                 device="cpu")

    default = run()
    torch.testing.assert_close(default, run(torch.Generator().manual_seed(0)), atol=0, rtol=0)
    assert not torch.equal(default, run(torch.Generator().manual_seed(1)))
