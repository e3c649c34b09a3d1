"""The port's modules against their flax counterparts on the CPU, with the
flax weights moved by `convert/from_jax.py`: ViT, PerceiverResampler, the
MPT block (full forward and prefill into a cache) and
GatedCrossAttentionBlock with nonzero gates (prefill and a decode step
over the media K/V projected at prefill).

fp32 on both sides (the JAX tests run matmuls at "highest" precision);
tolerance 1e-4 covers the different summation orders of the two einsum
paths at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.decoders.common import KVCache as JaxKVCache
from open_flamingo_tpu.models.decoders.common import make_attn_inputs as jax_attn_inputs
from open_flamingo_tpu.models.decoders.mpt import MPTBlock as JaxMPTBlock
from open_flamingo_tpu.models.perceiver import PerceiverResampler as JaxPerceiver
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.models.vit import VisionTransformer as JaxViT
from open_flamingo_tpu.models.xattn import GatedCrossAttentionBlock as JaxGated
from open_flamingo_tpu_torch.configs import DecoderConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.models.decoders.common import KVCache, make_attn_inputs
from open_flamingo_tpu_torch.models.decoders.mpt import MPTBlock
from open_flamingo_tpu_torch.models.perceiver import PerceiverResampler
from open_flamingo_tpu_torch.models.vit import VisionTransformer
from open_flamingo_tpu_torch.models.xattn import GatedCrossAttentionBlock

ATOL = RTOL = 1e-4


def load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return module


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_vit_matches_flax(rng):
    kw = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=2, num_heads=2, intermediate_size=32)
    px = rng.normal(size=(3, 14, 14, 3)).astype(np.float32)
    jm = JaxViT(cfg=JaxVisionConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0), px)
    tm = load(VisionTransformer(VisionConfig(**kw), device="cpu"), params)
    close(tm(torch.from_numpy(px)), jm.apply(params, px))


def test_perceiver_matches_flax(rng):
    x = rng.normal(size=(2, 2, 1, 5, 24)).astype(np.float32)
    kw = dict(dim=24, depth=2, dim_head=8, heads=2, num_latents=4)
    jm = JaxPerceiver(**kw)
    params = jm.init(jax.random.PRNGKey(1), x)
    tm = load(PerceiverResampler(**kw, device="cpu"), params)
    close(tm(torch.from_numpy(x)), jm.apply(params, x))


MPT = dict(
    family="mpt", vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, alibi=True, attention_bias=False, ln_no_bias=True,
)


@pytest.mark.parametrize("clip_qkv", [None, 0.5])
def test_mpt_block_matches_flax(rng, clip_qkv):
    b, t = 2, 9
    x = rng.normal(size=(b, t, 32)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[0, :3] = 0
    jcfg = JaxDecoderConfig(**MPT, clip_qkv=clip_qkv)
    jm = JaxMPTBlock(cfg=jcfg)
    jattn, _ = jax_attn_inputs(jnp.asarray(mask))
    params = jm.init(jax.random.PRNGKey(2), x, jattn, None)
    tm = load(MPTBlock(DecoderConfig(**MPT, clip_qkv=clip_qkv), device="cpu"), params)
    valid = mask.astype(bool)

    # full forward, no cache
    want, _ = jm.apply(params, x, jattn, None)
    tattn, _ = make_attn_inputs(torch.from_numpy(mask))
    got, _ = tm(torch.from_numpy(x), tattn, None)
    close(got[torch.from_numpy(valid)], np.asarray(want)[valid])

    # prefill into a 16-slot cache: K/V land in the head-major cache
    jcache = JaxKVCache.create(jcfg, b, 16)
    jattn_c, _ = jax_attn_inputs(jnp.asarray(mask), cache=jcache)
    want_c, jkv = jm.apply(params, x, jattn_c, jcache.layers[0])
    tcache = KVCache.create(DecoderConfig(**MPT), b, 16, torch.float32, "cpu")
    tattn_c, _ = make_attn_inputs(torch.from_numpy(mask), cache=tcache)
    got_c, tkv = tm(torch.from_numpy(x), tattn_c, tcache.layers[0])
    close(got_c[torch.from_numpy(valid)], np.asarray(want_c)[valid])
    close(tkv.k, jkv.k)
    close(tkv.v, jkv.v)


def test_gated_xattn_block_matches_flax(rng):
    b, t, t_img, n_lat, dv = 2, 10, 2, 4, 24
    x = rng.normal(size=(b, t, 32)).astype(np.float32)
    media = rng.normal(size=(b, t_img, n_lat, dv)).astype(np.float32)
    loc = np.zeros((b, t), np.int32)
    loc[:, 2] = 1
    loc[1, 6] = 1
    text_time = np.cumsum(loc, axis=1).astype(np.int32)     # rows start before any image
    jm = JaxGated(dim=32, dim_visual=dv)
    params = jm.init(jax.random.PRNGKey(3), x, media, text_time)
    params = jax.tree.map(lambda p: jnp.full_like(p, 0.5) if p.shape == (1,) else p, params)
    tm = load(GatedCrossAttentionBlock(32, dv, device="cpu"), params)
    assert float(tm.attn_gate.detach()) == 0.5 and float(tm.ff_gate.detach()) == 0.5

    want, state = jm.apply(params, x, media, text_time, mutable=["media_kv"])
    got, (mk, mv) = tm(torch.from_numpy(x), torch.from_numpy(media), torch.from_numpy(text_time))
    close(got, want)
    jk, jv = state["media_kv"]["attn"]["kv"][0]
    close(mk, jk)
    close(mv, jv)

    # one decode token over the media K/V captured above
    x1 = rng.normal(size=(b, 1, 32)).astype(np.float32)
    tt1 = text_time[:, -1:]
    want1 = jm.apply(params, x1, media, tt1, (jk, jv))
    got1, _ = tm(torch.from_numpy(x1), torch.from_numpy(media), torch.from_numpy(tt1), (mk, mv))
    close(got1, want1)
