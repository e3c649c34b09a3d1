"""K7's split plan (`decode_plan`) and its plain version at caches longer
than the JAX kernel's 512-key block.

The plan cuts each (b, h)'s S keys into `splits` chunks of `chunk` keys,
one block each, the blocks of a (b, h) one thread block cluster: every key
must lie in exactly one chunk, every chunk must hold a key, the cluster
must stay within the portable size, and the plan must follow from (S, Dh,
dtype) alone, so that a (b, h) row adds its sums in one order in any batch.
The CUDA kernel itself needs the card (tests/test_torch_cuda.py,
`chip_smoke.py`); here the wrappers run the plain version on CPU tensors,
held to JAX `decode_attention` / `decode_attention_update` in interpret
mode at a ragged S of 1,100 (three JAX blocks), with ALiBi, left padding
longer than a block and an all-masked row (exact zeros). fp32; atol 2e-5 as
in tests/test_torch_kernels.py.
"""

import inspect
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.models.decoders.common import alibi_slopes as jax_alibi_slopes
from open_flamingo_tpu.ops.decode_attention import decode_attention as jax_decode
from open_flamingo_tpu.ops.decode_attention import decode_attention_update as jax_decode_update
from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
from open_flamingo_tpu_torch.ops import build
from open_flamingo_tpu_torch.ops.decode_attention import (
    DECODE_MAX_SPLITS, DECODE_MAX_STAGES, DECODE_TILE, bind, decode_attention, decode_attention_update, decode_plan)

ATOL = 2e-5
H, D, S_LONG = 2, 16, 1100
RING_MAX = 200 * 1024            # csrc/decode_attention.cu kMaxSmem
H100_SMS = 132


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 16, 64, 80, 128])
def test_plan_puts_every_key_in_one_chunk(d, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    row = -(-d * es // 16) * 16
    for s in range(0, 4097):
        p = decode_plan(s, d, dtype)
        assert p.chunk >= DECODE_TILE and p.chunk % DECODE_TILE == 0, (s, p)
        assert 1 <= p.splits <= DECODE_MAX_SPLITS, (s, p)
        # the chunks [r * chunk, min(S, (r + 1) * chunk)) tile [0, S), none empty (S 0: one empty chunk)
        assert p.splits * p.chunk >= s, (s, p)
        assert (p.splits - 1) * p.chunk < s or (s == 0 and p.splits == 1), (s, p)
        # a ring of whole tiles of a chunk, within the kernel's shared memory
        assert 1 <= p.stages <= min(DECODE_MAX_STAGES, p.chunk // DECODE_TILE), (s, p)
        assert p.stages * 2 * DECODE_TILE * row <= RING_MAX, (s, p)


def test_plan_depends_on_the_cache_alone():
    assert list(inspect.signature(decode_plan).parameters) == ["s", "d", "dtype"]
    decode_plan.cache_clear()
    first = {(s, d, dt): decode_plan(s, d, dt) for s in (64, 1100, 2048) for d in (64, 128)
             for dt in (torch.float32, torch.bfloat16)}
    decode_plan.cache_clear()
    assert all(decode_plan(*key) == plan for key, plan in reversed(list(first.items())))


@pytest.mark.parametrize("s,splits", [(64, 1), (256, 2), (384, 3), (512, 4), (640, 5), (768, 6), (896, 7),
                                      (1024, 8), (2048, 8), (4096, 8)])
def test_plan_split_counts(s, splits):
    """Every cluster size from 1 to 8 is some S's plan; LLaMA-7B's S 2,048
    fills the card's 132 SMs with B 1 x 32 heads."""
    assert decode_plan(s, 128, torch.bfloat16).splits == splits
    if s == 2048:
        assert 32 * splits >= H100_SMS


def test_bind_matches_the_c_entry():
    """The ctypes argument list has one entry per parameter of the C entry."""
    lib = bind(SimpleNamespace(decode_attention_fwd=SimpleNamespace()))
    src = (build.CSRC / "decode_attention.cu").read_text()
    params = re.search(r'extern "C" int decode_attention_fwd\((.*?)\)\s*\{', src, re.S).group(1)
    assert len(lib.decode_attention_fwd.argtypes) == len(params.split(","))


def _long_inputs(rng):
    b = 3
    q = rng.normal(size=(b, H, D)).astype(np.float32)
    k = rng.normal(size=(b, H, S_LONG, D)).astype(np.float32)
    v = rng.normal(size=(b, H, S_LONG, D)).astype(np.float32)
    mask = np.ones((b, S_LONG), np.int32)
    mask[0, :700] = 0         # left padding past JAX's first 512-key block
    mask[1, 1050:] = 0
    mask[2] = 0               # no valid key: exact zeros
    return q, k, v, mask


@pytest.mark.parametrize("with_alibi", [False, True])
def test_decode_plain_matches_pallas_long_cache(rng, with_alibi):
    q, k, v, mask = _long_inputs(rng)
    slopes = jax_alibi_slopes(H) if with_alibi else None
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale=0.25, slopes=slopes,
                      interpret=True)
    got = decode_attention(t(q), t(k), t(v), t(mask).bool(), scale=0.25,
                           slopes=None if slopes is None else torch.from_numpy(alibi_slopes(H)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("slot", [0, 511, 512, S_LONG - 1])
def test_decode_update_plain_matches_pallas_long_cache(rng, slot):
    q, k, v, mask = _long_inputs(rng)
    mask[:2, slot + 1:] = 0
    mask[:2, slot] = 1
    k_new, v_new = rng.normal(size=(3, H, D)).astype(np.float32), rng.normal(size=(3, H, D)).astype(np.float32)
    want, want_k, want_v = jax_decode_update(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(mask),
        jnp.int32(slot), scale=0.25, slopes=jax_alibi_slopes(H), interpret=True)
    kc, vc = t(k), t(v)
    got, kc2, vc2 = decode_attention_update(t(q), kc, vc, t(k_new), t(v_new), t(mask).bool(), slot, scale=0.25,
                                            slopes=torch.from_numpy(alibi_slopes(H)))
    assert kc2 is kc and vc2 is vc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[2] == 0).all()
    np.testing.assert_array_equal(kc.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(want_v))
