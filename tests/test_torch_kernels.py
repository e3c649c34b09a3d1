"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels run with interpret=True: K4
flash_attention forward, K5 masked_xattn forward, K7 decode_attention and
decode_attention_update.

Covers ALiBi, pad masks, all-masked rows (exact zeros), q_offset, ragged
S, T_img = 2, and the in-place slot write of the update. fp32 throughout;
the Pallas kernels stream K/V blocks with an online softmax where the
plain versions take one softmax, so sums differ in order: atol 2e-5, the
bound the JAX package's own kernel tests use.

The CUDA kernels themselves need the card: tests/test_torch_cuda.py and
`chip_smoke.py` hold them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.models.decoders.common import alibi_slopes as jax_alibi_slopes
from open_flamingo_tpu.ops.decode_attention import decode_attention as jax_decode
from open_flamingo_tpu.ops.decode_attention import decode_attention_update as jax_decode_update
from open_flamingo_tpu.ops.flash_attention import flash_attention as jax_flash
from open_flamingo_tpu.ops.masked_xattn import masked_xattn as jax_xattn
from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
from open_flamingo_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update
from open_flamingo_tpu_torch.ops.flash_attention import flash_attention
from open_flamingo_tpu_torch.ops.masked_xattn import masked_xattn

ATOL = 2e-5
H, D = 2, 16


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("tq,s,q_offset,bq,bk", [
    (16, 16, 0, 8, 8),
    (16, 32, 0, 8, 8),     # prefill into a larger cache
    (16, 32, 8, 8, 8),     # q_offset > 0
    (24, 37, 5, 16, 8),    # ragged S, ragged Tq
])
def test_flash_plain_matches_pallas(rng, tq, s, q_offset, bq, bk):
    bh = 2 * H
    q, k, v = normal(rng, bh, tq, D), normal(rng, bh, s, D), normal(rng, bh, s, D)
    pad = np.zeros((bh, s), np.int32)
    pad[:, : q_offset + tq] = 1
    pad[0, :3] = 0            # left padding: row 0's first queries see no key
    pad[1] = 0                # an all-masked sequence
    slopes = np.tile(jax_alibi_slopes(H), bh // H)[:, None].astype(np.float32)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad), jnp.asarray(slopes),
        jnp.int32(q_offset), True, 0.25, bq, bk, True,
    )
    got = flash_attention(t(q), t(k), t(v), t(pad).bool(), t(slopes), q_offset, True, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[1] == 0).all()
    if q_offset == 0:
        assert (got[0, :3] == 0).all()


@pytest.mark.parametrize("t_img", [1, 2])
def test_masked_xattn_plain_matches_pallas(rng, t_img):
    bh, tq, n_lat = 2 * H, 16, 8
    s = t_img * n_lat
    q, k, v = normal(rng, bh, tq, D), normal(rng, bh, s, D), normal(rng, bh, s, D)
    media_loc = np.zeros((bh, tq), np.int32)
    media_loc[:, 3] = 1
    if t_img == 2:
        media_loc[:, 9] = 1
    text_time = np.cumsum(media_loc, axis=1).astype(np.int32)   # rows 0..2: no media
    want = jax_xattn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(text_time), n_lat, 0.25, 8, 8, True,
    )
    got = masked_xattn(t(q), t(k), t(v), t(text_time), n_lat, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[:, :3] == 0).all()


@pytest.mark.parametrize("with_alibi", [False, True])
def test_decode_plain_matches_pallas(rng, with_alibi):
    b, s = 3, 40
    q, k, v = normal(rng, b, H, D), normal(rng, b, H, s, D), normal(rng, b, H, s, D)
    mask = np.ones((b, s), np.int32)
    mask[0, :5] = 0
    mask[:, 30:] = 0
    mask[2] = 0               # all-masked: exact zeros
    slopes = jax_alibi_slopes(H) if with_alibi else None
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        scale=0.25, slopes=slopes, block_k=16, interpret=True,
    )
    got = decode_attention(
        t(q), t(k), t(v), t(mask).bool(), scale=0.25,
        slopes=None if slopes is None else torch.from_numpy(alibi_slopes(H)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("slot", [0, 21, 39])
def test_decode_update_plain_matches_pallas(rng, slot):
    b, s = 3, 40
    q, k, v = normal(rng, b, H, D), normal(rng, b, H, s, D), normal(rng, b, H, s, D)
    k_new, v_new = normal(rng, b, H, D), normal(rng, b, H, D)
    mask = np.zeros((b, s), np.int32)
    mask[:, : slot + 1] = 1
    mask[1, : min(slot, 4)] = 0
    want, want_k, want_v = jax_decode_update(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(mask), jnp.int32(slot), scale=0.25, slopes=jax_alibi_slopes(H),
        block_k=16, interpret=True,
    )
    kc, vc = t(k), t(v)
    got, kc2, vc2 = decode_attention_update(
        t(q), kc, vc, t(k_new), t(v_new), t(mask).bool(), slot,
        scale=0.25, slopes=torch.from_numpy(alibi_slopes(H)),
    )
    assert kc2 is kc and vc2 is vc                 # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(kc[:, :, slot].numpy(), k_new)
    others = np.arange(s) != slot
    np.testing.assert_array_equal(kc.numpy()[:, :, others], k[:, :, others])
    np.testing.assert_array_equal(vc.numpy()[:, :, others], v[:, :, others])


def test_alibi_slopes_match_jax():
    for h in (4, 6, 16, 32):
        np.testing.assert_array_equal(alibi_slopes(h), jax_alibi_slopes(h))
