"""The training path's attention on the CPU: the forward's logsumexp and the
backward of K4 flash_attention (K4b) and K5 masked_xattn (K5b), plain
versions against the JAX package's Pallas kernels run with interpret=True,
against torch.autograd of the plain forward, and through the port's
autograd Functions.

Cases: left padding (queries that see no key), a cache offset with left
padding (masked dk/dv exactly 0, as tests/test_flash.py), ragged S, a Tq
that is no multiple of 16 (the card's query tiles) after a cache offset,
ALiBi on and off, an all-masked sequence, xattn rows before any image
(exactly zero dq), two images, and text_time drawn at random, not a
cumsum, with 5 or 20 latents an image (images across the card's 16-key
groups): the semantics the card's per-block query intervals keep. The JAX
backward kernels do not bound S or Tq, so their blocks divide both (a
ragged S is one key block there). The FMA yardsticks of the card's
backward take CUDA tensors only.

fp32 throughout; the Pallas kernels accumulate block by block where the
plain versions take whole products: atol 3e-5, the bound of the JAX
package's own gradient tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.models.decoders.common import alibi_slopes as jax_alibi_slopes
from open_flamingo_tpu.ops.flash_attention import _flash_backward, _flash_forward
from open_flamingo_tpu.ops.masked_xattn import _xattn_backward, _xattn_forward
from open_flamingo_tpu_torch.ops.flash_attention import (
    FlashAttentionFn, flash_attention, flash_attention_backward, flash_attention_backward_fma, reference_attention,
    reference_attention_backward)
from open_flamingo_tpu_torch.ops.masked_xattn import (
    MaskedXattnFn, masked_xattn, masked_xattn_backward, masked_xattn_backward_fma, reference_masked_xattn,
    reference_masked_xattn_backward)

ATOL = 3e-5
H, D, SCALE = 2, 16, 0.25


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(want), atol=ATOL)


def autograd_grads(fwd, q, k, v, dout):
    """dq, dk, dv of sum(fwd(q, k, v) * dout) by torch.autograd."""
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fwd(*leaves) * dout).sum().backward()
    return [x.grad for x in leaves]


# ---------------------------------------------------------------- K4 / K4b

FLASH_CASES = {
    # tq, s, q_offset, block_q, block_k, left pad of row 0
    "left_pad": (16, 16, 0, 8, 8, 3),          # row 0's first queries see no key
    "left_pad_q_offset": (8, 32, 10, 8, 8, 2),  # left padding + a cache offset
    "ragged_S": (24, 37, 5, 8, 37, 0),
    "ragged_tq_q_offset": (21, 40, 7, 21, 40, 4),   # Tq 21: a 16-row tile and 5 rows of the next
}


def flash_inputs(rng, case, alibi):
    tq, s, q_offset, bq, bk, pad0 = FLASH_CASES[case]
    bh = 2 * H
    q, k, v, dout = normal(rng, bh, tq, D), normal(rng, bh, s, D), normal(rng, bh, s, D), normal(rng, bh, tq, D)
    pad = np.zeros((bh, s), np.int32)
    pad[:, : q_offset + tq] = 1
    pad[0, :pad0] = 0
    pad[2] = 0                       # an all-masked sequence
    slopes = np.tile(jax_alibi_slopes(H), bh // H)[:, None].astype(np.float32) * float(alibi)
    return q, k, v, dout, pad, slopes, q_offset, bq, bk


def masked_keys(pad, q_offset, tq):
    """(BH, S) keys no query may attend to."""
    s = pad.shape[1]
    return (pad == 0) | (np.arange(s)[None, :] > q_offset + tq - 1)


def query_rows_without_keys(pad, q_offset, tq):
    allowed = (pad[:, None, :] != 0) & (np.arange(pad.shape[1])[None, None, :] <= q_offset + np.arange(tq)[None, :, None])
    return ~allowed.any(-1)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_lse_and_backward_match_pallas(rng, case, alibi):
    q, k, v, dout, pad, slopes, q_offset, bq, bk = flash_inputs(rng, case, alibi)
    tq = q.shape[1]
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad), jnp.asarray(slopes), jnp.int32(q_offset),
        causal=True, scale=SCALE, block_q=bq, block_k=bk, interpret=True, with_lse=True)
    out, lse = reference_attention(t(q), t(k), t(v), t(pad).bool(), t(slopes), q_offset, True, SCALE, with_lse=True)
    close(out, want_out)
    close(lse, want_lse)

    # the same q, k, v, out, lse and dout into both backward versions
    want = _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad), jnp.asarray(slopes), jnp.int32(q_offset),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(dout),
        causal=True, scale=SCALE, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention_backward(t(q), t(k), t(v), t(pad).bool(), t(slopes), q_offset, out, lse, t(dout), True, SCALE)
    for g, w in zip(got, want):
        close(g, w)
    dq, dk, dv = got
    dead = masked_keys(pad, q_offset, tq)
    assert (dk.numpy()[dead] == 0).all() and (dv.numpy()[dead] == 0).all()
    assert (dq.numpy()[query_rows_without_keys(pad, q_offset, tq)] == 0).all()

    # the explicit formulas against autograd of the plain forward
    fwd = lambda a, b, c: reference_attention(a, b, c, t(pad).bool(), t(slopes), q_offset, True, SCALE)
    for g, w in zip(got, autograd_grads(fwd, t(q), t(k), t(v), t(dout))):
        close(g, w)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_function_grads_equal_autograd_of_plain(rng, case):
    """flash_attention under autograd goes through FlashAttentionFn (plain
    forward and plain backward on the CPU)."""
    q, k, v, dout, pad, slopes, q_offset, _, _ = flash_inputs(rng, case, True)
    args = (t(pad).bool(), t(slopes), q_offset, True, SCALE)
    leaves = [x.requires_grad_(True) for x in (t(q), t(k), t(v))]
    out = flash_attention(*leaves, *args)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    (out * t(dout)).sum().backward()
    want = autograd_grads(lambda a, b, c: reference_attention(a, b, c, *args), t(q), t(k), t(v), t(dout))
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w)
    with torch.no_grad():
        assert flash_attention(*leaves, *args).grad_fn is None
    assert FlashAttentionFn.apply(*leaves, *args).requires_grad


# ---------------------------------------------------------------- K5 / K5b

XATTN_CASES = {
    # tq, t_img, n_latents, block_q, block_k
    "one_image": (16, 1, 8, 8, 8),
    "two_images": (16, 2, 8, 8, 8),
    "two_images_wide_blocks": (24, 2, 8, 8, 16),
}


def xattn_inputs(rng, case):
    tq, t_img, n_lat, bq, bk = XATTN_CASES[case]
    bh, s = 2 * H, t_img * n_lat
    q, k, v, dout = normal(rng, bh, tq, D), normal(rng, bh, s, D), normal(rng, bh, s, D), normal(rng, bh, tq, D)
    loc = np.zeros((bh, tq), np.int32)
    loc[:, 3] = 1                    # rows 0..2: text before the first image
    if t_img == 2:
        loc[:, 9] = 1
        loc[1, 9], loc[1, 12] = 0, 1
    text_time = np.cumsum(loc, axis=1).astype(np.int32)
    return q, k, v, dout, text_time, n_lat, bq, bk


@pytest.mark.parametrize("case", list(XATTN_CASES))
def test_masked_xattn_plain_lse_and_backward_match_pallas(rng, case):
    q, k, v, dout, tt, n_lat, bq, bk = xattn_inputs(rng, case)
    want_out, want_lse = _xattn_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tt), n_latents=n_lat, scale=SCALE,
        block_q=bq, block_k=bk, interpret=True, with_lse=True)
    out, lse = reference_masked_xattn(t(q), t(k), t(v), t(tt), n_lat, SCALE, with_lse=True)
    close(out, want_out)
    close(lse, want_lse)

    want = _xattn_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tt), jnp.asarray(out.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(dout), n_latents=n_lat, scale=SCALE, block_q=bq, block_k=bk,
        interpret=True)
    got = masked_xattn_backward(t(q), t(k), t(v), t(tt), n_lat, out, lse, t(dout), SCALE)
    for g, w in zip(got, want):
        close(g, w)
    assert (got[0][:, :3] == 0).all()            # text before any image: exactly zero dq
    assert (lse[:, :3] == 0).all()

    fwd = lambda a, b, c: reference_masked_xattn(a, b, c, t(tt), n_lat, SCALE)
    for g, w in zip(got, autograd_grads(fwd, t(q), t(k), t(v), t(dout))):
        close(g, w)


@pytest.mark.parametrize("case", list(XATTN_CASES))
def test_masked_xattn_function_grads_equal_autograd_of_plain(rng, case):
    q, k, v, dout, tt, n_lat, _, _ = xattn_inputs(rng, case)
    leaves = [x.requires_grad_(True) for x in (t(q), t(k), t(v))]
    out = masked_xattn(*leaves, t(tt), n_lat, SCALE)
    assert "MaskedXattnFn" in type(out.grad_fn).__name__
    (out * t(dout)).sum().backward()
    want = autograd_grads(lambda a, b, c: reference_masked_xattn(a, b, c, t(tt), n_lat, SCALE),
                          t(q), t(k), t(v), t(dout))
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w)
    assert (leaves[0].grad[:, :3] == 0).all()
    assert MaskedXattnFn.apply(*leaves, t(tt), n_lat, SCALE).requires_grad


@pytest.mark.parametrize("n_lat", [5, 20])
def test_masked_xattn_plain_backward_any_text_time_matches_pallas(rng, n_lat):
    """text_time drawn at random in [0, T_img] (non-monotone: a row may go
    back to an earlier image or to none), 5 or 20 latents an image; image 2
    of instance 1 seen by no query (its dk, dv exactly 0), rows with
    text_time 0 exactly zero dq."""
    tq, t_img, bq = 24, 3, 8
    bh, s = 2 * H, t_img * n_lat
    q, k, v, dout = normal(rng, bh, tq, D), normal(rng, bh, s, D), normal(rng, bh, s, D), normal(rng, bh, tq, D)
    tt = rng.integers(0, t_img + 1, size=(bh, tq)).astype(np.int32)
    tt[1][tt[1] == 2] = 0
    assert (np.diff(tt, axis=1) < 0).any() and (tt == 0).any()
    want_out, want_lse = _xattn_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tt), n_latents=n_lat, scale=SCALE,
        block_q=bq, block_k=s, interpret=True, with_lse=True)
    out, lse = reference_masked_xattn(t(q), t(k), t(v), t(tt), n_lat, SCALE, with_lse=True)
    close(out, want_out)
    close(lse, want_lse)
    want = _xattn_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tt), jnp.asarray(out.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(dout), n_latents=n_lat, scale=SCALE, block_q=bq, block_k=s,
        interpret=True)
    got = masked_xattn_backward(t(q), t(k), t(v), t(tt), n_lat, out, lse, t(dout), SCALE)
    for g, w in zip(got, want):
        close(g, w)
    dq, dk, dv = (g.numpy() for g in got)
    assert (dq[tt == 0] == 0).all()
    assert (dk[1, n_lat:2 * n_lat] == 0).all() and (dv[1, n_lat:2 * n_lat] == 0).all()   # image 2's keys
    fwd = lambda a, b, c: reference_masked_xattn(a, b, c, t(tt), n_lat, SCALE)
    for g, w in zip(got, autograd_grads(fwd, t(q), t(k), t(v), t(dout))):
        close(g, w)


def test_backward_fma_yardsticks_take_cuda_tensors_only(rng):
    """flash_attention_backward_fma and masked_xattn_backward_fma launch the
    card's CUDA-core bodies only: CPU tensors raise, and neither counts a
    launch of the port's backward."""
    q, k, v, dout, pad, slopes, q_offset, _, _ = flash_inputs(rng, "left_pad", True)
    out, lse = reference_attention(t(q), t(k), t(v), t(pad).bool(), t(slopes), q_offset, True, SCALE, with_lse=True)
    counts = flash_attention_backward.launches, masked_xattn_backward.launches
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_backward_fma(t(q), t(k), t(v), t(pad).bool(), t(slopes), q_offset, out, lse, t(dout), True,
                                     SCALE)
    tt = np.ones(q.shape[:2], np.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        masked_xattn_backward_fma(t(q), t(k), t(v), t(tt), 8, out, lse, t(dout), SCALE)
    assert (flash_attention_backward.launches, masked_xattn_backward.launches) == counts
