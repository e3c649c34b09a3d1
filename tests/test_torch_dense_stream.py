"""K1 fused_dense, K2 fused_mlp and K3 attn_block_decode: the port's wrappers
on CPU tensors (their plain versions) against the JAX package's Pallas
kernels run with interpret=True, as tests/test_dense_stream.py runs them.

Covers LayerNorm with and without bias, clip, GELU, gate and residual, the
tied-head layout with a ragged vocabulary, a ragged hidden size, and K3 in
both forms: the fused-QKV self-attention step with ALiBi and clip at the
first slot, a block boundary and the last slot (output and both caches),
and the gated q-only cross-attention step with a row that has no preceding
image (exact zeros before the out-projection, so y equals x there).

The port takes torch's (out, in) weights, so the JAX (in, out) weights go
in transposed. fp32 throughout; the Pallas kernels tile the products and
walk head groups where the plain versions take whole products, so sums
differ in order: atol 2e-5, the bound of the JAX package's own tests of
these kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.models.decoders.common import alibi_slopes as jax_alibi_slopes
from open_flamingo_tpu.ops.decode_layer import attn_block_decode as jax_attn_block
from open_flamingo_tpu.ops.dense_stream import fused_dense as jax_dense
from open_flamingo_tpu.ops.dense_stream import fused_mlp as jax_mlp
from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp

ATOL = 2e-5
B, K, N = 8, 256, 384


def normal(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


DENSE_CASES = {
    "ln_bias": dict(ln=True, ln_bias=True),
    "ln_no_bias_clip": dict(ln=True, clip=0.3),
    "gate_residual": dict(gate=0.7, residual=True),
    "full_epilogue_gelu": dict(ln=True, ln_bias=True, bias=True, act="gelu", clip=3.0, gate=-0.4, residual=True),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_plain_matches_pallas(rng, case):
    c = DENSE_CASES[case]
    x, w = normal(rng, B, K), normal(rng, K, N, scale=0.05)
    ops = {}
    if c.get("ln"):
        ops["ln_scale"] = normal(rng, K, scale=1.0)
    if c.get("ln_bias"):
        ops["ln_bias"] = normal(rng, K, scale=0.1)
    if c.get("bias"):
        ops["bias"] = normal(rng, N, scale=0.1)
    if c.get("residual"):
        ops["residual"] = normal(rng, B, N)
    if "gate" in c:
        ops["gate"] = np.array([c["gate"]], np.float32)
    kw = dict(act=c.get("act"), clip=c.get("clip"))
    want = jax_dense(jnp.asarray(x), jnp.asarray(w), block_n=128, interpret=True,
                     **{k: jnp.asarray(v) for k, v in ops.items()}, **kw)
    got = fused_dense(t(x), t(w.T), **{k: t(v) for k, v in ops.items()}, **kw)
    close(got, want)


def test_dense_tied_head_ragged_vocab(rng):
    """The head's layout: a (V, K) table read as the transposed weight, V
    not a multiple of the TPU's column block (390 = 3 x 128 + 6)."""
    x, wt, ln = normal(rng, B, K), normal(rng, 390, K, scale=0.05), normal(rng, K, scale=1.0)
    want = jax_dense(jnp.asarray(x), jnp.asarray(wt), ln_scale=jnp.asarray(ln), w_transposed=True,
                     block_n=128, interpret=True)
    got = fused_dense(t(x), t(wt), ln_scale=t(ln))
    assert got.shape == (B, 390)
    close(got, want)


@pytest.mark.parametrize("k2,block,xattn_ff", [
    (512, 128, False),    # MPT MLP: LN without bias, residual
    (352, 128, False),    # ragged hidden axis (2 x 128 + 96)
    (96, 64, True),       # xattn FF: LN bias and ff_gate, ragged
    (384, 256, True),
])
def test_mlp_plain_matches_pallas(rng, k2, block, xattn_ff):
    x, res = normal(rng, B, K), normal(rng, B, N)
    w1, w2 = normal(rng, K, k2, scale=0.05), normal(rng, k2, N, scale=0.05)
    ops = dict(ln_scale=normal(rng, K, scale=1.0), residual=res)
    if xattn_ff:
        ops.update(ln_bias=normal(rng, K, scale=0.1), gate=np.array([-0.3], np.float32))
    want = jax_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), act="gelu", block_k2=block, interpret=True,
                   **{k: jnp.asarray(v) for k, v in ops.items()})
    got = fused_mlp(t(x), t(w1.T), t(w2.T), act="gelu", **{k: t(v) for k, v in ops.items()})
    close(got, want)


H, DH, D = 4, 16, 64


@pytest.mark.parametrize("slot", [0, 16, 31])   # first slot, a 16-slot block boundary, last slot
def test_attn_block_self_plain_matches_pallas(rng, slot):
    b, s = 3, 32
    x, ln = normal(rng, b, D), normal(rng, D, scale=1.0)
    wqkv, wout = normal(rng, D, 3 * H * DH, scale=0.2), normal(rng, H * DH, D, scale=0.1)
    kc, vc = normal(rng, b, H, s, DH), normal(rng, b, H, s, DH)
    mask = np.zeros((b, s), np.int32)
    mask[:, : slot + 1] = 1
    mask[1, : min(slot, 4)] = 0                   # a left-padded row
    kw = dict(heads=H, head_dim=DH, scale=DH**-0.5, fused_qkv=True, clip=0.8)
    want, want_k, want_v = jax_attn_block(
        jnp.asarray(x), jnp.asarray(ln), None, jnp.asarray(wqkv), jnp.asarray(wout), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(mask), slot=slot, slopes=jax_alibi_slopes(H), interpret=True, **kw,
    )
    k_t, v_t = t(kc), t(vc)
    got, k2, v2 = attn_block_decode(
        t(x), t(ln), None, t(wqkv.T), t(wout.T), k_t, v_t, torch.from_numpy(mask).bool(),
        slot=torch.tensor([slot], dtype=torch.int32), slopes=torch.from_numpy(alibi_slopes(H)), **kw,
    )
    assert k2 is k_t and v2 is v_t                # written in place
    close(got, want)
    close(k_t, want_k)
    close(v_t, want_v)
    others = np.arange(s) != slot
    np.testing.assert_array_equal(k_t.numpy()[:, :, others], kc[:, :, others])
    np.testing.assert_array_equal(v_t.numpy()[:, :, others], vc[:, :, others])


def test_attn_block_gated_xattn_plain_matches_pallas(rng):
    b, n_lat, t_img = 3, 8, 2
    s = n_lat * t_img
    x, ln, ln_b = normal(rng, b, D), normal(rng, D, scale=1.0), normal(rng, D, scale=0.1)
    wq, wout = normal(rng, D, H * DH, scale=0.2), normal(rng, H * DH, D, scale=0.1)
    k, v = normal(rng, b, H, s, DH), normal(rng, b, H, s, DH)
    text_time = np.array([1, 0, 2])               # row 1: no preceding image
    mask = (text_time[:, None] == np.arange(s)[None, :] // n_lat + 1).astype(np.int32)
    gate = np.array([0.6], np.float32)
    kw = dict(heads=H, head_dim=DH, scale=DH**-0.5)
    want = jax_attn_block(
        jnp.asarray(x), jnp.asarray(ln), jnp.asarray(ln_b), jnp.asarray(wq), jnp.asarray(wout), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(mask), gate=jnp.asarray(gate), interpret=True, **kw,
    )
    got = attn_block_decode(t(x), t(ln), t(ln_b), t(wq.T), t(wout.T), t(k), t(v), torch.from_numpy(mask).bool(),
                            gate=t(gate), **kw)
    close(got, want)
    assert torch.equal(got[1], t(x)[1])
