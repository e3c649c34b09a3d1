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


# The weight-streaming row GEMV's plan (ops.dense_stream.stream_plan), pure
# Python: every K1/K2 product of a decode path, (N, K) as (out, in) of the
# weight. OF-3B and OPT-1.3B (D 2048), OF-4B (D 2560), LLaMA-7B (D 4096,
# its ragged test hidden 11,000) and MPT-7B's layer in K11.
STREAM_SHAPES = [
    (50434, 2048), (8192, 2048), (2048, 8192), (2048, 2048), (50272, 2048),   # OF-3B, OPT-1.3B
    (7680, 2560), (50434, 2560), (10240, 2560), (2560, 10240),                # OF-4B
    (4096, 4096), (32003, 4096), (11008, 4096), (4096, 11008), (16384, 4096), (4096, 16384),  # LLaMA-7B, MPT-7B
    (11000, 4096), (4096, 11000),
]
# K3's and K6's products on the same body: OF-3B's self-attention (Wqkv,
# Wout) and gated block (Wq, Wout over 8 heads of 64), the out-projections of
# OF-4B and LLaMA-7B (OPT-1.3B's is OF-3B's (2048, 2048))
DECODE_LAYER_SHAPES = [(6144, 2048), (2048, 2048), (512, 2048), (2048, 512), (2560, 2560), (4096, 4096)]
PLAN_SHAPES = STREAM_SHAPES + [shape for shape in DECODE_LAYER_SHAPES if shape not in STREAM_SHAPES]
STREAM_BATCHES = (1, 8, 13, 16, 64)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("wkind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("n,k", PLAN_SHAPES)
def test_stream_plan_covers_every_column_and_chunk_once(n, k, wkind, sms):
    """Each (column, 32-wide K chunk) of the product lies in exactly one
    item; the slices are whole ring stages; the grid has work for every
    block and no more blocks than SMs."""
    from open_flamingo_tpu_torch.ops.dense_stream import STREAM_COLS, stream_items, stream_plan

    plan = stream_plan(n, k, wkind, sms)
    assert plan.stage_elems * {"bf16": 2, "int8": 1, "int4": 0.5}[wkind] == 128
    assert plan.slices == -(-plan.stages // plan.slice) and 1 <= plan.blocks <= min(plan.items, sms)
    chunks = -(-k // 32)
    cover = np.zeros((plan.tiles, chunks), np.int32)
    cols = np.zeros(n, np.int32)
    for (c0, c1), (k0, k1) in stream_items(plan, n, k):
        assert c0 % STREAM_COLS == 0 and 0 <= c0 < c1 <= n and 0 <= k0 < k1 <= k
        assert k0 % plan.stage_elems == 0 and (k1 % plan.stage_elems == 0 or k1 == k)
        cover[c0 // STREAM_COLS, k0 // 32:-(-k1 // 32)] += 1
        if k0 == 0:
            cols[c0:c1] += 1
    assert (cover == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("wkind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("n,k", PLAN_SHAPES)
def test_stream_plan_is_the_same_for_every_batch(n, k, wkind):
    """The plans of K2's two launches (and K1's, K3's and K6's) passed to
    the kernel do not depend on B; only the split's scratch grows with B's
    n-tiles."""
    from open_flamingo_tpu_torch.ops.dense_stream import STREAM_COLS, stream_launches

    for sms in (114, 132):
        launches = ((n, k, wkind, True), (k, n, wkind, False))
        got = {b: stream_launches(b, launches, sms) for b in STREAM_BATCHES}
        assert len({flat for flat, _ in got.values()}) == 1
        for b, (_, floats) in got.items():
            rows = 8 * -(-min(b, 64) // 8)
            assert floats % (STREAM_COLS * rows) == 0


def test_decode_layer_launches_give_stream_args_their_weights(monkeypatch):
    """K3's and K6's wrappers hand `stream_args` each projection's (N, K) and
    weight: OF-3B's self-attention (Wqkv 6,144 x 2,048, Wout 2,048 x 2,048)
    and gated block (512 x 2,048, 2,048 x 512), K6's out-projection at OF-4B
    and LLaMA-7B, in bf16, int8 and packed int4. In bf16 the plan of each
    launch is `stream_plan`'s for its shape and weight kind; fp32 gets zeros
    and nulls."""
    from open_flamingo_tpu_torch.ops import dense_stream
    from open_flamingo_tpu_torch.ops.decode_layer import attend_out_launches, attn_block_launches
    from open_flamingo_tpu_torch.ops.dense_stream import STREAM_COUNTERS, stream_args, stream_plan, weight_kind

    monkeypatch.setattr(dense_stream, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dense_stream, "_ARGS", {})
    monkeypatch.setattr(dense_stream, "_SCRATCH", {})
    monkeypatch.setattr(dense_stream, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)   # a CPU build has no CUDA

    def stored(n, k, kind):
        if kind == "int4":
            return torch.zeros(n, k // 2, dtype=torch.uint8)
        return torch.zeros(n, k, dtype=torch.int8 if kind == "int8" else torch.bfloat16)

    cases = []
    for dm, heads, dh, fused in ((2048, 16, 128, True), (2048, 8, 64, False)):   # K3 self, gated
        inner = heads * dh
        for kind in ("bf16", "int8", "int4"):
            wq, wout = stored((3 if fused else 1) * inner, dm, kind), stored(dm, inner, kind)
            launches = attn_block_launches(wq, wout, dm, inner)
            assert [(n, k, w, g) for n, k, w, g in launches] == [((3 if fused else 1) * inner, dm, wq, False),
                                                                  (dm, inner, wout, False)]
            cases.append(launches)
    for dm, heads, dh in ((2560, 32, 80), (4096, 32, 128)):                      # K6: OF-4B, LLaMA-7B
        for kind in ("bf16", "int8", "int4"):
            wout = stored(dm, heads * dh, kind)
            launches = attend_out_launches(wout, heads * dh)
            assert launches == [(dm, heads * dh, wout, False)]
            cases.append(launches)
    for launches in cases:
        for b in (1, 8, 64):
            x = torch.zeros(b, 8, dtype=torch.bfloat16)
            args, scratch = stream_args(x, launches)
            want = [stream_plan(n, k, weight_kind(w), 132) for n, k, w, _ in launches]
            assert args[:2 * len(launches)] == tuple(v for p in want for v in (p.slice, p.blocks))
            if any(p.slices > 1 for p in want):
                assert args[-1] == STREAM_COUNTERS and scratch is not None and args[-3] == scratch.data_ptr()
            else:
                assert args[-3:] == (None, None, 0) and scratch is None
            assert stream_args(x.float(), launches) == ((0, 0) * len(launches) + (None, None, 0), None)


def test_stream_shared_memory_fits_beside_the_side_tile_and_k11():
    """The body's shared memory within sm_90's 232,448 B a block (either
    instance), beside
    K2b's ring tile in a carrier launch (csrc/side_tile.cuh `ring_smem` at
    SK 1,024: bf16 and W8A8), and beside K11's attend statics (3 x 128 +
    4 + 128 x 8 floats, csrc/attend.cuh)."""
    from open_flamingo_tpu_torch.ops.dense_stream import (SIDE_MAX_K, SIDE_PASS, SIDE_ROWS, SMEM_OPTIN, STREAM_SMEM,
                                                          STREAM_SMEM_SMALL, stream_ring)

    for b in STREAM_BATCHES:
        for gated in (False, True):
            stages, ring, smem = stream_ring(b, gated)
            assert smem == (STREAM_SMEM_SMALL if b <= 8 else STREAM_SMEM) <= SMEM_OPTIN
            assert ring == 16 * stages * 2048 * (2 if gated else 1) and ring + 32 * 1024 <= smem
            assert stages * (2 if gated else 1) == (6 if b <= 8 else 4)   # the same bytes a warp either form
    for elem, stages in ((2, 3), (1, 5)):           # the bf16 and the W8A8 ring tile
        side = 1024 + SIDE_ROWS * SIDE_MAX_K * elem + stages * SIDE_PASS * 128 + SIDE_ROWS * 4
        assert max(STREAM_SMEM, side) <= 227 * 1024 <= SMEM_OPTIN
    assert STREAM_SMEM + (3 * 128 + 4 + 128 * 8) * 4 <= SMEM_OPTIN
    assert STREAM_SMEM_SMALL <= SMEM_OPTIN                  # the B <= 8 instance's deeper ring
