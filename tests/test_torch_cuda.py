"""The port's CUDA kernels against their plain versions on the card (the
wrappers on CPU copies of the same tensors).

Marked `gpu`; they skip without a CUDA card. This file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

fp32 inputs: the kernels and the plain versions sum in different orders,
~1e-6 apart at these sizes; atol 5e-5 as in chip_smoke.py (the backward
K4b/K5b: atol = rtol = 1e-4, its sums run over whole query and key tiles).
bf16 inputs (K1, K2 and K3's and K6's projections, whose bf16 products run
on tensor cores at any K, every row up to 64 in one pass; K4/K5, whose bf16
body runs on tensor cores with P.V in fp32 through a hi/lo bf16 pair;
K4b/K5b): both round an fp32 result to bf16, one ulp apart at most, plus
the summation order; atol = rtol = 1e-2 as in
chip_smoke.py; the logsumexp (fp32 in both) atol 1e-4, rtol 1e-5 (LSE_TOL).
The RMSNorm prologue, the activations and K2's SwiGLU form (llama, OPT)
take the same tolerances, and so do the ViT's K9 and K10, the absorbed ViT's
K8 and the side tiles in x's dtype (K2b on K2, K2b-attn on K3). The W8A8
side tile (K2b int8) rounds the same int32 sums as its plain version at the
same points: beyond those tolerances it may differ by one int8 step of each
activation within 1e-3 of a rounding boundary (`w8a8_close`). Quantized decode (int8 / packed int4 weights, the
int8 cache): the same
tolerances, 2e-4 in fp32 where an int8 cache is read (a quantized entry at
a rounding boundary may land one step apart when the new token's K/V come
from a projection summed in another order: at most one step, in at most
0.1% of the entries); K3's fp32 y over an int8 cache is held to 5e-5
against the plain version over the caches the kernel wrote
(`test_attn_block_decode_int8_cache_step_by_step`).
"""

import pytest
import torch

from open_flamingo_tpu_torch.models.decoders.common import quantize_kv
from open_flamingo_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update
from open_flamingo_tpu_torch.ops.decode_layer import attend_out_decode, attn_block_decode
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp, reference_side_tile
from open_flamingo_tpu_torch.ops.fused_layer import fused_layer_decode
from open_flamingo_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_fma, flash_attention_forward,
    reference_attention, reference_attention_backward)
from open_flamingo_tpu_torch.ops.masked_xattn import (
    masked_xattn, masked_xattn_backward, masked_xattn_backward_fma, masked_xattn_forward, reference_masked_xattn,
    reference_masked_xattn_backward)
from open_flamingo_tpu_torch.ops.layer_norm import layer_norm
from open_flamingo_tpu_torch.ops import w8a8
from open_flamingo_tpu_torch.ops.vit_attention import flat_vit_attention, vit_attention, vit_attention_heads
from open_flamingo_tpu_torch.quantize import pack_int4, quantize_weight

pytestmark = pytest.mark.gpu
ATOL = 5e-5
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def rn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


def close(got, want):
    tol = dict(atol=ATOL, rtol=0) if got.dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_flash_attention(gen, q_offset):
    bh, tq, s, d = 4, 24, 37, 64
    q, k, v = rn(gen, bh, tq, d), rn(gen, bh, s, d), rn(gen, bh, s, d)
    pad = torch.ones(bh, s, dtype=torch.bool, device="cuda")
    pad[0, :3] = False
    pad[1] = False
    slopes = rn(gen, bh, 1).abs()
    args = (pad, slopes, q_offset, True, 0.125)
    close(flash_attention(q, k, v, *args), flash_attention(q.cpu(), k.cpu(), v.cpu(), *(a.cpu() for a in args[:2]), *args[2:]))


def test_masked_xattn(gen):
    bh, tq, s, d = 4, 24, 32, 64
    q, k, v = rn(gen, bh, tq, d), rn(gen, bh, s, d), rn(gen, bh, s, d)
    tt = torch.randint(0, 3, (bh, tq), generator=gen, device="cuda", dtype=torch.int32)
    close(masked_xattn(q, k, v, tt, 16, 0.125), masked_xattn(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), 16, 0.125))


def test_decode_attention_update(gen):
    b, h, s, d, slot = 2, 4, 37, 128, 7
    kc, vc, q, kn, vn = rn(gen, b, h, s, d), rn(gen, b, h, s, d), rn(gen, b, h, d), rn(gen, b, h, d), rn(gen, b, h, d)
    m = torch.ones(b, s, dtype=torch.bool, device="cuda")
    m[1] = False
    want, kw, vw = decode_attention_update(q.cpu(), kc.cpu(), vc.cpu(), kn.cpu(), vn.cpu(), m.cpu(), slot, scale=0.125)
    got, _, _ = decode_attention_update(q, kc, vc, kn, vn, m, slot, scale=0.125)
    close(got, want)
    assert torch.equal(kc.cpu(), kw) and torch.equal(vc.cpu(), vw)
    close(decode_attention(q, kc, vc, m, scale=0.125), want)


DTYPES = [torch.float32, torch.bfloat16]
# K7's split plan: S from one key to 4,096, ragged, on either side of a
# 64-key tile, every cluster size 1-8 (256 / 384 / ... / 1,024 keys at Dh
# 128 in bf16) and chunks that grow past 8 splits
K7_S = [1, 5, 63, 64, 65, 129, 200, 256, 257, 384, 511, 640, 767, 896, 1024, 1100, 2047, 2048, 4096]


def k7_inputs(gen, b, h, s, d, dtype, slopes=True):
    """q, k, v, a left-padded mask (row 0 by a third of S, the last row's
    keys past 3/4 of S masked) and ALiBi slopes, on the card."""
    q, k, v = (x.to(dtype) for x in (rn(gen, b, h, d), rn(gen, b, h, s, d), rn(gen, b, h, s, d)))
    m = torch.ones(b, s, dtype=torch.bool, device="cuda")
    m[0, : s // 3] = False
    m[-1, max(1, 3 * s // 4):] = False
    sl = rn(gen, h).abs() * 0.1 if slopes else None
    return q, k, v, m, sl


def k7_plain(q, k, v, m, sl, scale):
    return decode_attention(q.cpu(), k.cpu(), v.cpu(), m.cpu(), scale=scale, slopes=None if sl is None else sl.cpu())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("s", K7_S)
def test_decode_attention_split(gen, s, d, dtype):
    q, k, v, m, sl = k7_inputs(gen, 2, 3, s, d, dtype)
    close(decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl), k7_plain(q, k, v, m, sl, d**-0.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,offset", [(1, 0), (7, 0), (33, 0), (64, 1), (128, 3)])
@pytest.mark.parametrize("s", [37, 300, 2048])
def test_decode_attention_unaligned_rows(gen, s, d, offset, dtype):
    """Rows that are not 16-byte aligned (Dh x size % 16 != 0, or a cache
    view `offset` elements into its storage): the block stages the tiles
    itself, into zero-padded rows."""
    q, k0, v0, m, sl = k7_inputs(gen, 2, 3, s, d, dtype)
    k, v = (torch.empty(x.numel() + offset, dtype=dtype, device="cuda")[offset:].view(x.shape) for x in (k0, v0))
    k.copy_(k0)
    v.copy_(v0)
    close(decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl), k7_plain(q, k0, v0, m, sl, d**-0.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [64, 300, 2048])
def test_decode_attention_rows_alone_and_repeats(gen, s, dtype):
    """1,024 (b, h) instances: repeats give the same bits, and a row alone
    (B = H = 1) the bits it gives in the batch; the update likewise."""
    b, h, d = 32, 32, 128
    q, k, v, m, sl = k7_inputs(gen, b, h, s, d, dtype)
    out = decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl)
    assert torch.equal(decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl), out)
    for bi, hi in [(0, 0), (5, 17), (31, 31)]:
        one = decode_attention(q[bi:bi + 1, hi:hi + 1].contiguous(), k[bi:bi + 1, hi:hi + 1].contiguous(),
                               v[bi:bi + 1, hi:hi + 1].contiguous(), m[bi:bi + 1], scale=d**-0.5, slopes=sl[hi:hi + 1])
        assert torch.equal(one[0, 0], out[bi, hi]), (bi, hi)
    slot = s - 1
    kn, vn = rn(gen, b, h, d).to(dtype), rn(gen, b, h, d).to(dtype)
    outs = [decode_attention_update(q, k.clone(), v.clone(), kn, vn, m, slot, scale=d**-0.5, slopes=sl)[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    one = decode_attention_update(q[5:6, 17:18].contiguous(), k[5:6, 17:18].clone(), v[5:6, 17:18].clone(),
                                  kn[5:6, 17:18].contiguous(), vn[5:6, 17:18].contiguous(), m[5:6], slot,
                                  scale=d**-0.5, slopes=sl[17:18])[0]
    assert torch.equal(one[0, 0], outs[0][5, 17])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [64, 256, 384, 512, 640, 768, 896, 1024, 2048, 4096])
def test_decode_attention_masked_chunks_and_nan_rows(gen, s, dtype):
    """At every cluster size: a row with no valid key gives exact zeros; a
    row whose first chunks hold no valid key, and one valid key alone, come
    out right; NaN written into every masked K/V row never reaches the
    output (finite, and the bits of the output with those rows zeroed)."""
    b, h, d = 4, 2, 128
    q, k, v, m, sl = k7_inputs(gen, b, h, s, d, dtype)
    m[1] = False                      # no valid key
    m[2, : s - 1] = False             # the last key alone
    m[0, : 3 * s // 4] = False        # the first chunks empty
    out = decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl)
    assert (out[1] == 0).all()
    close(out, k7_plain(q, k, v, m, sl, d**-0.5))
    masked = ~m[:, None, :, None]
    kn_, vn_ = k.masked_fill(masked, float("nan")), v.masked_fill(masked, float("nan"))
    kz, vz = k.masked_fill(masked, 0.0), v.masked_fill(masked, 0.0)
    got = decode_attention(q, kn_, vn_, m, scale=d**-0.5, slopes=sl)
    assert torch.isfinite(got).all()
    assert torch.equal(got, decode_attention(q, kz, vz, m, scale=d**-0.5, slopes=sl))
    assert (got[1] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,slot", [(100, 0), (100, 63), (100, 64), (100, 99), (2048, 0), (2048, 255), (2048, 256),
                                    (2048, 2047), (4096, 511), (4096, 512)])
def test_decode_attention_update_slots(gen, s, slot, dtype):
    """The slot at 0, S - 1 and either side of a tile and a chunk boundary:
    the cache is bit for bit the plain write (no other slot moves), the
    output is the plain version's and has the bits of `decode_attention`
    over the written cache; the unwritten slots past it hold NaN."""
    b, h, d = 2, 3, 128
    q, k, v, m, sl = k7_inputs(gen, b, h, s, d, dtype)
    m[:, slot + 1:] = False
    m[:, slot] = True
    k[:, :, slot + 1:] = float("nan")
    v[:, :, slot + 1:] = float("nan")
    kn, vn = rn(gen, b, h, d).to(dtype), rn(gen, b, h, d).to(dtype)
    kw, vw = k.cpu(), v.cpu()
    kw[:, :, slot], vw[:, :, slot] = kn.cpu(), vn.cpu()
    got, kc, vc = decode_attention_update(q, k, v, kn, vn, m, slot, scale=d**-0.5, slopes=sl)
    assert kc is k and vc is v
    bits = torch.int32 if dtype == torch.float32 else torch.int16      # NaN rows compared by their bits
    assert torch.equal(k.cpu().view(bits), kw.view(bits)) and torch.equal(v.cpu().view(bits), vw.view(bits))
    valid = m.cpu()[:, None, :, None]
    want = decode_attention(q.cpu(), kw.masked_fill(~valid, 0.0), vw.masked_fill(~valid, 0.0), m.cpu(),
                            scale=d**-0.5, slopes=sl.cpu())
    close(got, want)
    assert torch.isfinite(got).all()
    assert torch.equal(got, decode_attention(q, k, v, m, scale=d**-0.5, slopes=sl))


@pytest.mark.parametrize("dtype", DTYPES)
# bf16: the weight-streaming body's tensor cores at every K: a whole 64-wide
# stage, K % 32 != 0 (a zero-filled tail), a ragged 11,000 and 16,384
@pytest.mark.parametrize("k", [256, 264, 11000, 16384])
def test_fused_dense_ragged_vocab(gen, k, dtype):
    b, n = 5, 1003                             # ragged rows and vocabulary
    x, w, ln, ln_b = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, n, k) * 0.05, rn(gen, k), rn(gen, k) * 0.1))
    bias, res = (rn(gen, n) * 0.1).to(dtype), rn(gen, b, n).to(dtype)
    gate = torch.tensor([0.7], device="cuda", dtype=dtype)
    for kw in (dict(ln_scale=ln), dict(ln_scale=ln, ln_bias=ln_b, bias=bias, clip=0.5, act="gelu",
                                       gate=gate, residual=res)):
        want = fused_dense(x.cpu(), w.cpu(), **{key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()})
        close(fused_dense(x, w, **kw), want)


@pytest.mark.parametrize("dtype", DTYPES)
# bf16 on the weight-streaming body at every B up to 64 in one pass and every
# K2: 352 (no multiple of 32), 8,192, 16,384 (OF-9B's MLP, LLaMA-7B's xattn
# FF) and a ragged 11,000; fp32 on CUDA cores
@pytest.mark.parametrize("b,k2", [(8, 512), (11, 352), (3, 8192), (8, 16384), (1, 11000), (13, 16384), (16, 512),
                                  (64, 16384), (64, 11000)])
def test_fused_mlp(gen, b, k2, dtype):
    k, n = 128, 136
    x, w1, w2 = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k2, k) * 0.05, rn(gen, n, k2) * 0.05))
    ln, ln_b, res = (t.to(dtype) for t in (rn(gen, k), rn(gen, k) * 0.1, rn(gen, b, n)))
    gate = torch.tensor([-0.3], device="cuda", dtype=dtype)
    kw = dict(ln_scale=ln, ln_bias=ln_b, residual=res, gate=gate)
    want = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **{key: val.cpu() for key, val in kw.items()})
    close(fused_mlp(x, w1, w2, **kw), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("slot,s", [(0, 38), (37, 38), (300, 301)])   # S > 128 threads: keys in rounds
def test_attn_block_decode_self(gen, slot, s, dtype):
    b, h, d, dm = 3, 4, 64, 128
    x, ln = rn(gen, b, dm).to(dtype), rn(gen, dm).to(dtype)
    wqkv, wout = (rn(gen, 3 * h * d, dm) * 0.1).to(dtype), (rn(gen, dm, h * d) * 0.1).to(dtype)
    kc, vc = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[1, :3] = False
    slot_t = torch.tensor([slot], dtype=torch.int32, device="cuda")
    slopes = rn(gen, h).abs()
    kw = dict(heads=h, head_dim=d, scale=d**-0.5, fused_qkv=True, clip=0.6)
    kw_cpu = dict(kw, slot=slot_t.cpu(), slopes=slopes.cpu())
    want, kw_, vw_ = attn_block_decode(x.cpu(), ln.cpu(), None, wqkv.cpu(), wout.cpu(), kc.cpu(), vc.cpu(),
                                       mask.cpu(), **kw_cpu)
    got, _, _ = attn_block_decode(x, ln, None, wqkv, wout, kc, vc, mask, slot=slot_t, slopes=slopes, **kw)
    close(got, want)
    close(kc, kw_)
    close(vc, vw_)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
def test_attn_block_decode_gated_xattn(gen, d, dtype):
    b, h, s, dm = 3, 8, 32, 128
    x, ln, ln_b = (t.to(dtype) for t in (rn(gen, b, dm), rn(gen, dm), rn(gen, dm) * 0.1))
    wq, wout = (rn(gen, h * d, dm) * 0.1).to(dtype), (rn(gen, dm, h * d) * 0.1).to(dtype)
    k, v = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[1] = False                            # no preceding image
    gate = torch.tensor([0.5], device="cuda", dtype=dtype)
    kw = dict(heads=h, head_dim=d, scale=d**-0.5)
    want = attn_block_decode(x.cpu(), ln.cpu(), ln_b.cpu(), wq.cpu(), wout.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                             gate=gate.cpu(), **kw)
    got = attn_block_decode(x, ln, ln_b, wq, wout, k, v, mask, gate=gate, **kw)
    close(got, want)
    assert torch.equal(got[1], x[1])


@pytest.mark.parametrize("dtype", DTYPES)
# GPT-NeoX's head dim 80; GQA; the slot at S - 1; S > 128 threads: keys in rounds
@pytest.mark.parametrize("n_rep,slot,s", [(1, 40, 64), (2, 63, 64), (4, 40, 64), (1, 300, 301)])
def test_attend_out_decode(gen, n_rep, slot, s, dtype):
    """K6 with the slot write and its whole epilogue, then the q-only form;
    row 1 has no valid key."""
    b, h, d, dm = 3, 4, 80, 160
    h_kv = h // n_rep
    q, kn, vn = (rn(gen, *shape).to(dtype) for shape in ((b, h, d), (b, h_kv, d), (b, h_kv, d)))
    kc, vc = rn(gen, b, h_kv, s, d).to(dtype), rn(gen, b, h_kv, s, d).to(dtype)
    wout, bias, res = (rn(gen, dm, h * d) * 0.1).to(dtype), (rn(gen, dm) * 0.1).to(dtype), rn(gen, b, dm).to(dtype)
    gate = torch.tensor([0.5], device="cuda", dtype=dtype)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[0, :3] = False
    mask[1] = False
    slot_t = torch.tensor([slot], dtype=torch.int32, device="cuda")
    kw = dict(scale=d**-0.5, bias=bias, gate=gate, residual=res)
    cpu = {key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()}
    want, kw_, vw_ = attend_out_decode(q.cpu(), kc.cpu(), vc.cpu(), mask.cpu(), wout.cpu(), k_new=kn.cpu(),
                                       v_new=vn.cpu(), slot=slot_t.cpu(), **cpu)
    got, _, _ = attend_out_decode(q, kc, vc, mask, wout, k_new=kn, v_new=vn, slot=slot_t, **kw)
    close(got, want)
    assert torch.equal(kc.cpu(), kw_) and torch.equal(vc.cpu(), vw_)
    got = attend_out_decode(q, kc, vc, mask, wout, scale=d**-0.5)
    close(got, attend_out_decode(q.cpu(), kw_, vw_, mask.cpu(), wout.cpu(), scale=d**-0.5))
    assert (got[1] == 0).all()


def stored_as(w, kind, dtype):
    """A float weight as K3/K6 stream it: (weight, scale) in x's dtype, int8
    or packed int4."""
    if kind == "float":
        return w.to(dtype), None
    return quantized(w, 8 if kind == "int8" else 4)


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("fused_qkv", [True, False])
@pytest.mark.parametrize("b", [1, 8, 13, 64])
def test_attn_block_decode_bf16_any_batch(gen, b, fused_qkv, kind):
    """bf16 K3, both forms, its projections on the weight-streaming body
    (K split into slices at these widths; past 8 rows the split is added by
    its second launch) against the plain version at B 1, 8, 13 and 64; and
    row 5 of the batches of 13 and 64 called alone gives the bits of y and
    of the written caches it gives in the batch."""
    dtype, dm, h, d, s, slot = torch.bfloat16, 512, 8, 64, 48, 40
    inner = h * d
    x, ln = rn(gen, b, dm).to(dtype), (1 + 0.1 * rn(gen, dm)).to(dtype)
    ln_b = None if fused_qkv else (0.1 * rn(gen, dm)).to(dtype)
    wq, sq = stored_as(rn(gen, (3 if fused_qkv else 1) * inner, dm) * dm**-0.5, kind, dtype)
    wout, so = stored_as(rn(gen, dm, inner) * inner**-0.5, kind, dtype)
    k0, v0 = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    kw = dict(heads=h, head_dim=d, scale=d**-0.5, wq_scale=sq, wout_scale=so)
    if fused_qkv:
        mask[:, slot + 1:] = False
        mask[b // 2, :3] = False
        kw.update(fused_qkv=True, clip=2.0, slopes=rn(gen, h).abs(),
                  slot=torch.tensor([slot], dtype=torch.int32, device="cuda"))
    else:
        mask[b // 2] = False                   # no preceding image: y == x
        kw.update(gate=torch.tensor([0.5], device="cuda", dtype=dtype))

    def call(rows, device="cuda"):
        kc, vc = k0[rows].clone(), v0[rows].clone()
        args = [t if device == "cuda" or t is None else t.cpu()
                for t in (x[rows], ln, ln_b, wq, wout, kc, vc, mask[rows])]
        out = attn_block_decode(*args, **(kw if device == "cuda" else on_cpu(kw)))
        return out if fused_qkv else (out, args[5], args[6])

    got, want = call(slice(None)), call(slice(None), "cpu")
    for g, w in zip(got, want):
        close(g, w)
    if not fused_qkv:
        assert torch.equal(got[0][b // 2], x[b // 2])
    if b > 8:
        alone = call(slice(5, 6))
        assert all(torch.equal(a, g[5:6]) for a, g in zip(alone, got))


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("b", [1, 8, 13, 64])
def test_attend_out_decode_bf16_any_batch(gen, b, kind):
    """bf16 K6 (slot write, GQA, the whole epilogue), its out-projection on
    the weight-streaming body, against the plain version at B 1, 8, 13 and
    64; row 5 of the batches of 13 and 64 alone gives its bits of y and of
    the written caches."""
    dtype, h, h_kv, d, dm, s, slot = torch.bfloat16, 8, 4, 80, 640, 48, 40
    q, kn, vn = (rn(gen, *shape).to(dtype) for shape in ((b, h, d), (b, h_kv, d), (b, h_kv, d)))
    k0, v0 = rn(gen, b, h_kv, s, d).to(dtype), rn(gen, b, h_kv, s, d).to(dtype)
    wout, so = stored_as(rn(gen, dm, h * d) * (h * d) ** -0.5, kind, dtype)
    bias, res = (0.1 * rn(gen, dm)).to(dtype), rn(gen, b, dm).to(dtype)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[b // 2, :3] = False
    kw = dict(scale=d**-0.5, wout_scale=so, bias=bias, gate=torch.tensor([0.5], device="cuda", dtype=dtype),
              slot=torch.tensor([slot], dtype=torch.int32, device="cuda"))

    def call(rows, device="cuda"):
        ops = [t[rows].clone() for t in (q, k0, v0, mask, kn, vn, res)]
        if device == "cpu":
            ops = [t.cpu() for t in ops]
        qq, kc, vc, m, kn_, vn_, r = ops
        return attend_out_decode(qq, kc, vc, m, wout if device == "cuda" else wout.cpu(), k_new=kn_, v_new=vn_,
                                 residual=r, **(kw if device == "cuda" else on_cpu(kw)))

    got, want = call(slice(None)), call(slice(None), "cpu")
    close(got[0], want[0])
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    if b > 8:
        alone = call(slice(5, 6))
        assert all(torch.equal(a, g[5:6]) for a, g in zip(alone, got))


def quantized(w, bits):
    """A float weight's stored form for `bits` (int8, or packed int4) and its scale."""
    q, s = quantize_weight(w.float(), bits)
    return (q if bits == 8 else pack_int4(q)), s


def int8_cache(gen, *shape):
    """(int8 cache, its (B, H, S) fp32 scales) from random rows."""
    return quantize_kv(rn(gen, *shape))


def cache_close(got, want):
    """int8 caches: equal but for entries one step apart at a rounding
    boundary, at most 0.1% of them."""
    diff = (got.cpu().int() - want.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
# bf16: int rows 16-byte aligned (256, 16,384), 8- or 4-byte aligned (264, 11,000: the ring's narrower copies)
@pytest.mark.parametrize("k", [256, 264, 11000, 16384])
def test_fused_dense_quantized(gen, k, bits, dtype):
    b, n = 5, 1003
    x, ln, ln_b = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k), rn(gen, k) * 0.1))
    w, s = quantized(rn(gen, n, k) * 0.05, bits)
    bias, res = (rn(gen, n) * 0.1).to(dtype), rn(gen, b, n).to(dtype)
    gate = torch.tensor([0.7], device="cuda", dtype=dtype)
    kw = dict(w_scale=s, ln_scale=ln, ln_bias=ln_b, bias=bias, clip=0.5, act="gelu", gate=gate, residual=res)
    want = fused_dense(x.cpu(), w.cpu(), **{key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()})
    n0 = fused_dense.variants.get("int8" if bits == 8 else "int4", 0)
    close(fused_dense(x, w, **kw), want)
    assert fused_dense.variants["int8" if bits == 8 else "int4"] == n0 + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,k2", [(8, 512), (11, 352), (13, 11000), (64, 16384), (1, 16384)])
def test_fused_mlp_quantized(gen, b, k2, bits, dtype):
    k, n = 128, 136
    x = rn(gen, b, k).to(dtype)
    (w1, s1), (w2, s2) = quantized(rn(gen, k2, k) * 0.05, bits), quantized(rn(gen, n, k2) * 0.05, bits)
    ln, ln_b, res = (t.to(dtype) for t in (rn(gen, k), rn(gen, k) * 0.1, rn(gen, b, n)))
    b1, b2 = (rn(gen, k2) * 0.1).to(dtype), (rn(gen, n) * 0.1).to(dtype)
    gate = torch.tensor([-0.3], device="cuda", dtype=dtype)
    kw = dict(w1_scale=s1, w2_scale=s2, b1=b1, b2=b2, ln_scale=ln, ln_bias=ln_b, residual=res, gate=gate)
    want = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **{key: val.cpu() for key, val in kw.items()})
    close(fused_mlp(x, w1, w2, **kw), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("slot,s", [(0, 38), (37, 38), (300, 301)])
def test_attn_block_decode_int8_cache(gen, slot, s, bits, dtype):
    """K3 fused QKV over an int8 cache with int weights: the output, the
    written int8 rows and their scales; row 1 left-padded."""
    b, h, d, dm = 3, 4, 64, 128
    x, ln = rn(gen, b, dm).to(dtype), rn(gen, dm).to(dtype)
    (wqkv, sq), (wout, so) = quantized(rn(gen, 3 * h * d, dm) * 0.1, bits), quantized(rn(gen, dm, h * d) * 0.1, bits)
    (kc, ks), (vc, vs) = int8_cache(gen, b, h, s, d), int8_cache(gen, b, h, s, d)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[1, :3] = False
    slot_t = torch.tensor([slot], dtype=torch.int32, device="cuda")
    slopes = rn(gen, h).abs()
    kw = dict(heads=h, head_dim=d, scale=d**-0.5, fused_qkv=True, clip=0.6, wq_scale=sq, wout_scale=so)
    cpu = {key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()}
    kc_p, vc_p, ks_p, vs_p = (t.cpu() for t in (kc, vc, ks, vs))
    want, _, _ = attn_block_decode(x.cpu(), ln.cpu(), None, wqkv.cpu(), wout.cpu(), kc_p, vc_p, mask.cpu(),
                                   slot=slot_t.cpu(), slopes=slopes.cpu(), k_scale=ks_p, v_scale=vs_p, **cpu)
    got, _, _ = attn_block_decode(x, ln, None, wqkv, wout, kc, vc, mask, slot=slot_t, slopes=slopes, k_scale=ks,
                                  v_scale=vs, **kw)
    tol = dict(atol=2e-4, rtol=0) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.cpu(), want, **tol)
    cache_close(kc, kc_p)
    cache_close(vc, vc_p)
    torch.testing.assert_close(ks.cpu(), ks_p, atol=0, rtol=1e-6 if dtype == torch.float32 else 1e-2)
    torch.testing.assert_close(vs.cpu(), vs_p, atol=0, rtol=1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attn_block_decode_int8_cache_step_by_step(gen, seed, bits):
    """fp32 K3 over an int8 cache at OF-3B's self-attention widths (D 2048,
    16 heads of 128, slot 40 of 64, B 8) with int weights, at three
    generator seeds: y within 5e-5 of the plain version over the caches as
    the kernel wrote them (the q-only form over them: both attend to the
    same new-token row), and the written slot row within one int8 step of
    the plain version's own, its scales within 1e-5."""
    gen.manual_seed(seed)
    b, h, d, dm, s, slot = 8, 16, 128, 2048, 64, 40
    inner = h * d
    x, ln = rn(gen, b, dm), 1 + 0.1 * rn(gen, dm)
    wqkv, sq = quantized(rn(gen, 3 * inner, dm) * dm**-0.5, bits)
    wout, so = quantized(rn(gen, dm, inner) * inner**-0.5, bits)
    (kc, ks), (vc, vs) = int8_cache(gen, b, h, s, d), int8_cache(gen, b, h, s, d)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[0, :4] = mask[1, :7] = False
    kw = dict(heads=h, head_dim=d, scale=d**-0.5, slopes=rn(gen, h).abs(), wout_scale=so)
    cpu = on_cpu(kw)
    originals = [t.cpu() for t in (kc, vc, ks, vs)]
    got, _, _ = attn_block_decode(x, ln, None, wqkv, wout, kc, vc, mask, fused_qkv=True, wq_scale=sq, k_scale=ks,
                                  v_scale=vs, slot=torch.tensor([slot], dtype=torch.int32, device="cuda"), **kw)
    want = attn_block_decode(x.cpu(), ln.cpu(), None, wqkv[:inner].cpu(), wout.cpu(), kc.cpu(), vc.cpu(), mask.cpu(),
                             wq_scale=sq[:inner].cpu(), k_scale=ks.cpu(), v_scale=vs.cpu(), **cpu)
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
    kp, vp, ksp, vsp = (t.clone() for t in originals)
    attn_block_decode(x.cpu(), ln.cpu(), None, wqkv.cpu(), wout.cpu(), kp, vp, mask.cpu(), fused_qkv=True,
                      wq_scale=sq.cpu(), k_scale=ksp, v_scale=vsp, slot=torch.tensor([slot], dtype=torch.int32), **cpu)
    cache_close(kc, kp)
    cache_close(vc, vp)
    torch.testing.assert_close(ks.cpu(), ksp, atol=0, rtol=1e-5)
    torch.testing.assert_close(vs.cpu(), vsp, atol=0, rtol=1e-5)
    others = torch.arange(s) != slot
    assert torch.equal(kc.cpu()[:, :, others], originals[0][:, :, others])


@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block_decode_int8_media(gen, dtype):
    """K3 q-only over an int8 media cache with int8 weights; row 1 has no
    valid key (y == x); the cache is read only."""
    b, h, d, s, dm = 3, 8, 64, 32, 128
    x, ln, ln_b = (t.to(dtype) for t in (rn(gen, b, dm), rn(gen, dm), rn(gen, dm) * 0.1))
    (wq, sq), (wout, so) = quantized(rn(gen, h * d, dm) * 0.1, 8), quantized(rn(gen, dm, h * d) * 0.1, 8)
    (k, ks), (v, vs) = int8_cache(gen, b, h, s, d), int8_cache(gen, b, h, s, d)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[1] = False
    gate = torch.tensor([0.5], device="cuda", dtype=dtype)
    kw = dict(heads=h, head_dim=d, scale=d**-0.5, gate=gate, wq_scale=sq, wout_scale=so, k_scale=ks, v_scale=vs)
    cpu = {key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()}
    k0 = k.clone()
    want = attn_block_decode(x.cpu(), ln.cpu(), ln_b.cpu(), wq.cpu(), wout.cpu(), k.cpu(), v.cpu(), mask.cpu(), **cpu)
    got = attn_block_decode(x, ln, ln_b, wq, wout, k, v, mask, **kw)
    close(got, want)
    assert torch.equal(got[1], x[1]) and torch.equal(k, k0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n_rep,slot,s", [(1, 0, 64), (2, 63, 64), (4, 40, 64), (1, 300, 301)])
def test_attend_out_decode_int8_cache(gen, n_rep, slot, s, bits, dtype):
    """K6 over an int8 cache with an int Wout and its whole epilogue: GQA,
    the slot at 0 and S - 1, keys in rounds; row 1 has no valid key. The new
    K/V arrive as the same values on both sides, so the written int8 rows
    and scales are exactly equal."""
    b, h, d, dm = 3, 4, 80, 160
    h_kv = h // n_rep
    q, kn, vn = (rn(gen, *shape).to(dtype) for shape in ((b, h, d), (b, h_kv, d), (b, h_kv, d)))
    (kc, ks), (vc, vs) = int8_cache(gen, b, h_kv, s, d), int8_cache(gen, b, h_kv, s, d)
    wout, so = quantized(rn(gen, dm, h * d) * 0.1, bits)
    bias, res = (rn(gen, dm) * 0.1).to(dtype), rn(gen, b, dm).to(dtype)
    gate = torch.tensor([0.5], device="cuda", dtype=dtype)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, : slot + 1] = True
    mask[1] = False
    slot_t = torch.tensor([slot], dtype=torch.int32, device="cuda")
    kw = dict(scale=d**-0.5, wout_scale=so, bias=bias, gate=gate, residual=res, k_new=kn, v_new=vn, slot=slot_t)
    cpu = {key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()}
    kc_p, vc_p, ks_p, vs_p = (t.cpu() for t in (kc, vc, ks, vs))
    want, _, _ = attend_out_decode(q.cpu(), kc_p, vc_p, mask.cpu(), wout.cpu(), k_scale=ks_p, v_scale=vs_p, **cpu)
    got, _, _ = attend_out_decode(q, kc, vc, mask, wout, k_scale=ks, v_scale=vs, **kw)
    tol = dict(atol=2e-4, rtol=0) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.cpu(), want, **tol)
    for g, w in ((kc, kc_p), (vc, vc_p), (ks, ks_p), (vs, vs_p)):
        assert torch.equal(g.cpu(), w)


def close_grad(got, want):
    tol = dict(atol=1e-4, rtol=1e-4) if got.dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,s,q_offset", [(24, 37, 0), (32, 64, 16), (70, 70, 0)])
def test_flash_attention_lse_and_backward(gen, tq, s, q_offset, dtype):
    """K4 with lse, then K4b from the plain forward's out and lse, against
    the plain versions; left padding, an all-masked sequence, ragged S."""
    bh, d = 4, 128
    q, k, v, do = (rn(gen, *shape).to(dtype) for shape in ((bh, tq, d), (bh, s, d), (bh, s, d), (bh, tq, d)))
    pad = torch.ones(bh, s, dtype=torch.bool, device="cuda")
    pad[:, q_offset + tq:] = False
    pad[0, :3] = False
    pad[1] = False
    slopes = rn(gen, bh, 1).abs()
    args = (pad, slopes, q_offset, True, d**-0.5)
    cpu = lambda *ts: [t.cpu() for t in ts]
    out, lse = flash_attention_forward(q, k, v, *args, with_lse=True)
    want_out, want_lse = reference_attention(*cpu(q, k, v, pad, slopes), *args[2:], with_lse=True)
    close(out, want_out)
    torch.testing.assert_close(lse.cpu(), want_lse, atol=1e-4, rtol=1e-5)
    assert (lse[1] == 0).all()
    got = flash_attention_backward(q, k, v, *args[:3], want_out.cuda(), want_lse.cuda(), do, *args[3:])
    want = flash_attention_backward(*cpu(q, k, v, pad, slopes), q_offset, want_out, want_lse, do.cpu(), *args[3:])
    for g, w in zip(got, want):
        close_grad(g, w)
    assert (got[0][1] == 0).all() and (got[1][1] == 0).all() and (got[2][1] == 0).all()
    assert (got[1][0, :3] == 0).all() and (got[2][0, :3] == 0).all()
    if q_offset == 0:
        assert (got[0][0, :3] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,t_img", [(32, 1), (40, 6)])
def test_masked_xattn_lse_and_backward(gen, tq, t_img, dtype):
    """K5 with lse and K5b; rows 0..1 come before any image."""
    bh, d, n_lat = 4, 64, 64
    s = t_img * n_lat
    q, k, v, do = (rn(gen, *shape).to(dtype) for shape in ((bh, tq, d), (bh, s, d), (bh, s, d), (bh, tq, d)))
    loc = torch.zeros(bh, tq, dtype=torch.int32, device="cuda")
    loc[:, 2 + torch.arange(t_img, device="cuda") * 6] = 1
    tt = torch.cumsum(loc, 1).to(torch.int32)
    out, lse = masked_xattn_forward(q, k, v, tt, n_lat, d**-0.5, with_lse=True)
    want_out, want_lse = reference_masked_xattn(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), n_lat, d**-0.5, with_lse=True)
    close(out, want_out)
    torch.testing.assert_close(lse.cpu(), want_lse, atol=1e-4, rtol=1e-5)
    got = masked_xattn_backward(q, k, v, tt, n_lat, want_out.cuda(), want_lse.cuda(), do, d**-0.5)
    want = masked_xattn_backward(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), n_lat, want_out, want_lse, do.cpu(), d**-0.5)
    for g, w in zip(got, want):
        close_grad(g, w)
    assert (got[0][:, :2] == 0).all() and (lse[:, :2] == 0).all()


def test_attention_functions_backward_through_autograd(gen):
    """flash_attention and masked_xattn under autograd on the card take the
    kernels both ways (launch counters) and agree with the plain versions'
    autograd on the CPU."""
    bh, tq, d = 4, 32, 64
    q, k, v, do = rn(gen, bh, tq, d), rn(gen, bh, tq, d), rn(gen, bh, tq, d), rn(gen, bh, tq, d)
    pad, slopes = torch.ones(bh, tq, dtype=torch.bool, device="cuda"), rn(gen, bh, 1).abs()
    tt = torch.ones(bh, tq, dtype=torch.int32, device="cuda")
    for fn, extra, bwd in ((flash_attention, (pad, slopes, 0, True, 0.125), flash_attention_backward),
                           (masked_xattn, (tt, 16, 0.125), masked_xattn_backward)):
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
            n = bwd.launches
            (fn(*leaves, *(a.to(dev) if torch.is_tensor(a) else a for a in extra)) * do.to(dev)).sum().backward()
            assert bwd.launches == n + (dev == "cuda")
            grads.append([leaf.grad for leaf in leaves])
        for g, w in zip(*grads):
            close_grad(g, w)



def hold_forward(out, lse, want_out, want_lse, zero_rows):
    """bf16 out and fp32 lse against the plain version's; rows with no
    valid key exactly zero, their lse 0."""
    close(out, want_out)
    torch.testing.assert_close(lse.cpu(), want_lse, **LSE_TOL)
    assert (out.cpu()[zero_rows] == 0).all() and (lse.cpu()[zero_rows] == 0).all()


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,s,q_offset,causal", [
    (1, 37, 36, True), (15, 70, 0, True), (17, 81, 16, True), (64, 64, 0, True), (65, 130, 65, True),
    (257, 257, 0, True), (33, 100, 0, False)])
def test_flash_attention_tensor_core_body(gen, d, tq, s, q_offset, causal):
    """K4's bf16 body (tensor cores) against the plain version: Dh 16 to 128
    (80 padded to its 16-column steps), Tq across the warps' 16-row tiles,
    ragged S over several 64-key tiles with the causal ones skipped,
    q_offset, left padding and a sequence with every key masked."""
    bh = 4
    q, k, v = (rn(gen, bh, n, d).to(torch.bfloat16) for n in (tq, s, s))
    pad = torch.ones(bh, s, dtype=torch.bool, device="cuda")
    pad[0, :3] = False
    pad[1] = False
    pad[2, q_offset + tq:] = False
    slopes = rn(gen, bh, 1).abs()
    args = (pad, slopes, q_offset, causal, d**-0.5)
    out, lse = flash_attention_forward(q, k, v, *args, with_lse=True)
    want_out, want_lse = reference_attention(q.cpu(), k.cpu(), v.cpu(), pad.cpu(), slopes.cpu(), *args[2:],
                                             with_lse=True)
    qpos = q_offset + torch.arange(tq)[:, None]
    allowed = pad.cpu()[:, None, :] & ((torch.arange(s)[None, :] <= qpos) | (not causal))[None]
    zero_rows = ~allowed.any(-1)
    assert zero_rows[1].all() and (causal and q_offset == 0) <= bool(zero_rows[0, :3].all())
    hold_forward(out, lse, want_out, want_lse, zero_rows)


def media_text_time(gen, bh, tq, t_img):
    """(BH, Tq) text_time: row 0 before any image for two tokens, then a new
    image every three tokens (query tiles spanning up to 6 images); row 1
    before any image throughout; row 2 the images spread evenly over the
    prompt; row 3 at random in [0, t_img]."""
    rows = torch.arange(tq, device="cuda")
    tt = torch.zeros(bh, tq, dtype=torch.int32, device="cuda")
    tt[0] = ((rows - 2).div(3, rounding_mode="floor") + 1).clamp(0, t_img)
    tt[2] = (rows // max(1, -(-tq // t_img)) + 1).clamp(max=t_img)
    tt[3] = torch.randint(0, t_img + 1, (tq,), generator=gen, device="cuda")
    return tt


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,t_img,n_lat", [
    (1, 1, 64), (15, 2, 64), (17, 6, 64), (64, 6, 64), (65, 2, 20), (257, 6, 64), (40, 6, 20), (33, 1, 64)])
def test_masked_xattn_tensor_core_body(gen, d, tq, t_img, n_lat):
    """K5's bf16 body (tensor cores) against the plain version: query tiles
    whose rows see 1, 2 or up to 6 images (the key tiles it loads are
    [(t_min - 1) n_lat, t_max n_lat) of its rows' nonzero text_time), rows
    with text_time 0 exactly zero, n_lat 64 (one key tile per image) and 20
    (images across tile edges)."""
    bh = 4
    s = t_img * n_lat
    q, k, v = (rn(gen, bh, n, d).to(torch.bfloat16) for n in (tq, s, s))
    tt = media_text_time(gen, bh, tq, t_img)
    out, lse = masked_xattn_forward(q, k, v, tt, n_lat, d**-0.5, with_lse=True)
    want_out, want_lse = reference_masked_xattn(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), n_lat, d**-0.5,
                                                with_lse=True)
    zero_rows = tt.cpu() == 0
    assert zero_rows[1].all()
    hold_forward(out, lse, want_out, want_lse, zero_rows)


def hold_backward(grads, want, allowed):
    """bf16 dq, dk, dv against the plain version's; dq of rows that see no
    key and dk, dv of keys no query sees exactly zero."""
    for g, w in zip(grads, want):
        close_grad(g, w)
    zero_q, zero_k = ~allowed.any(-1), ~allowed.any(1)
    dq, dk, dv = (g.cpu() for g in grads)
    assert (dq[zero_q] == 0).all() and (dk[zero_k] == 0).all() and (dv[zero_k] == 0).all()


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,s,q_offset,causal", [
    (1, 37, 36, True), (15, 70, 0, True), (17, 81, 16, True), (64, 64, 0, True), (65, 130, 65, True),
    (257, 257, 0, True), (33, 100, 0, False)])
def test_flash_attention_backward_tensor_core_body(gen, d, tq, s, q_offset, causal):
    """K4b's bf16 body (tensor cores) and its FMA yardstick against the plain
    version, from the plain forward's out and lse: Dh 16 to 128 (80 padded
    to its 16-column steps), Tq across the warps' 16-row tiles and the dkv
    kernel's 64-query tiles, ragged S over several 64-key tiles, q_offset,
    left padding, a sequence with every key masked (its lse 0) and keys
    past the last query."""
    bh = 4
    q, k, v, do = (rn(gen, bh, n, d).to(torch.bfloat16) for n in (tq, s, s, tq))
    pad = torch.ones(bh, s, dtype=torch.bool, device="cuda")
    pad[0, :3] = False
    pad[1] = False
    pad[2, q_offset + tq:] = False
    slopes = rn(gen, bh, 1).abs()
    args = (pad.cpu(), slopes.cpu(), q_offset)
    out, lse = reference_attention(q.cpu(), k.cpu(), v.cpu(), *args, causal, d**-0.5, with_lse=True)
    want = reference_attention_backward(q.cpu(), k.cpu(), v.cpu(), *args, out, lse, do.cpu(), causal, d**-0.5)
    qpos = q_offset + torch.arange(tq)[:, None]
    allowed = pad.cpu()[:, None, :] & ((torch.arange(s)[None, :] <= qpos) | (not causal))[None]
    assert (~allowed.any(-1))[1].all() and (~allowed.any(1))[1].all()
    for fn in (flash_attention_backward, flash_attention_backward_fma):
        n = flash_attention_backward.launches
        grads = fn(q, k, v, pad, slopes, q_offset, out.cuda(), lse.cuda(), do, causal, d**-0.5)
        torch.cuda.synchronize()
        assert flash_attention_backward.launches == n + (fn is flash_attention_backward)
        hold_backward(grads, want, allowed)


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("tq,t_img,n_lat", [
    (1, 1, 64), (15, 2, 64), (17, 6, 64), (64, 6, 64), (65, 2, 20), (257, 6, 64), (40, 6, 20), (33, 1, 64)])
def test_masked_xattn_backward_tensor_core_body(gen, d, tq, t_img, n_lat):
    """K5b's bf16 body (tensor cores) and its FMA yardstick against the plain
    version: query tiles whose rows see 1, 2 or up to 6 images, a row of
    text_time drawn at random (not a cumsum: the dkv kernel's query interval
    per key block comes from a scan of text_time), rows before any image,
    n_lat 64 (one key tile per image) and 20 (images across 16-key groups
    and tile edges)."""
    bh = 4
    s = t_img * n_lat
    q, k, v, do = (rn(gen, bh, n, d).to(torch.bfloat16) for n in (tq, s, s, tq))
    tt = media_text_time(gen, bh, tq, t_img)
    out, lse = reference_masked_xattn(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), n_lat, d**-0.5, with_lse=True)
    want = reference_masked_xattn_backward(q.cpu(), k.cpu(), v.cpu(), tt.cpu(), n_lat, out, lse, do.cpu(), d**-0.5)
    allowed = tt.cpu()[:, :, None] == (torch.arange(s) // n_lat + 1)[None, None, :]
    assert (~allowed.any(-1))[1].all() and (~allowed.any(1))[1].all()
    for fn in (masked_xattn_backward, masked_xattn_backward_fma):
        n = masked_xattn_backward.launches
        grads = fn(q, k, v, tt, n_lat, out.cuda(), lse.cuda(), do, d**-0.5)
        torch.cuda.synchronize()
        assert masked_xattn_backward.launches == n + (fn is masked_xattn_backward)
        hold_backward(grads, want, allowed)


@pytest.mark.parametrize("m,k,n", [(16, 64, 48), (1, 67, 7), (17, 2048, 32003), (16, 4096, 32003)])
def test_int8_matmul_takes_any_shape(gen, m, k, n):
    """The W8A8 product on the card at shapes `torch._int_mm` refuses (M <=
    16, K or N not a multiple of 8: a B 1 prompt of 16 tokens, LLaMA-7B's
    head over 32,003 rows), zero-padded: the exact product."""
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    got = w8a8.int8_matmul(a, b)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), w8a8.int8_matmul(a.cpu(), b.cpu()))

def on_cpu(kw):
    return {key: val.cpu() if torch.is_tensor(val) else val for key, val in kw.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "gelu_new", "relu", "quick_gelu", "silu"])
@pytest.mark.parametrize("k", [256, 264])      # bf16: tensor cores, and K % 32 != 0 on CUDA cores
def test_fused_dense_rms_and_acts(gen, k, act, dtype):
    """K1 with the RMSNorm prologue and each activation, bias, clip, gate and
    residual; a ragged vocabulary."""
    b, n = 5, 1003
    x, w, ln = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, n, k) * 0.05, rn(gen, k)))
    bias, res = (rn(gen, n) * 0.1).to(dtype), rn(gen, b, n).to(dtype)
    gate = torch.tensor([0.7], device="cuda", dtype=dtype)
    kw = dict(ln_scale=ln, norm="rms", eps=1e-6, bias=bias, clip=2.0, act=act, gate=gate, residual=res)
    close(fused_dense(x, w, **kw), fused_dense(x.cpu(), w.cpu(), **on_cpu(kw)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [None, 8, 4])
# bf16: both launches on the weight-streaming body at any K (264, a hidden
# size of 344, 11,000 and 16,384) and B up to 64
@pytest.mark.parametrize("b,k,k2", [(8, 128, 512), (11, 264, 344), (8, 128, 11008), (64, 128, 16384),
                                    (1, 264, 11000)])
def test_fused_mlp_swiglu(gen, b, k, k2, bits, dtype):
    """K2's gated form (llama): RMSNorm, silu(x @ w1.T) * (x @ w1_gate.T), w2,
    residual; b1, b2 and the gate with float weights."""
    n = 136
    x, ln, res = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k), rn(gen, b, n)))
    w1, wg, w2 = rn(gen, k2, k) * 0.05, rn(gen, k2, k) * 0.05, rn(gen, n, k2) * 0.05
    kw = dict(ln_scale=ln, norm="rms", eps=1e-6, act="silu", residual=res)
    if bits is None:
        w1, wg, w2 = (t.to(dtype) for t in (w1, wg, w2))
        kw.update(b1=(rn(gen, k2) * 0.1).to(dtype), b2=(rn(gen, n) * 0.1).to(dtype),
                  gate=torch.tensor([-0.3], device="cuda", dtype=dtype))
    else:
        (w1, s1), (wg, sg), (w2, s2) = quantized(w1, bits), quantized(wg, bits), quantized(w2, bits)
        kw.update(w1_scale=s1, w1_gate_scale=sg, w2_scale=s2)
    want = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), w1_gate=wg.cpu(), **on_cpu(kw))
    close(fused_mlp(x, w1, w2, w1_gate=wg, **kw), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["relu", "gelu_new", "quick_gelu"])
def test_fused_mlp_acts(gen, act, dtype):
    """K2 with LayerNorm + bias, b1/b2 and OPT's relu, and the gelu_new and
    quick_gelu epilogues."""
    b, k, k2, n = 8, 128, 512, 136
    x, w1, w2 = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k2, k) * 0.05, rn(gen, n, k2) * 0.05))
    kw = dict(ln_scale=rn(gen, k).to(dtype), ln_bias=(rn(gen, k) * 0.1).to(dtype), b1=(rn(gen, k2) * 0.1).to(dtype),
              b2=(rn(gen, n) * 0.1).to(dtype), residual=rn(gen, b, n).to(dtype), act=act)
    close(fused_mlp(x, w1, w2, **kw), fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **on_cpu(kw)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_gemv_keeps_its_shared_memory_limit(gen, dtype):
    """One row-GEMV kernel launched by K2's second launch and by K1 with an
    activation (fp32: the CUDA-core kernel, its limit following K; bf16: the
    weight-streaming kernel at its one limit, and its K2b carrier beside
    it): a smaller request from one must not lower the limit the other was
    granted (K 8192, then K 2560, then K 10240)."""
    x, n = rn(gen, 8, 256).to(dtype), 136
    for k2 in (8192, None, 10240):
        if k2 is None:
            xk, w = rn(gen, 8, 2560).to(dtype), (rn(gen, 64, 2560) * 0.02).to(dtype)
            close(fused_dense(xk, w, act="relu"), fused_dense(xk.cpu(), w.cpu(), act="relu"))
            continue
        w1, w2 = (rn(gen, k2, 256) * 0.05).to(dtype), (rn(gen, n, k2) * 0.02).to(dtype)
        close(fused_mlp(x, w1, w2), fused_mlp(x.cpu(), w1.cpu(), w2.cpu()))


@pytest.mark.parametrize("dtype", DTYPES)
# the JAX test's cases, a ragged S 17 at Dh 64, ViT-L/14 (S 257, Dh 64) at B 2
@pytest.mark.parametrize("bh,s,d", [(8, 27, 16), (16, 16, 32), (6, 17, 64), (32, 257, 64)])
def test_vit_attention(gen, bh, s, d, dtype):
    q, k, v = (rn(gen, bh, s, d).to(dtype) for _ in range(3))
    n = vit_attention.launches
    got = vit_attention(q, k, v, d**-0.5)
    assert vit_attention.launches == n + 1
    close(got, vit_attention(q.cpu(), k.cpu(), v.cpu(), d**-0.5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_attention_reads_strided_heads(gen, dtype):
    """The ViT's (B, S, H, Dh) views of (B, S, H*Dh) projections, read
    through their strides; the result is (B, S, H*Dh) as a view."""
    b, s, h, d = 2, 257, 16, 64
    q, k, v = (rn(gen, b, s, h * d).to(dtype).view(b, s, h, d) for _ in range(3))
    got = vit_attention_heads(q, k, v, d**-0.5)
    assert got.is_contiguous()
    close(got, vit_attention_heads(q.cpu(), k.cpu(), v.cpu(), d**-0.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,with_bias", [(24, 64, True), (37, 32, False), (2056, 1024, True), (5, 4096, False)])
def test_layer_norm(gen, m, d, with_bias, dtype):
    x = (rn(gen, m, d) * 2 + 1).to(dtype)
    x[0] = 1000.078125                      # fast variance below 0 before the clamp
    scale, bias = (1 + 0.1 * rn(gen, d)).to(dtype), (0.1 * rn(gen, d)).to(dtype) if with_bias else None
    n = layer_norm.launches
    got = layer_norm(x, scale, bias, 1e-5)
    assert layer_norm.launches == n + 1 and torch.isfinite(got).all()
    close(got, layer_norm(x.cpu(), scale.cpu(), None if bias is None else bias.cpu(), 1e-5))


def test_vit_kernels_backward_through_autograd(gen):
    """K9 and K10 under autograd on the card: the forward launches the
    kernel, the gradients (through the plain versions) equal the plain
    versions' autograd on the CPU."""
    bh, s, d = 4, 17, 64
    q, k, v, do = (rn(gen, bh, s, d) for _ in range(4))
    x, scale, bias, dy = rn(gen, 6, 64), 1 + 0.1 * rn(gen, 64), 0.1 * rn(gen, 64), rn(gen, 6, 64)
    for fn, args, grad_out, counter in ((lambda *a: vit_attention(*a, d**-0.5), (q, k, v), do, vit_attention),
                                        (lambda *a: layer_norm(*a, 1e-5), (x, scale, bias), dy, layer_norm)):
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_(True) for t in args]
            n = counter.launches
            (fn(*leaves) * grad_out.to(dev)).sum().backward()
            assert counter.launches == n + (dev == "cuda")
            grads.append([leaf.grad for leaf in leaves])
        for g, w in zip(*grads):
            close_grad(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
# the whole width (D 32 over 2 heads of Dh 16), paired heads (Dh 64), ViT-L/14 at B' 2
@pytest.mark.parametrize("b,s_pad,s_real,d,heads", [(3, 8, 5, 32, 2), (2, 24, 17, 256, 4), (2, 264, 257, 1024, 16)])
def test_flat_vit_attention(gen, b, s_pad, s_real, d, heads, dtype):
    """K8 on the flat workspace: keys past s_real masked, every query row
    (pad rows too) computed."""
    q, k, v = (rn(gen, b, s_pad, d).to(dtype) for _ in range(3))
    n = flat_vit_attention.launches
    got = flat_vit_attention(q, k, v, (d // heads) ** -0.5, heads=heads, s_real=s_real)
    assert flat_vit_attention.launches == n + 1 and torch.isfinite(got).all()
    close(got, flat_vit_attention(q.cpu(), k.cpu(), v.cpu(), (d // heads) ** -0.5, heads=heads, s_real=s_real))


def split_heads(x, h, d):
    """q, k, v as the ViT block passes them: (B, S, H, Dh) views of one
    (B, S, 3*H*Dh) projection (row stride 3*H*Dh)."""
    b, s = x.shape[:2]
    return [x[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3)]


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 16, 17, 64, 65, 257, 272])
def test_vit_attention_bf16_persistent_kernel(gen, s, d):
    """K9's bf16 kernel at every tile edge of S (16-key tiles, 64-row query
    tiles, one or two K/V boxes) and each Dh (its own TMA swizzle), at 1,
    131, 133 and 1,024 instances (under, around and past one block per SM)
    on strided views: against the plain version, repeat calls bit for bit,
    and instance 0 alone gives the bits it gives among the others."""
    for b, h in ((1, 1), (131, 1), (7, 19), (64, 16)):
        q, k, v = split_heads(rn(gen, b, s, 3 * h * d).to(torch.bfloat16), h, d)
        got = vit_attention_heads(q, k, v, d**-0.5)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        close(got, vit_attention_heads(q.cpu(), k.cpu(), v.cpu(), d**-0.5))
        assert torch.equal(got, vit_attention_heads(q, k, v, d**-0.5))
        alone = vit_attention_heads(q[:1, :, :1], k[:1, :, :1], v[:1, :, :1], d**-0.5)
        assert torch.equal(alone[0, :, 0], got[0, :, 0])


@pytest.mark.parametrize("b", [1, 8, 64])
def test_flat_vit_attention_bf16_persistent_kernel(gen, b):
    """K8's bf16 kernel at the absorbed ViT-L/14's shape (S_pad 264 query
    rows over s_real 257 keys, 16 heads of Dh 64) at B' 1, 8 and 64 (the
    pipe's): against the plain version, pad rows finite, repeat calls and
    image 0 alone bit for bit."""
    s_pad, s_real, heads, d = 264, 257, 16, 1024
    q, k, v = (rn(gen, b, s_pad, d).to(torch.bfloat16) for _ in range(3))
    kw = dict(heads=heads, s_real=s_real)
    got = flat_vit_attention(q, k, v, 0.125, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    close(got, flat_vit_attention(q.cpu(), k.cpu(), v.cpu(), 0.125, **kw))
    assert torch.equal(got, flat_vit_attention(q, k, v, 0.125, **kw))
    assert torch.equal(flat_vit_attention(q[:1], k[:1], v[:1], 0.125, **kw)[0], got[0])


def within_one_ulp(got, want, floor=2.0**-6):
    """Every entry within one bf16 ulp (8 significant bits) of the plain
    result, the ulp of results near 0 floored at that of `floor`."""
    mag = want.float().abs().clamp(min=floor)
    return bool(((got.float() - want.float()).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())


@pytest.mark.parametrize("seed", range(8))
def test_attend_out_decode_bf16_over_its_own_head_outputs(seed):
    """K6 in bf16 at LLaMA-7B's shape (D 4096, 32 heads of Dh 128, slot 40
    of 64, residual), held as chip_smoke.py holds it: the head outputs the
    kernel wrote (attn_out) against the plain attend within 1e-2, and y
    within one bf16 ulp of the plain tail over those head outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from open_flamingo_tpu_torch.ops.decode_layer import reference_attend, reference_out_tail

    g = torch.Generator(device="cuda").manual_seed(100 + seed)
    b, h, dh, s, dm = 8, 32, 128, 64, 4096
    bf = lambda *shape, scale=1.0: (rn(g, *shape) * scale).to(torch.bfloat16)
    q, kn, vn, res = bf(b, h, dh), bf(b, h, dh), bf(b, h, dh), bf(b, dm)
    k0, v0 = bf(b, h, s, dh), bf(b, h, s, dh)
    wout = bf(dm, h * dh, scale=(h * dh) ** -0.5)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[0, :4], mask[1, :7], mask[:, 41:] = False, False, False
    slot = torch.tensor([40], dtype=torch.int32, device="cuda")
    heads = torch.empty(b, h * dh, dtype=torch.bfloat16, device="cuda")
    kc, vc = k0.clone(), v0.clone()
    y, _, _ = attend_out_decode(q, kc, vc, mask, wout, scale=dh**-0.5, k_new=kn, v_new=vn, slot=slot, residual=res,
                                attn_out=heads)
    torch.cuda.synchronize()
    want = reference_attend(q, k0.clone(), v0.clone(), mask, wout, scale=dh**-0.5, k_new=kn, v_new=vn, slot=slot)
    torch.testing.assert_close(heads.float(), want.float(), atol=1e-2, rtol=1e-2)
    assert within_one_ulp(y, reference_out_tail(heads, wout, dtype=torch.bfloat16, residual=res))


SIDE_SLOTS = {
    "ln_bias": dict(ln=True, bias=True),                            # q/k/v, fc1
    "residual": dict(bias=True, residual=True),                     # out-projection parts
    "act_bias": dict(act="quick_gelu", bias=True, residual=True),   # fc2, slice 0
    "act": dict(act="quick_gelu", residual=True),                   # fc2, later slices
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("slot", list(SIDE_SLOTS))
# the down-projection on the weight-streaming body (bf16, K2 512 and 344) or CUDA cores (fp32)
@pytest.mark.parametrize("k2", [512, 344])
def test_fused_mlp_side_tile(gen, k2, slot, bits, dtype):
    """K2b: each slot kind in K2's launch with main weights of every type;
    side_w and side_residual column blocks of wider tensors (row strides),
    M and SN ragged against the tiles. K2's own output is bit for bit the
    launch's without a side tile."""
    b, k, n, m, sk, sn = 8, 128, 136, 130, 96, 160
    kind = SIDE_SLOTS[slot]
    x, ln, res = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k), rn(gen, b, n)))
    w1, w2 = rn(gen, k2, k) * 0.05, rn(gen, n, k2) * 0.05
    kw = dict(ln_scale=ln, residual=res)
    if bits is None:
        w1, w2 = w1.to(dtype), w2.to(dtype)
    else:
        (w1, s1), (w2, s2) = quantized(w1, bits), quantized(w2, bits)
        kw.update(w1_scale=s1, w2_scale=s2)
    side = dict(side_x=(rn(gen, m, sk) * 2).to(dtype), side_w=(rn(gen, sn, 2 * sk) * sk**-0.5).to(dtype)[:, sk:],
                side_act=kind.get("act"), side_eps=1e-5)
    if kind.get("ln"):
        side["side_ln"] = ((1 + 0.1 * rn(gen, sk)).to(dtype), (0.1 * rn(gen, sk)).to(dtype))
    if kind.get("bias"):
        side["side_b"] = (0.1 * rn(gen, sn)).to(dtype)
    if kind.get("residual"):
        side["side_residual"] = rn(gen, m, 2 * sn).to(dtype)[:, sn:]
    before = dict(fused_mlp.variants)
    y, so = fused_mlp(x, w1, w2, **kw, **side)
    grew = [key for key, c in fused_mlp.variants.items() if c != before.get(key, 0)]
    assert len(grew) == 1 and grew[0].endswith("+side")
    assert torch.equal(y, fused_mlp(x, w1, w2, **kw))
    cpu_side = {key: tuple(t.cpu() for t in val) if isinstance(val, tuple) else val
                for key, val in on_cpu(side).items()}
    want_y, want_so = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **on_cpu(kw), **cpu_side)
    close(y, want_y)
    close(so, want_so)


def w8a8_side(gen, dtype, m, sk, sn, kind):
    """A W8A8 side tile's operands: int8 side_w a column block of a wider
    int8 weight (a row stride, as an fc2 slice), its (SN,) scales whole."""
    q, s = quantize_weight(rn(gen, sn, 2 * sk) * sk**-0.5, 8)
    side = dict(side_x=(rn(gen, m, sk) * 2).to(dtype), side_w=q[:, sk:], side_w_scale=s, side_act=kind.get("act"),
                side_eps=1e-5)
    if kind.get("ln"):
        side["side_ln"] = ((1 + 0.1 * rn(gen, sk)).to(dtype), (0.1 * rn(gen, sk)).to(dtype))
    if kind.get("bias"):
        side["side_b"] = (0.1 * rn(gen, sn)).to(dtype)
    if kind.get("residual"):
        side["side_residual"] = rn(gen, m, 2 * sn).to(dtype)[:, sn:]
    return side


def w8a8_close(so, want, side_cpu):
    """The W8A8 tile against its plain version: both round the same int32
    sums at the same points, so they differ only where an activation's
    quotient sh / s_act lies near a .5 boundary (the LayerNorm and the
    activation are fp32 sums and functions taken in another order, ~1e-5 of
    a step apart). Allowance per element: the row's activations within 1e-3
    of a boundary, each at most one step of s_act * |w_q| * w_s, with |w_q|
    <= 127; plus `close`'s tolerance."""
    from open_flamingo_tpu_torch.ops.dense_stream import side_activations
    from open_flamingo_tpu_torch.ops.w8a8 import quantize_activations

    h = side_activations(side_cpu["side_x"], side_cpu.get("side_ln"), 1e-5, side_cpu.get("side_act"))
    s_act = quantize_activations(h)[1]
    frac = (h / s_act).abs() % 1
    near = ((frac - 0.5).abs() < 1e-3).sum(-1, keepdim=True).float()
    allow = near * s_act * 127 * side_cpu["side_w_scale"][None]
    tol = dict(atol=ATOL, rtol=0) if so.dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    diff = (so.cpu().float() - want.float()).abs()
    assert (diff <= allow + tol["atol"] + tol["rtol"] * want.float().abs()).all(), diff.max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("slot", list(SIDE_SLOTS))
@pytest.mark.parametrize("k2", [512, 344])
def test_fused_mlp_w8a8_side_tile(gen, k2, slot, bits, dtype):
    """K2b int8, the W8A8 side tile, on K2's launch with main weights of
    every type: M and SN ragged against its 64 x 128 tiles; K2's own output
    bit for bit the launch's without a tile."""
    b, k, n, m, sk, sn = 8, 128, 136, 130, 96, 160
    x, ln, res = (t.to(dtype) for t in (rn(gen, b, k), rn(gen, k), rn(gen, b, n)))
    w1, w2 = rn(gen, k2, k) * 0.05, rn(gen, n, k2) * 0.05
    kw = dict(ln_scale=ln, residual=res)
    if bits is None:
        w1, w2 = w1.to(dtype), w2.to(dtype)
    else:
        (w1, s1), (w2, s2) = quantized(w1, bits), quantized(w2, bits)
        kw.update(w1_scale=s1, w2_scale=s2)
    side = w8a8_side(gen, dtype, m, sk, sn, SIDE_SLOTS[slot])
    before = dict(fused_mlp.variants)
    y, so = fused_mlp(x, w1, w2, **kw, **side)
    grew = [key for key, c in fused_mlp.variants.items() if c != before.get(key, 0)]
    assert len(grew) == 1 and grew[0].endswith("+side8")
    assert torch.equal(y, fused_mlp(x, w1, w2, **kw))
    cpu_side = {key: tuple(t.cpu() for t in val) if isinstance(val, tuple) else val
                for key, val in on_cpu(side).items()}
    want_y, want_so = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **on_cpu(kw), **cpu_side)
    close(y, want_y)
    w8a8_close(so, want_so, cpu_side)


def stored_weight(gen, n, k, kind, dtype):
    """(weight as the kernels stream it, its scale) of a random (n, k)
    weight: in x's dtype, int8, or packed int4."""
    w = rn(gen, n, k) * k**-0.5
    return (w.to(dtype), None) if kind == "float" else quantized(w, 8 if kind == "int8" else 4)


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("swiglu", [False, True])
def test_row_gemv_row_alone_is_its_row_in_any_batch(gen, swiglu, kind):
    """bf16 K1 and K2 on the weight-streaming body: a row alone (B 1) gives
    the bits it gives as row 7 of 13 and row 50 of 64 (the plan, and with it
    every column's sum order, does not follow B), three calls give the same
    bits, and each batch holds to the plain version. K 2560 and 11,000
    (launch 2), N 7680 (K1, OF-4B's QKV)."""
    dt, k, k2, n = torch.bfloat16, 2560, 11000, 7680
    wd, sd = stored_weight(gen, n, k, kind, dt)
    w1, s1 = stored_weight(gen, k2, k, kind, dt)
    w2, s2 = stored_weight(gen, k, k2, kind, dt)
    wg, sg = stored_weight(gen, k2, k, kind, dt) if swiglu else (None, None)
    ln, ln_b, bias = (1 + 0.1 * rn(gen, k)).to(dt), (0.1 * rn(gen, k)).to(dt), (0.1 * rn(gen, n)).to(dt)
    mkw = dict(ln_scale=ln, w1_scale=s1, w2_scale=s2)
    mkw.update(dict(w1_gate=wg, w1_gate_scale=sg, norm="rms", act="silu") if swiglu else dict(ln_bias=ln_b))
    dkw = dict(w_scale=sd, ln_scale=ln, ln_bias=ln_b, bias=bias)
    x = rn(gen, 64, k).to(dt)
    rows = {1: (0, x[50:51]), 13: (7, x[43:56]), 64: (50, x)}
    outs = {}
    for b, (r, xb) in rows.items():
        res = xb.clone()
        calls = [(fused_mlp(xb, w1, w2, residual=res, **mkw), fused_dense(xb, wd, **dkw)) for _ in range(3)]
        for y, h in calls[1:]:
            assert torch.equal(y, calls[0][0]) and torch.equal(h, calls[0][1])
        outs[b] = (calls[0][0][r], calls[0][1][r])
        if b != 64:
            close(calls[0][0], fused_mlp(xb.cpu(), w1.cpu(), w2.cpu(), residual=res.cpu(), **on_cpu(mkw)))
            close(calls[0][1], fused_dense(xb.cpu(), wd.cpu(), **on_cpu(dkw)))
    for b in (13, 64):
        assert torch.equal(outs[b][0], outs[1][0]) and torch.equal(outs[b][1], outs[1][1]), b


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_fused_mlp_carrier_at_b64_is_bit_for_bit(gen, bits):
    """K2 at B 64 carrying the W8A8 tile at ViT-L/14's width (SK 1,024) on
    the pipe's MPT MLP shape (D 2048, hidden 8,192): y bit for bit the
    launch's without the tile, both against the plain version."""
    dt, b, k, k2 = torch.bfloat16, 64, 2048, 8192
    x, ln = rn(gen, b, k).to(dt), (1 + 0.1 * rn(gen, k)).to(dt)
    kind = {None: "float", 8: "int8", 4: "int4"}[bits]
    (w1, s1), (w2, s2) = stored_weight(gen, k2, k, kind, dt), stored_weight(gen, k, k2, kind, dt)
    kw = dict(ln_scale=ln, residual=x, w1_scale=s1, w2_scale=s2)
    side = w8a8_side(gen, dt, 2112, 1024, 1024, SIDE_SLOTS[list(SIDE_SLOTS)[0]])
    y, so = fused_mlp(x, w1, w2, **kw, **side)
    assert torch.equal(y, fused_mlp(x, w1, w2, **kw))
    cpu_side = {key: tuple(t.cpu() for t in val) if isinstance(val, tuple) else val
                for key, val in on_cpu(side).items()}
    want_y, want_so = fused_mlp(x.cpu(), w1.cpu(), w2.cpu(), **on_cpu(kw), **cpu_side)
    close(y, want_y)
    w8a8_close(so, want_so, cpu_side)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", ["float", "w8a8"])
@pytest.mark.parametrize("bits,kv8", [(None, False), (4, False), (8, True)])
@pytest.mark.parametrize("fused_qkv", [True, False])
def test_attn_block_decode_side_tile(gen, fused_qkv, bits, kv8, tile, dtype):
    """K2b-attn, K3 carrying a side tile in its out-projection launch (self
    with the slot write at 40, gated q only), weights in x's dtype, int4 and
    int8 over the int8 cache: y and the caches bit for bit those of the call
    without a tile, the tile against its plain version."""
    b, h, d, dm, s, slot = 3, 4, 64, 128, 64, 40
    m, sk, sn = 130, 96, 160
    x, ln = rn(gen, b, dm).to(dtype), rn(gen, dm).to(dtype)
    wq, wout = rn(gen, (3 if fused_qkv else 1) * h * d, dm) * 0.1, rn(gen, dm, h * d) * 0.1
    kw = dict(heads=h, head_dim=d, scale=d**-0.5)
    if bits is None:
        wq, wout = wq.to(dtype), wout.to(dtype)
    else:
        (wq, sq), (wout, so_) = quantized(wq, bits), quantized(wout, bits)
        kw.update(wq_scale=sq, wout_scale=so_)
    mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    mask[:, :slot + 1] = True
    mask[1, :3] = False
    if fused_qkv:
        kw.update(fused_qkv=True, slot=torch.tensor([slot], dtype=torch.int32, device="cuda"), slopes=rn(gen, h).abs(),
                  clip=0.6)
    else:
        kw.update(gate=torch.tensor([0.5], device="cuda", dtype=dtype))
    if kv8:
        (kc, ks), (vc, vs) = int8_cache(gen, b, h, s, d), int8_cache(gen, b, h, s, d)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kc, vc = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
    kind = SIDE_SLOTS["ln_bias"]
    if tile == "w8a8":
        side = w8a8_side(gen, dtype, m, sk, sn, kind)
    else:
        side = dict(side_x=(rn(gen, m, sk) * 2).to(dtype), side_w=(rn(gen, sn, 2 * sk) * sk**-0.5).to(dtype)[:, sk:],
                    side_ln=((1 + 0.1 * rn(gen, sk)).to(dtype), (0.1 * rn(gen, sk)).to(dtype)),
                    side_b=(0.1 * rn(gen, sn)).to(dtype), side_eps=1e-5)
    caches = [t.clone() for t in (kc, vc, kw.get("k_scale"), kw.get("v_scale")) if t is not None]
    plain_kw = dict(kw, **({"k_scale": caches[2], "v_scale": caches[3]} if kv8 else {}))
    before = dict(attn_block_decode.variants)
    got = attn_block_decode(x, ln, None, wq, wout, kc, vc, mask, **kw, **side)
    grew = [key for key, c in attn_block_decode.variants.items() if c != before.get(key, 0)]
    assert len(grew) == 1 and grew[0].endswith("+side8" if tile == "w8a8" else "+side")
    without = attn_block_decode(x, ln, None, wq, wout, caches[0], caches[1], mask, **plain_kw)
    for g, w in zip(got[:-1], without if fused_qkv else (without,)):
        assert torch.equal(g, w)
    if kv8:
        assert torch.equal(kw["k_scale"], caches[2]) and torch.equal(kw["v_scale"], caches[3])
    cpu_side = {key: tuple(t.cpu() for t in val) if isinstance(val, tuple) else val
                for key, val in on_cpu(side).items()}
    want_so = reference_side_tile(**cpu_side)
    if tile == "w8a8":
        w8a8_close(got[-1], want_so, cpu_side)
    else:
        close(got[-1], want_so)


# the absorbed ViT-L/14's slot kinds at its widths (D 1,024, I 4,096): LayerNorm and bias (q/k/v); bias and a
# residual column block (the out-projection); a row block of fc1's (4096, 1024) weight; a column block of fc2's
# (1024, 4096) weight, read with its row stride, quick_gelu, the bias and the residual chain
REAL_SLOTS = ("qkv", "out", "fc1", "fc2")


def real_width_side(gen, dtype, tile, slot, m, sn):
    """The operands of one absorbed-ViT side tile at ViT-L/14's widths, M
    rows, SN columns (SN <= 1,024 of the slot's weight)."""
    d, inter = 1024, 4096
    wide = {"qkv": (d, d), "out": (d, d), "fc1": (inter, d), "fc2": (d, inter)}[slot]
    def cut(t):   # the slot's view of the ViT weight, SN of its output rows
        return {"fc1": t[d:2 * d], "fc2": t[:, d:2 * d]}.get(slot, t)[:sn]

    w = rn(gen, *wide) * wide[1] ** -0.5
    side = dict(side_x=(rn(gen, m, d) * 2).to(dtype), side_eps=1e-5, side_b=(0.1 * rn(gen, sn)).to(dtype))
    if tile == "w8a8":
        q, scale = quantize_weight(w, 8)
        side.update(side_w=cut(q), side_w_scale=(scale[d:2 * d] if slot == "fc1" else scale)[:sn])
    else:
        side["side_w"] = cut(w.to(dtype))
    if slot in ("qkv", "fc1"):
        side["side_ln"] = ((1 + 0.1 * rn(gen, d)).to(dtype), (0.1 * rn(gen, d)).to(dtype))
    if slot in ("out", "fc2"):
        side["side_residual"] = rn(gen, m, 2 * d).to(dtype)[:, d:d + sn]
    if slot == "fc2":
        side["side_act"] = "quick_gelu"
    return side


def w8a8_allowance(so, want, side):
    """The W8A8 tile against its plain version on the card, element by
    element: each of the row's activations within 1e-3 of a rounding
    boundary may land one step away and move the output by s_act *
    |w_q[n, k]| * w_scale[n]; plus one rounding of the result (bf16 2^-7 of
    it, fp32 1e-6)."""
    from open_flamingo_tpu_torch.ops.dense_stream import side_activations
    from open_flamingo_tpu_torch.ops.w8a8 import quantize_activations

    h = side_activations(side["side_x"], side.get("side_ln"), 1e-5, side.get("side_act"))
    s_act = quantize_activations(h)[1]
    mag = (h / s_act).abs()
    near = (((mag - mag.floor()) - 0.5).abs() < 1e-3).float()
    allow = (near @ side["side_w"].float().abs().t()) * s_act * side["side_w_scale"][None]
    rel = 2.0**-7 if so.dtype == torch.bfloat16 else 1e-6
    diff = (so.float() - want.float()).abs()
    assert (diff <= allow + rel * want.float().abs() + 1e-6).all(), diff.max()


@pytest.mark.parametrize("tile,dtype", [("bf16", torch.bfloat16), ("w8a8", torch.bfloat16),
                                        ("w8a8", torch.float32)])
@pytest.mark.parametrize("carrier", ["k2", "k3"])
@pytest.mark.parametrize("slot", REAL_SLOTS)
# the pipe's next batch B 64 (one span of all SN) and B 8 (spans of 256 columns); SN 1,000 ends inside a span,
# SN 999 leaves the output rows unaligned for paired stores
@pytest.mark.parametrize("m,sn", [(16896, 1024), (2112, 1024), (2112, 1000), (16896, 1000), (2112, 999)])
def test_side_tile_real_widths(gen, m, sn, slot, carrier, tile, dtype):
    """K2b and K2b int8 at the absorbed ViT-L/14's widths (SK 1,024) on a K2
    and a K3 carrier: the carrier's outputs bit for bit those of the launch
    without the tile; the bf16 tile within `close`'s tolerance of
    reference_side_tile, the W8A8 tile within its boundary allowance. The
    plain versions run on the card (int8 products by torch._int_mm)."""
    side = real_width_side(gen, dtype, tile, slot, m, sn)
    if carrier == "k2":
        b, dm, k2 = 8, 256, 1024
        x, ln, res = rn(gen, b, dm).to(dtype), rn(gen, dm).to(dtype), rn(gen, b, dm).to(dtype)
        w1, w2 = (rn(gen, k2, dm) * dm**-0.5).to(dtype), (rn(gen, dm, k2) * k2**-0.5).to(dtype)
        run = lambda **kw: fused_mlp(x, w1, w2, ln_scale=ln, residual=res, **kw)
        without = (run(),)
    else:
        b, h, d, dm, s, slot_ = 8, 4, 64, 256, 64, 40
        x, ln = rn(gen, b, dm).to(dtype), rn(gen, dm).to(dtype)
        wq, wout = (rn(gen, 3 * h * d, dm) * 0.1).to(dtype), (rn(gen, dm, h * d) * 0.1).to(dtype)
        kc, vc = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
        mask = torch.zeros(b, s, dtype=torch.bool, device="cuda")
        mask[:, :slot_ + 1] = True
        kw3 = dict(heads=h, head_dim=d, scale=d**-0.5, fused_qkv=True,
                   slot=torch.tensor([slot_], dtype=torch.int32, device="cuda"), slopes=rn(gen, h).abs())
        caches = (kc.clone(), vc.clone())
        run = lambda **kw: attn_block_decode(x, ln, None, wq, wout, kc, vc, mask, **kw3, **kw)
        without = attn_block_decode(x, ln, None, wq, wout, *caches, mask, **kw3)
    got = run(**side)
    for g, w in zip(got[:-1], without):
        assert torch.equal(g, w)
    want = reference_side_tile(**side)
    if tile == "w8a8":
        w8a8_allowance(got[-1], want, side)
    else:
        torch.testing.assert_close(got[-1], want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_absorbed_generate(gen, dtype):
    """flamingo_generate(next_pixels=) on the card, a tiny MPT model: the
    tokens of the call without it, next_latents those of embed_vision on
    the same pixels (fp32: 1e-4 of the largest entry; bf16: the absorbed
    workspace rounds each fc2 slice's partial sum, so against the
    plain_path() absorbed call), K8 once per ViT layer and one K2b tile per
    slot."""
    from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
    from open_flamingo_tpu_torch.models.absorb_vit import make_plan
    from open_flamingo_tpu_torch.models.flamingo import init_random
    from open_flamingo_tpu_torch.ops.attention import plain_path

    cfg = FlamingoConfig(
        vision=VisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128),
        lm=DecoderConfig(family="mpt", vocab_size=128, hidden_size=64, num_layers=4, num_heads=2,
                         intermediate_size=256, alibi=True, attention_bias=False, ln_no_bias=True),
        media_token_id=3, eoc_token_id=4, num_vis_latents=4, perceiver_depth=1, perceiver_heads=2,
        perceiver_dim_head=16)
    model = init_random(cfg, 0, device="cuda", dtype=dtype)
    vision_x, next_pixels = rn(gen, 2, 1, 1, 32, 32, 3), rn(gen, 3, 1, 1, 32, 32, 3)
    ids = torch.randint(7, 128, (2, 6), generator=gen, device="cuda")
    ids[:, 0] = 3
    mask = torch.ones_like(ids)
    gcfg = GenerationConfig(max_new_tokens=4, pad_token_id=0, eos_token_id=-1)
    plan = make_plan(cfg, (3, 1, 1), 4)
    assert plan is not None
    plain = flamingo_generate(model, vision_x, ids, mask, gcfg)
    k8, side = flat_vit_attention.launches, sum(c for key, c in fused_mlp.variants.items() if key.endswith("+side"))
    tokens, latents = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_pixels)
    assert flat_vit_attention.launches - k8 == plan.n_vit_layers
    assert sum(c for key, c in fused_mlp.variants.items() if key.endswith("+side")) - side == (
        plan.slots_per_layer * plan.n_vit_layers)
    assert torch.equal(tokens, plain)
    if dtype == torch.float32:
        want = model.embed_vision(next_pixels.to(dtype))
    else:
        with plain_path():
            want = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_pixels)[1]
    err, top = (latents.float() - want.float()).abs().max().item(), want.float().abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2) * top, (err, top)


def layer_operands(gen, b, dm, h, d, k2, s, fused_qkv, dtype, bits=None, slot=40, swiglu=False, act="gelu"):
    """One decode layer's operands for K11 on the card, K11's positional
    arguments and keywords: the MPT form (fused QKV, ALiBi, clip, row 1
    left-padded) or the gated cross-attention form (tanh gates, LN biases,
    b1/b2, row 1 before any image); weights in `dtype`, or int8 / packed
    int4 with their scales."""
    inner = h * d
    x = rn(gen, b, dm).to(dtype)
    ln1, ln2 = (1 + 0.1 * rn(gen, dm)).to(dtype), (1 + 0.1 * rn(gen, dm)).to(dtype)
    ln1_b, ln2_b = (None, None) if fused_qkv else ((0.1 * rn(gen, dm)).to(dtype), (0.1 * rn(gen, dm)).to(dtype))
    shapes = dict(wq=((3 if fused_qkv else 1) * inner, dm), wout=(dm, inner), w1=(k2, dm), w2=(dm, k2))
    if swiglu:
        shapes["w1_gate"] = (k2, dm)
    ws, kw = {}, dict(heads=h, head_dim=d, scale=d**-0.5, act=act, fused_qkv=fused_qkv)
    for name, (n, kk) in shapes.items():
        w = rn(gen, n, kk) * kk**-0.5
        if bits is None:
            ws[name] = w.to(dtype)
        else:
            ws[name], kw[f"{name}_scale"] = quantized(w, bits)
    kc, vc = rn(gen, b, h, s, d).to(dtype), rn(gen, b, h, s, d).to(dtype)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    if fused_qkv:
        mask[:, slot + 1:] = False
        if b > 1:
            mask[1, :3] = False
        kw.update(slot=torch.tensor([slot], dtype=torch.int32, device="cuda"), slopes=rn(gen, h).abs(), clip=2.0)
    else:
        if b > 1:
            mask[1] = False
        kw.update(gate=torch.tensor([0.6], device="cuda", dtype=dtype),
                  gate2=torch.tensor([-0.4], device="cuda", dtype=dtype),
                  b1=(0.1 * rn(gen, k2)).to(dtype), b2=(0.1 * rn(gen, dm)).to(dtype))
    if swiglu:
        kw["w1_gate"] = ws["w1_gate"]
    args = [x, ln1, ln1_b, ws["wq"], ws["wout"], kc, vc, mask, ws["w1"], ws["w2"], ln2, ln2_b]
    return args, kw


def run_layer(args, kw, device=None):
    """K11 on fresh copies of the caches (on `device`: the CPU runs the plain
    version); returns (y, k cache, v cache) for either form."""
    args = [None if t is None else (t.to(device) if device else t).clone() for t in args]
    kw = on_cpu(kw) if device == "cpu" else kw
    out = fused_layer_decode(*args, **kw)
    return out if kw["fused_qkv"] else (out, args[5], args[6])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("fused_qkv", [True, False])
# 13 rows: two passes of 8 in fp32, the any-B instance in bf16; 65: two passes of 64 in bf16
@pytest.mark.parametrize("b", [1, 8, 13, 64, 65])
def test_fused_layer_decode(gen, b, fused_qkv, bits, dtype):
    """K11 against its plain version, both forms, every weight type; three
    calls give the same bits (a stale read of what an earlier phase wrote
    would show as a call that differs)."""
    args, kw = layer_operands(gen, b, 256, 4, 64, 1024, 64, fused_qkv, dtype, bits)
    want = run_layer(args, kw, "cpu")
    got = run_layer(args, kw)
    for g, w in zip(got, want):
        close(g, w)
    for _ in range(2):
        assert all(torch.equal(g, a) for g, a in zip(got, run_layer(args, kw)))


@pytest.mark.parametrize("fused_qkv", [True, False])
@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("b", [1, 8, 13, 64, 65])
def test_fused_layer_fp32_is_k3_then_k2_bit_for_bit(gen, b, bits, fused_qkv):
    """In fp32 K11 keeps x2 as K3 + K2 do: y and both caches bit for bit."""
    args, kw = layer_operands(gen, b, 256, 4, 64, 1024, 64, fused_qkv, torch.float32, bits)
    y, kc, vc = run_layer(args, kw)
    x, ln1, ln1_b, wq, wout, kc2, vc2, mask, w1, w2, ln2, ln2_b = [None if t is None else t.clone() for t in args]
    attn = {k: v for k, v in kw.items() if k not in ("act", "gate2", "b1", "b2", "w1_scale", "w2_scale")}
    x2 = attn_block_decode(x, ln1, ln1_b, wq, wout, kc2, vc2, mask, **attn)
    x2 = x2[0] if fused_qkv else x2
    y2 = fused_mlp(x2, w1, w2, ln_scale=ln2, ln_bias=ln2_b, residual=x2, gate=kw.get("gate2"), b1=kw.get("b1"),
                   b2=kw.get("b2"), w1_scale=kw.get("w1_scale"), w2_scale=kw.get("w2_scale"))
    assert torch.equal(y, y2) and torch.equal(kc, kc2) and torch.equal(vc, vc2)


@pytest.mark.parametrize("fused_qkv", [True, False])
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("b", [1, 8, 13, 65])
def test_fused_layer_bf16_caches_and_x2_are_k3s(gen, b, bits, fused_qkv):
    """In bf16 every row-GEMV phase of K11 runs on the plan of the separate
    launch that computes it: the written caches are K3's bits, and K11's fp32
    x2 rounded to bf16 is K3's output bit for bit (B 1 and 8 on the one-n-tile
    instance, 13 and 65 on the any-B one, 65 in two passes of rows)."""
    args, kw = layer_operands(gen, b, 256, 4, 64, 1024, 64, fused_qkv, torch.bfloat16, bits)
    x2 = torch.empty(b, 256, dtype=torch.float32, device="cuda")
    args11 = [None if t is None else t.clone() for t in args]
    fused_layer_decode(*args11, x2_out=x2, **kw)
    x, ln1, ln1_b, wq, wout, kc, vc, mask = [None if t is None else t.clone() for t in args[:8]]
    attn = {k: v for k, v in kw.items() if k not in ("act", "gate2", "b1", "b2", "w1_scale", "w2_scale")}
    out = attn_block_decode(x, ln1, ln1_b, wq, wout, kc, vc, mask, **attn)
    out = out[0] if fused_qkv else out
    assert torch.equal(args11[5], kc) and torch.equal(args11[6], vc)
    assert torch.equal(x2.to(torch.bfloat16), out)


@pytest.mark.parametrize("dtype", DTYPES)
# SwiGLU (the gated instance) with silu; relu alone (the runtime-activation
# instance); a hidden size of 16,384 (the down-projection on the
# weight-streaming body with its K split across blocks in bf16)
@pytest.mark.parametrize("swiglu,act,k2", [(True, "silu", 1024), (False, "relu", 1024), (False, "gelu", 16384)])
def test_fused_layer_decode_forms(gen, swiglu, act, k2, dtype):
    args, kw = layer_operands(gen, 8, 256, 4, 64, k2, 64, False, dtype, swiglu=swiglu, act=act)
    for g, w in zip(run_layer(args, kw), run_layer(args, kw, "cpu")):
        close(g, w)


@pytest.mark.parametrize("b", [8, 65])
def test_fused_layer_decode_in_a_cuda_graph(gen, b):
    """The cooperative launch captures into a CUDA graph, and a replay reads
    the slot from the device (B 65: two passes of rows, the split's partials
    added by the grid)."""
    args, kw = layer_operands(gen, b, 256, 4, 64, 1024, 64, True, torch.bfloat16)
    want = run_layer(args, kw)
    kc, vc = args[5].clone(), args[6].clone()
    live = args[:5] + [kc, vc] + args[7:]
    fused_layer_decode(*live, **kw)
    torch.cuda.synchronize()
    kc.copy_(args[5])
    vc.copy_(args[6])
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fused_layer_decode(*live, **kw)
    kc.copy_(args[5])
    vc.copy_(args[6])
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def tiny_search_model():
    """A tiny MPT Flamingo on the card (fp32), for beam search and sampling."""
    from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
    from open_flamingo_tpu_torch.models.flamingo import init_random

    cfg = FlamingoConfig(
        vision=VisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                            intermediate_size=128),
        lm=DecoderConfig(family="mpt", vocab_size=128, hidden_size=64, num_layers=4, num_heads=2,
                         intermediate_size=256, alibi=True, attention_bias=False, ln_no_bias=True),
        media_token_id=3, eoc_token_id=4, num_vis_latents=4, perceiver_depth=1, perceiver_heads=2,
        perceiver_dim_head=16)
    return init_random(cfg, 0, device="cuda")


@pytest.mark.parametrize("mode", ["beams", "sample"])
def test_beam_and_sample_kernel_route_vs_plain(gen, mode):
    """fp32 beam search (3 beams, eos, a left-padded row) and sampling (every
    filter, one generator seed) on the fused route's kernels: the tokens of
    the same call under plain_path(), K3 and K2 launched at B x beams rows."""
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
    from open_flamingo_tpu_torch.ops.attention import plain_path

    model = tiny_search_model()
    vision_x = rn(gen, 2, 1, 1, 32, 32, 3)
    ids = torch.randint(7, 128, (2, 8), generator=gen, device="cuda")
    ids[:, 0] = 3
    mask = torch.ones_like(ids)
    mask[1, :2] = 0
    kw = dict(num_beams=3, length_penalty=1.0, eos_token_id=9) if mode == "beams" else dict(
        do_sample=True, temperature=0.7, top_k=20, top_p=0.9)
    gcfg = GenerationConfig(max_new_tokens=6, pad_token_id=0, **kw)

    def call():
        return flamingo_generate(model, vision_x, ids, mask, gcfg, generator=torch.Generator("cuda").manual_seed(1))

    before = attn_block_decode.launches, fused_mlp.launches
    got = call()
    assert attn_block_decode.launches - before[0] == 5 * 8 and fused_mlp.launches - before[1] == 5 * 8
    with plain_path():
        want = call()
    assert got.shape == (2, 6)
    assert torch.equal(got, want)


def test_gather_beams_cuda_int8_cache(gen):
    """`_gather_beams` on CUDA int8 caches: the rows (values and scales) of
    the CPU gather on a copy, the tensors at their addresses."""
    import dataclasses

    from open_flamingo_tpu_torch.configs import DecoderConfig
    from open_flamingo_tpu_torch.generation import _gather_beams
    from open_flamingo_tpu_torch.models.decoders.common import KVCache

    lm = DecoderConfig(family="mpt", vocab_size=64, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
    cache = KVCache.create(lm, 24, 64, torch.bfloat16, "cuda", int8=True)
    for kv in cache.layers:
        for x in (kv.k, kv.v):
            x.copy_(torch.randint(-127, 128, x.shape, generator=gen, device="cuda", dtype=torch.int8))
        for x in (kv.k_s, kv.v_s):
            x.copy_(rn(gen, *x.shape).abs())
    cache.pad_mask.copy_(rn(gen, 24, 64) > -1)
    cache = dataclasses.replace(cache, index=40)
    cpu = dataclasses.replace(cache, layers=tuple(dataclasses.replace(kv, **{f: getattr(kv, f).cpu() for f in
                                                                          ("k", "v", "k_s", "v_s")})
                                                  for kv in cache.layers), pad_mask=cache.pad_mask.cpu())
    ptrs = [x.data_ptr() for kv in cache.layers for x in (kv.k, kv.v, kv.k_s, kv.v_s)]
    idx = torch.randint(0, 3, (8, 3), generator=gen, device="cuda")
    got, want = _gather_beams(cache, idx, 8, 3), _gather_beams(cpu, idx.cpu(), 8, 3)
    assert [x.data_ptr() for kv in got.layers for x in (kv.k, kv.v, kv.k_s, kv.v_s)] == ptrs
    for a, b in zip(got.layers, want.layers):
        for f in ("k", "v", "k_s", "v_s"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f))
    assert torch.equal(got.pad_mask.cpu(), want.pad_mask)
