"""The port's CUDA kernels against their plain versions on the card (the
wrappers on CPU copies of the same tensors).

Marked `gpu`; they skip without a CUDA card. This file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

fp32 inputs: the kernels and the plain versions sum in different orders,
~1e-6 apart at these sizes; atol 5e-5 as in chip_smoke.py. bf16 inputs (K1-K3,
whose bf16 products run on tensor cores when K is a multiple of 32): both
round an fp32 result to bf16, one ulp apart at most, plus the summation
order; atol = rtol = 1e-2 as in chip_smoke.py.
"""

import pytest
import torch

from open_flamingo_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update
from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp
from open_flamingo_tpu_torch.ops.flash_attention import flash_attention
from open_flamingo_tpu_torch.ops.masked_xattn import masked_xattn

pytestmark = pytest.mark.gpu
ATOL = 5e-5


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [256, 264])      # bf16: tensor cores, and K % 32 != 0 on CUDA cores
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
# 11 rows: two passes of 8; K2 = 16384 (OF-9B's MLP): too long for the tensor-core staging
@pytest.mark.parametrize("b,k2", [(8, 512), (11, 352), (3, 8192), (8, 16384)])
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
