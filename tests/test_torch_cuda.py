"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`; they skip without a CUDA card. This file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

fp32 inputs: the kernels and the plain versions sum in different orders,
~1e-6 apart at these sizes; atol 5e-5 as in chip_smoke.py.
"""

import pytest
import torch

from open_flamingo_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update
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
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)


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
