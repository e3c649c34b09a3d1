"""K6 `attend_out_decode` with its head outputs exposed (`attn_out`), on the
CPU: the plain path writes the plain attend's head outputs there, and the
plain tail over them gives the call's y bit for bit, which stays within
the K6 parity bound of JAX `attend_out_decode` (Pallas interpret mode).
This is the split that chip_smoke.py's bf16 K6 check holds on the card:
the head outputs against the plain attend, y against the plain tail over
the kernel's own head outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_flamingo_tpu.ops.decode_layer import attend_out_decode as jax_attend_out
from open_flamingo_tpu_torch.ops.decode_layer import (
    attend_out_decode, reference_attend, reference_attend_out, reference_out_tail)
from open_flamingo_tpu_torch.quantize import quantize_weight

ATOL = 2e-5   # fp32 y against JAX: one sum over H*Dh products in another order

CASES = {
    "update_slot5_bias_residual": dict(slot=5, bias=True, residual=True),
    "update_gqa2_gate_alibi": dict(slot=0, gate=True, alibi=True, n_rep=2),
    "media_masked_row_residual": dict(residual=True, masked_row=True),
    "update_slot15_int8_wout": dict(slot=15, bias=True, int8=True),
}


def t(a):
    return torch.from_numpy(np.array(a))


def k6_inputs(rng, opt, b=3, h=4, dh=32, s=16, d=48):
    h_kv = h // opt.get("n_rep", 1)

    def rn(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    q, kc, vc = rn(b, h, dh), rn(b, h_kv, s, dh), rn(b, h_kv, s, dh)
    wout = rn(h, dh, d, scale=0.1)                      # JAX's head-sliced (H, Dh, D)
    mask = rng.integers(0, 2, size=(b, s)).astype(np.int32)
    kw = {}
    if "slot" in opt:
        mask[:, opt["slot"]] = 1
        kw.update(k_new=rn(b, h_kv, dh), v_new=rn(b, h_kv, dh), slot=np.int32(opt["slot"]))
    if opt.get("masked_row"):
        mask[1] = 0
    if opt.get("alibi"):
        kw["slopes"] = np.asarray([0.5 ** (i + 1) for i in range(h)], np.float32)
    for name, shape in (("bias", (d,)), ("gate", (1,)), ("residual", (b, d))):
        if opt.get(name):
            kw[name] = rn(*shape)
    return q, kc, vc, mask, wout, kw


def port_kwargs(kw):
    out = {key: t(val) for key, val in kw.items() if key != "slot"}
    if "slot" in kw:
        out["slot"] = torch.tensor([int(kw["slot"])], dtype=torch.int32)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_attn_out_is_the_plain_attend_and_the_tail_gives_y(rng, case):
    opt = CASES[case]
    q, kc, vc, mask, wout, kw = k6_inputs(rng, opt)
    b, h, dh = q.shape
    w_t = t(wout.reshape(h * dh, -1).T)                 # the port's (D, H*Dh) nn.Linear weight
    ekw = {}
    if opt.get("int8"):
        w_t, ekw["wout_scale"] = quantize_weight(w_t, 8)
    pkw = port_kwargs(kw)
    update = "slot" in kw
    attend_keys = ("k_new", "v_new", "slot", "slopes")
    heads = torch.empty(b, h * dh)
    kc_t, vc_t = t(kc), t(vc)
    got = attend_out_decode(t(q), kc_t, vc_t, t(mask), w_t, scale=dh**-0.5, attn_out=heads, **pkw, **ekw)
    y = got[0] if update else got
    want_heads = reference_attend(t(q), t(kc), t(vc), t(mask), w_t, scale=dh**-0.5,
                                  **{key: val for key, val in pkw.items() if key in attend_keys})
    assert torch.equal(heads, want_heads)
    tail = reference_out_tail(heads, w_t, dtype=torch.float32, **ekw,
                              **{key: val for key, val in pkw.items() if key not in attend_keys})
    assert torch.equal(tail, y)
    plain = reference_attend_out(t(q), t(kc), t(vc), t(mask), w_t, scale=dh**-0.5, **pkw, **ekw)
    assert torch.equal(plain[0] if update else plain, y)
    if update:
        assert got[1] is kc_t and got[2] is vc_t
    if opt.get("masked_row"):
        assert (heads[1] == 0).all()                  # no valid key: the attend is exact zeros
    if opt.get("int8"):
        return                                        # JAX's int8 K6 is held in tests/test_torch_quantize.py
    jkw = {key: jnp.asarray(val) for key, val in kw.items()}
    want = jax_attend_out(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mask), jnp.asarray(wout),
                          scale=dh**-0.5, interpret=True, **jkw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0] if update else want), atol=ATOL, rtol=0)


def test_attn_out_in_bf16_rounds_where_the_tail_reads(rng):
    """bf16: the head outputs are q's dtype, the values the out-projection
    reads; the tail over them is the call's y bit for bit."""
    q, kc, vc, mask, wout, kw = k6_inputs(rng, dict(slot=3, bias=True, residual=True))
    b, h, dh = q.shape
    bf = {key: val.to(torch.bfloat16) if val.is_floating_point() else val for key, val in port_kwargs(kw).items()}
    w_t = t(wout.reshape(h * dh, -1).T).to(torch.bfloat16)
    q_t = t(q).to(torch.bfloat16)
    heads = torch.empty(b, h * dh, dtype=torch.bfloat16)
    y, _, _ = attend_out_decode(q_t, t(kc).to(torch.bfloat16), t(vc).to(torch.bfloat16), t(mask), w_t,
                                scale=dh**-0.5, attn_out=heads, **bf)
    tail = reference_out_tail(heads, w_t, dtype=torch.bfloat16, bias=bf["bias"], residual=bf["residual"])
    assert y.dtype == torch.bfloat16 and torch.equal(tail, y)
    want = reference_attend(q_t, t(kc).to(torch.bfloat16), t(vc).to(torch.bfloat16), t(mask), w_t, scale=dh**-0.5,
                            k_new=bf["k_new"], v_new=bf["v_new"], slot=bf["slot"])
    assert torch.equal(heads, want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_attn_out_refuses_what_the_kernel_cannot_write(rng, bad):
    q, kc, vc, mask, wout, _ = k6_inputs(rng, {})
    b, h, dh = q.shape
    heads = {"shape": torch.empty(b, h * dh + 1), "dtype": torch.empty(b, h * dh, dtype=torch.bfloat16),
             "strided": torch.empty(h * dh, b).t()}[bad]
    with pytest.raises(ValueError, match="attn_out"):
        attend_out_decode(t(q), t(kc), t(vc), t(mask), t(wout.reshape(h * dh, -1).T), scale=dh**-0.5,
                          attn_out=heads)
