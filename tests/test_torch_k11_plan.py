"""K11's plans, its shared-memory layout, and any B, on the CPU.

In bf16 every row-GEMV phase of `csrc/fused_layer.cu` runs the
weight-streaming body on the plan of the separate launch that computes it,
so that its written caches and its x2 (rounded) are K3's bits and its phases
4 and 5 add in K2's order. The kernel itself needs the card
(tests/test_torch_cuda.py, `chip_smoke.py`); here:

  * the four plans the wrapper passes (`layer_launches` through one
    `stream_args` call) equal those K3's and K2's own wrappers pass, at every
    decode layer shape on a path (OF-3B's MPT-1B layer and gated block,
    MPT-7B's layer, a SwiGLU layer of LLaMA-7B's widths), every weight kind,
    B 1 to 130 and several SM counts; the scratch holds each pass of 64 rows;
  * the phases' shared-memory regions (`layer_smem`, the mirror of the
    source's layout) fit sm_90's 232,448 bytes a block for either instance
    and any cache length up to 8,192, the attend's scores and partials inside
    the h slice, no region over another;
  * the wrapper takes any B in bf16: at B 65 (two passes of rows) its plain
    version, which the wrapper runs on CPU tensors, against JAX
    `fused_layer_decode` in interpret mode, both forms, within
    tests/test_torch_fused_layer.py's bf16 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_fused_layer as tfl
import torch

from open_flamingo_tpu.ops.fused_layer import fused_layer_decode as jax_fused_layer
from open_flamingo_tpu_torch.ops import dense_stream
from open_flamingo_tpu_torch.ops.decode_layer import attn_block_launches
from open_flamingo_tpu_torch.ops.dense_stream import (SMEM_OPTIN, STREAM_COUNTERS, STREAM_SMEM, STREAM_SMEM_SMALL,
                                                      stream_args, stream_plan, stream_scratch_floats, weight_kind)
from open_flamingo_tpu_torch.ops.fused_layer import fused_layer_decode, layer_launches, layer_smem

# (D, heads, Dh, K2, fused QKV, SwiGLU): OF-3B's MPT-1B layer and gated xattn
# block, MPT-7B's layer (OF-9B's LM), a SwiGLU layer at LLaMA-7B's widths
LAYERS = {"mpt1b": (2048, 16, 128, 8192, True, False), "xattn": (2048, 8, 64, 8192, False, False),
          "mpt7b": (4096, 32, 128, 16384, True, False), "swiglu": (4096, 32, 128, 11008, True, True)}
BATCHES = (1, 8, 9, 64, 65, 130)
BF16_TOL = dict(atol=5e-2, rtol=2e-2)    # test_torch_fused_layer.py's bf16 bound


def stored(n, k, kind):
    """An (N, K) weight of `kind` as the wrappers see it (contents unused)."""
    if kind == "int4":
        return torch.zeros(n, k // 2, dtype=torch.uint8)
    return torch.zeros(n, k, dtype=torch.int8 if kind == "int8" else torch.bfloat16)


@pytest.fixture
def card(monkeypatch):
    """stream_args on CPU tensors: an SM count set per test, fresh caches."""
    monkeypatch.setattr(dense_stream, "_ARGS", {})
    monkeypatch.setattr(dense_stream, "_SCRATCH", {})
    monkeypatch.setattr(dense_stream, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)   # a CPU build has no CUDA

    def sms(n):
        monkeypatch.setattr(dense_stream, "_sm_count", lambda device: n)
        monkeypatch.setattr(dense_stream, "_ARGS", {})
    return sms


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_plans_are_the_separate_launches(card, layer, kind, sms):
    """Phases 1 and 3 on K3's plans (`attn_block_launches`), 4 and 5 on K2's
    (fused_mlp's two launches), at every B; the scratch holds the largest
    split's partials for each pass of 64 rows, and a split comes with the
    counters."""
    card(sms)
    dm, h, dh, k2, fused, swiglu = LAYERS[layer]
    inner = h * dh
    wq, wout = stored((3 if fused else 1) * inner, dm, kind), stored(dm, inner, kind)
    w1, w2 = stored(k2, dm, kind), stored(dm, k2, kind)
    w1_gate = stored(k2, dm, kind) if swiglu else None
    launches = layer_launches(wq, wout, w1, w1_gate, w2, dm, inner)
    assert launches[:2] == attn_block_launches(wq, wout, dm, inner)
    assert launches[2:] == [(k2, dm, w1, swiglu), (dm, k2, w2, False)]
    for b in BATCHES:
        x = torch.zeros(b, dm, dtype=torch.bfloat16)
        args, scratch = stream_args(x, launches, passes=True)
        k3, _ = stream_args(x, attn_block_launches(wq, wout, dm, inner))
        k2_args, _ = stream_args(x, [(k2, dm, w1, w1_gate is not None), (dm, k2, w2, False)])
        assert args[:8] == k3[:4] + k2_args[:4]
        plans = [stream_plan(n, k, weight_kind(w), sms) for n, k, w, _ in launches]
        assert args[:8] == tuple(v for p in plans for v in (p.slice, p.blocks))
        floats = max(stream_scratch_floats(p, b, g) for p, (_, _, _, g) in zip(plans, launches))
        if floats:
            assert scratch.numel() >= -(-b // 64) * floats
            assert args[8] == scratch.data_ptr() and args[10] == STREAM_COUNTERS and args[9] is not None
            assert all(p.tiles <= STREAM_COUNTERS for p in plans)
        else:
            assert args[8:] == (None, None, 0)
        assert stream_args(x.float(), launches, passes=True) == ((0, 0) * 4 + (None, None, 0), None)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b", [1, 8, 9, 64, 65])
def test_shared_memory_layout_fits(b, gated):
    """Each instance's regions within sm_90's opt-in shared memory at any S:
    the ring and the h slice of the separate launches' geometry, then the
    statistics, then the attend's statics; the scores (up to 8,192 floats)
    and the attend's output partials inside the h slice."""
    for s in (1, 64, 1024, 4097, 8192):
        m = layer_smem(b, gated, s)
        assert m["total"] <= SMEM_OPTIN
        assert m["stats"][1] == (STREAM_SMEM_SMALL if b <= 8 else STREAM_SMEM) == m["attend_statics"][0]
        order = [m[name] for name in ("ring", "h", "stats", "attend_statics")]
        assert order[0][0] == 0 and all(a[1] == c[0] for a, c in zip(order, order[1:]))
        for name in ("scores", "attend_parts"):
            assert m["h"][0] == m[name][0] and m[name][1] <= m["h"][1], (name, s)
    assert layer_smem(8, gated, 8192)["total"] == STREAM_SMEM_SMALL + (3 * 128 + 4) * 4 <= SMEM_OPTIN


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_bf16_at_b65_matches_jax(rng, monkeypatch, fused_qkv):
    """Any B in bf16: B 65, two passes of 64 rows on the card, through the
    wrapper (its plain version on CPU tensors) against JAX's kernel in
    interpret mode; y and the written caches."""
    monkeypatch.setattr(tfl, "B", 65)
    port, kw, jax_args, jax_kw = tfl.layer_case(rng, fused_qkv=fused_qkv, alibi=fused_qkv, clip=6.0 if fused_qkv
                                                else None, biases=not fused_qkv)

    def bf16(t):
        return t if t.dtype in (torch.bool, torch.int32) else t.to(torch.bfloat16)

    port = [bf16(t) for t in port]
    kw = {k: bf16(v) if isinstance(v, torch.Tensor) and k not in ("slot", "slopes") else v for k, v in kw.items()}
    jax_args = [a if a.dtype == jnp.int32 else a.astype(jnp.bfloat16) for a in jax_args]
    jax_kw = {k: v.astype(jnp.bfloat16) if k in ("gate", "gate2", "b1", "b2") else v for k, v in jax_kw.items()}
    got = fused_layer_decode(*port, **kw)
    want = jax_fused_layer(*jax_args, **jax_kw)
    if fused_qkv:
        (got, got_k, got_v), (want, want_k, want_v) = got, want
        for g, w in ((got_k, want_k), (got_v, want_v)):
            torch.testing.assert_close(g.float(), torch.from_numpy(np.asarray(w, np.float32)), **BF16_TOL)
    assert got.shape == (65, tfl.D) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), torch.from_numpy(np.asarray(want, np.float32)), **BF16_TOL)
