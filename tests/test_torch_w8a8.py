"""W8A8 prefill and the W8A8 side tiles of the port against the JAX package
on the CPU.

  * `ops.w8a8`: `quantize_activations` and `w8a8_dot` bit for bit against
    JAX `ops/w8a8.py` (zero rows, a bias, values on .5 after the division);
    `models.layers.Dense` bit for bit nn.Linear below the row gate, with
    `ENABLED` off and without int8 weights;
  * `quantize.quantize_prefill_weights` against JAX `quantize_prefill_params`
    (bits 8 and 4, unrolled and scanned), through
    `convert.from_jax.decode_weights_from_jax`: the same modules and tensors,
    the ViT's six linears of every block int8 in both modes, the int8 copy
    of each int4 stream equal to JAX's `kernel_q4`;
  * the tiny ViT with the int8 side-car bound, against JAX's;
  * the W8A8 side tile (K2b int8): `fused_mlp`'s plain version for each slot
    kind with main weights fp32, int8 and int4, and `attn_block_decode`'s
    (K3 as a carrier, self and gated) against the JAX kernels with
    side_w_scale in Pallas interpret mode; the carrier's outputs equal to
    the call without a tile;
  * the slice: tiny OF-3B (MPT) with int4 decode and W8A8 prefill against
    the scanned JAX model: greedy tokens exactly equal and the logits of
    prefill and every decode step;
  * the untied head: tiny GPT-NeoX and tiny llama (untied heads) with
    int4 / int8 weights and W8A8 prefill, the prefill logits against JAX's and every
    W8A8 product of both packages, the head's among them;
  * `w8a8.pad_for_int_mm`, the zero padding that brings an int8 product to
    the shapes `torch._int_mm` takes on the card: the padded product's
    first M x N entries equal the unpadded one bit for bit (float64).

fp32 on both sides. The int32 sums are exact in both packages; the
activations' scales and int8 values agree bit for bit where both packages
compute the same fp32 input (the quantizers, the side tile's rows without a
LayerNorm); after a LayerNorm, an attention or a GELU computed in another
order an activation may land on the other side of a rounding boundary, one
step apart, which these sizes never showed. Tolerances: 2e-5 for kernel
outputs (the JAX package's bound for these kernels), 1e-4 for the ViT's
tokens and the logits through the tiny models (the repo's logits bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_scan_layers import _scan_variables
from test_torch_llama_opt import SPECS as LLAMA_OPT_SPECS
from test_torch_quantize import (LOGITS_ATOL, MPT, NEOX, close, gen_cfgs, jax_step_logits, make_family, normal,
                                 port_model, port_step_logits, random_biases, t)

from open_flamingo_tpu import quantize as jq
from open_flamingo_tpu.generation import flamingo_generate as jax_generate
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.layers import PDense
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from open_flamingo_tpu.ops import dense_stream as jax_ds
from open_flamingo_tpu.ops import w8a8 as jax_w8a8
from open_flamingo_tpu.ops.decode_layer import attn_block_decode as jax_attn_block
from open_flamingo_tpu_torch import quantize as tq
from open_flamingo_tpu_torch.configs import VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import decode_weights_from_jax, state_dict_from_jax
from open_flamingo_tpu_torch.generation import flamingo_generate
from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
from open_flamingo_tpu_torch.models.layers import Dense
from open_flamingo_tpu_torch.models.vit import VisionTransformer
from open_flamingo_tpu_torch.ops import dense_stream as port_ds
from open_flamingo_tpu_torch.ops import w8a8
from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
from open_flamingo_tpu_torch.ops.dense_stream import fused_mlp


@pytest.fixture
def enabled(monkeypatch):
    """W8A8 on in both packages, from 4 rows (the tiny models' prompts)."""
    for module in (jax_w8a8, w8a8):
        monkeypatch.setattr(module, "ENABLED", True)
        monkeypatch.setattr(module, "MIN_TOKENS", 4)


def activations(rng, *shape):
    """Normal rows with a zero row, a row of one value and entries that fall
    on .5 after the division by their row's scale (127 * k / 2 of a row whose
    amax is 127)."""
    x = normal(rng, *shape, scale=2.0)
    x[..., 0, :] = 0.0
    x[..., 1, :] = -3.0
    x[..., 2, 0] = 127.0
    x[..., 2, 1:9] = np.arange(1, 9) + 0.5
    return x


# ---------------------------------------------------------------- ops.w8a8


def test_quantize_activations_bit_exact(rng):
    x = activations(rng, 2, 20, 64)
    jq_, js = jax_w8a8.quantize_activations(jnp.asarray(x))
    pq, ps = w8a8.quantize_activations(t(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert (pq[:, 0] == 0).all() and (ps[:, 0] == 1).all()          # a zero row: zeros, scale 1
    assert pq[0, 2, 1:9].tolist() == [2, 2, 4, 4, 6, 6, 8, 8]      # half to even


@pytest.mark.parametrize("bias", [False, True])
def test_w8a8_dot_bit_exact(rng, bias):
    x = activations(rng, 2, 20, 64)
    w = normal(rng, 48, 64, scale=0.2)
    w_q, w_s = tq.quantize_weight(t(w))
    b = normal(rng, 48, scale=0.1) if bias else None
    want = jax_w8a8.w8a8_dot(jnp.asarray(x), jnp.asarray(w_q.numpy().T), jnp.asarray(w_s.numpy()),
                             bias=None if b is None else jnp.asarray(b))
    got = w8a8.w8a8_dot(t(x), w_q, w_s, None if b is None else t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == (0 if b is None else t(b))).all()


def test_w8a8_checks_operands():
    x = torch.zeros(2, 20, 16)
    with pytest.raises(ValueError, match="int8"):
        w8a8.w8a8_dot(x, torch.zeros(8, 16), torch.ones(8))
    with pytest.raises(ValueError, match="w_s"):
        w8a8.w8a8_dot(x, torch.zeros(8, 16, dtype=torch.int8), torch.ones(7))
    with pytest.raises(RuntimeError, match="no backward"):
        w8a8.w8a8_dot(x.requires_grad_(), torch.zeros(8, 16, dtype=torch.int8), torch.ones(8))


@pytest.mark.parametrize("case", ["decode_T1", "below_gate", "disabled", "no_side_car"])
def test_dense_keeps_linear_bitwise(rng, case, enabled, monkeypatch):
    """Where the gate says no, Dense is nn.Linear bit for bit; where it says
    yes, it is JAX PDense's W8A8 product bit for bit."""
    dense = Dense(64, 32)
    with torch.no_grad():
        dense.weight.copy_(t(normal(rng, 32, 64, scale=0.2)))
        dense.bias.copy_(t(normal(rng, 32, scale=0.1)))
    if case != "no_side_car":
        tq.attach(dense, *tq.quantize_weight(dense.weight))
    if case == "disabled":
        monkeypatch.setattr(w8a8, "ENABLED", False)
    x = t(normal(rng, 2, {"decode_T1": 1, "below_gate": 3}.get(case, 16), 64))
    with torch.no_grad():
        assert torch.equal(dense(x), torch.nn.functional.linear(x, dense.weight, dense.bias))
        if case == "decode_T1":     # and at 16 rows the W8A8 product, as PDense's
            x = t(normal(rng, 2, 16, 64))
            mod = PDense(64, 32)
            variables = {"params": {"kernel": dense.weight.numpy().T, "bias": dense.bias.numpy()},
                         "qparams": {"kernel_q": dense.weight_q.numpy().T, "kernel_s": dense.weight_s.numpy()}}
            np.testing.assert_array_equal(dense(x).numpy(), np.asarray(mod.apply(variables, jnp.asarray(x.numpy()))))
    if case == "decode_T1":         # no autograd through the W8A8 product
        with pytest.raises(RuntimeError, match="no backward"):
            dense(x)


# ---------------------------------------------------------------- the side-car


@pytest.fixture(scope="module")
def mpt():
    return make_family(MPT)


@pytest.mark.parametrize("bits", [8, 4])
def test_prefill_weights_match_jax(mpt, bits):
    jmodel, params, _, _ = mpt
    model = tq.quantize_prefill_weights(port_model(MPT, params), bits)
    mine = tq.decode_weights(model)
    vit = {n for n in mine if n.startswith("vision_encoder.")}
    assert vit == {f"vision_encoder.blocks.{i}.{lin}" for i in range(len(model.vision_encoder.blocks))
                   for lin in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")}
    assert all(mine[n][0].dtype == torch.int8 for n in vit)               # the ViT stays int8
    for variables in (params, _scan_variables(params, jmodel)):
        qvars = jq.quantize_prefill_params(variables, bits)
        theirs = decode_weights_from_jax(jax.tree.map(np.asarray, qvars))
        assert theirs.keys() == mine.keys()
        for name, (q, s) in mine.items():
            assert q.dtype == theirs[name][0].dtype, name
            assert torch.equal(q, theirs[name][0]) and torch.equal(s, theirs[name][1]), name
    packed = {n for n, (q, _) in mine.items() if q.dtype == torch.uint8}
    assert bool(packed) == (bits == 4)
    for name, (q, _) in mine.items():           # JAX's kernel_q / kernel_q4, the values W8A8 prefill multiplies
        w = tq.w8a8_weight(model.get_submodule(name))
        assert w.dtype == torch.int8 and torch.equal(w, tq.unpack_int4(q) if name in packed else q), name
    tq.drop_decode_weights(model)
    assert not tq.decode_weights(model)
    assert all(tq.w8a8_weight(m) is None for m in model.modules())


def test_vit_w8a8_matches_jax(rng, enabled):
    """The JAX test's tiny ViT (tests/test_w8a8.py) with the side-car bound:
    the W8A8 tokens of both packages, and their distance from the float
    forward (the path engaged)."""
    cfg = dict(image_size=28, patch_size=7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    jvit = JaxVisionTransformer(cfg=JaxVisionConfig(**cfg), dtype=jnp.float32)
    px = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    params = jvit.init(jax.random.PRNGKey(0), jnp.asarray(px))
    qtree = jq.quantize_prefill_params({"params": {"vision_encoder": params["params"], "lm": {}}})
    want = np.asarray(jvit.apply({**params, "qparams": qtree["qparams"]["vision_encoder"]}, jnp.asarray(px)))
    vit = VisionTransformer(VisionConfig(**cfg), device="cpu")
    vit.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tq.attach_decode_weights(vit, decode_weights_from_jax(jax.tree.map(np.asarray, qtree["qparams"]["vision_encoder"])))
    with torch.no_grad():
        got = vit(t(px))
        w8a8.ENABLED = False
        plain = vit(t(px))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)
    rel = np.linalg.norm(got.numpy() - plain.numpy()) / np.linalg.norm(plain.numpy())
    assert 0 < rel < 0.02, rel


# ---------------------------------------------------------------- the W8A8 side tile

SLOTS = {
    "qkv": dict(ln=True, bias=True),                             # q/k/v and fc1: LayerNorm, bias
    "out": dict(bias=True, residual=True),                       # out-projection
    "fc2_0": dict(act="quick_gelu", bias=True, residual=True),   # fc2 slice 0
    "fc2_1": dict(act="quick_gelu", residual=True),              # later fc2 slices
}
M_SIDE, SK, SN = 64, 64, 32


def side_operands(rng, slot):
    """(JAX side kwargs, port side kwargs) of one W8A8 slot: the port's int8
    side_w a column block of a wider (SN, 3 SK) weight (an fc2 slice, read
    with its row stride), its scales whole."""
    kind = SLOTS[slot]
    wide = normal(rng, SN, 3 * SK, scale=SK**-0.5)
    q, s = tq.quantize_weight(t(wide))
    q_side = q[:, SK:2 * SK]
    sx = normal(rng, M_SIDE, SK, scale=2.0)
    ln = (1 + normal(rng, SK, scale=0.1), normal(rng, SK, scale=0.1)) if kind.get("ln") else None
    b = normal(rng, SN, scale=0.1) if kind.get("bias") else None
    res = normal(rng, M_SIDE, SN) if kind.get("residual") else None
    common = dict(side_act=kind.get("act"), side_eps=1e-5)

    def opt(a, f):
        return None if a is None else f(a)

    jax_kw = dict(side_x=jnp.asarray(sx), side_w=jnp.asarray(q_side.numpy().T), side_w_scale=jnp.asarray(s.numpy()),
                  side_ln=opt(ln, lambda p: (jnp.asarray(p[0]), jnp.asarray(p[1]))), side_b=opt(b, jnp.asarray),
                  side_residual=opt(res, jnp.asarray), **common)
    port_kw = dict(side_x=t(sx), side_w=q_side, side_w_scale=s, side_ln=opt(ln, lambda p: (t(p[0]), t(p[1]))),
                   side_b=opt(b, t), side_residual=opt(res, t), **common)
    return jax_kw, port_kw


@pytest.mark.parametrize("main", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("slot", list(SLOTS))
def test_w8a8_side_tile_matches_pallas(rng, slot, main):
    b, k, k2, n = 4, 64, 128, 64
    x, ln, res = normal(rng, b, k), 1 + normal(rng, k, scale=0.1), normal(rng, b, n)
    w1, w2 = normal(rng, k2, k, scale=k**-0.5), normal(rng, n, k2, scale=k2**-0.5)
    if main == "fp32":
        jw1, jw2, pw1, pw2, jscales, pscales = w1.T, w2.T, t(w1), t(w2), {}, {}
    else:
        bits = 8 if main == "int8" else 4
        (q1, s1), (q2, s2) = tq.quantize_weight(t(w1), bits), tq.quantize_weight(t(w2), bits)
        dt = jnp.int8 if bits == 8 else jnp.int4
        jw1, jw2 = jnp.asarray(q1.numpy().T, dt), jnp.asarray(q2.numpy().T, dt)
        pw1, pw2 = (q1, q2) if bits == 8 else (tq.pack_int4(q1), tq.pack_int4(q2))
        jscales = dict(w1_scale=jnp.asarray(s1.numpy()), w2_scale=jnp.asarray(s2.numpy()))
        pscales = dict(w1_scale=s1, w2_scale=s2)
    jax_kw, port_kw = side_operands(rng, slot)
    want_y, want_so = jax_ds.fused_mlp(jnp.asarray(x), jnp.asarray(jw1), jnp.asarray(jw2), ln_scale=jnp.asarray(ln),
                                       residual=jnp.asarray(res), interpret=True, **jscales, **jax_kw)
    got_y, got_so = fused_mlp(t(x), pw1, pw2, ln_scale=t(ln), residual=t(res), **pscales, **port_kw)
    close(got_so, want_so)
    close(got_y, want_y)
    assert torch.equal(got_y, fused_mlp(t(x), pw1, pw2, ln_scale=t(ln), residual=t(res), **pscales))


@pytest.mark.parametrize("tile", ["float", "w8a8"])
@pytest.mark.parametrize("form", ["self", "gated"])
def test_attn_block_side_tile_matches_pallas(rng, form, tile):
    """K3 carrying a side tile (K2b-attn) against JAX attn_block_decode with
    side operands: y (and the caches written at the slot) as the call without
    a tile, side_out last."""
    b, h, dh, d, s, slot = 3, 4, 16, 64, 48, 40
    x, ln = normal(rng, b, d), 1 + normal(rng, d, scale=0.1)
    self_attn = form == "self"
    wq = normal(rng, (3 if self_attn else 1) * h * dh, d, scale=d**-0.5)
    wo = normal(rng, d, h * dh, scale=(h * dh) ** -0.5)
    kf, vf = normal(rng, b, h, s, dh, scale=1.0), normal(rng, b, h, s, dh, scale=1.0)
    mask = np.zeros((b, s), np.int32)
    mask[:, :slot + 1] = 1
    mask[1, :3] = 0
    kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, eps=1e-5)
    if self_attn:
        jkw = dict(kw, fused_qkv=True, slot=slot, slopes=alibi_slopes(h), clip=6.0)
        pkw = dict(kw, fused_qkv=True, slot=torch.tensor([slot], dtype=torch.int32), slopes=t(alibi_slopes(h)), clip=6.0)
    else:
        jkw = dict(kw, gate=jnp.asarray([0.4], jnp.float32))
        pkw = dict(kw, gate=t(np.array([0.4], np.float32)))
    jax_kw, port_kw = side_operands(rng, "qkv")
    if tile == "float":
        w = normal(rng, SN, SK, scale=SK**-0.5)
        jax_kw.update(side_w=jnp.asarray(w.T), side_w_scale=None)
        port_kw.update(side_w=t(w), side_w_scale=None)
    want = jax_attn_block(jnp.asarray(x), jnp.asarray(ln), None, jnp.asarray(wq.T), jnp.asarray(wo.T),
                          jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(mask), interpret=True, **jkw, **jax_kw)
    caches = (t(kf.copy()), t(vf.copy()))
    got = attn_block_decode(t(x), t(ln), None, t(wq), t(wo), *caches, t(mask).bool(), **pkw, **port_kw)
    plain_caches = (t(kf.copy()), t(vf.copy()))
    plain = attn_block_decode(t(x), t(ln), None, t(wq), t(wo), *plain_caches, t(mask).bool(), **pkw)
    assert len(got) == len(want) == (4 if self_attn else 2)
    for g, w in zip(got, want):
        close(g, w)
    for g, p in zip(got[:-1], plain if self_attn else (plain,)):
        assert torch.equal(g, p)                               # y and the caches as without the tile


# ---------------------------------------------------------------- the slice


def test_generate_int4_w8a8_matches_jax(mpt, enabled, monkeypatch):
    """Tiny OF-3B with int4 decode and W8A8 prefill (JAX
    tests/test_w8a8.py test_generate_int4_w8a8_compose_quality) against the
    scanned JAX model: greedy tokens exactly equal, the logits of prefill and
    of every decode step on JAX's stream within 1e-4, and W8A8 engaged (the
    prefill logits moved from the float prefill's)."""
    monkeypatch.setattr(jax_ds, "FORCE_FUSED", True)
    monkeypatch.setattr(jax_ds, "INTERPRET", True)
    monkeypatch.setattr(port_ds, "FORCE_FUSED", True)
    jmodel, params, vision_x, ids = mpt
    s_vars = _scan_variables(params, jmodel)
    jmodel = JaxFlamingo(cfg=dataclasses.replace(jmodel.cfg, scan_layers=True))
    qvars = jq.quantize_prefill_params(s_vars, bits=4)
    tmodel = port_model(MPT, s_vars, qvars)
    assert any(getattr(m, "weight_q", torch.empty(0)).dtype == torch.uint8 for m in tmodel.modules())
    jgen, pgen = gen_cfgs(MPT, False)
    mask = np.ones_like(ids)
    want = np.asarray(jax_generate(jmodel, qvars, vision_x, ids, mask, jgen))
    got = flamingo_generate(tmodel, t(vision_x), t(ids), t(mask), pgen, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    want_l = jax_step_logits(jmodel, qvars, vision_x, ids, mask, want, False)
    got_l = port_step_logits(tmodel, vision_x, ids, mask, want, False)
    for g, w in zip(got_l, want_l):
        close(g, w, LOGITS_ATOL)
    monkeypatch.setattr(w8a8, "ENABLED", False)
    float_prefill = port_step_logits(tmodel, vision_x, ids, mask, want[:, :1], False)[0]
    assert (float_prefill - got_l[0]).abs().max() > 10 * LOGITS_ATOL


# ---------------------------------------------------------------- the untied head and int_mm's shapes

UNTIED = {"gptneox": NEOX, "llama": LLAMA_OPT_SPECS["llama"]}


@pytest.fixture(scope="module")
def untied():
    out = {}
    for name, spec in UNTIED.items():
        jmodel, params, vision_x, ids = make_family(spec)
        out[name] = (jmodel, random_biases(params, 6) if name == "llama" else params, vision_x, ids)
    return out


# (family, bits): each model at the bits where no activation of its prefill
# lies at a rounding boundary. W8A8 rounds every activation to int8, and fp32
# sums taken in another order (~1e-6 apart) put an activation within 1e-5 of
# a .5 on either side: GPT-NeoX at bits 8 (inputs 9.5e-7 apart) and llama at
# bits 4 (an xattn FF activation at 55.500008 / 55.499992, inputs 1.7e-6
# apart) flip one int8 step, which grows to ~3e-2 by the head.
UNTIED_BITS = [("gptneox", 4), ("llama", 8)]


@pytest.mark.parametrize("family,bits", UNTIED_BITS)
def test_w8a8_prefill_untied_head_matches_jax(untied, enabled, monkeypatch, family, bits):
    """Quantized weights and W8A8 prefill on models with an untied head: the
    prefill logits within 1e-4 of JAX flamingo_generate's, and the same W8A8
    products in both packages (spied on `w8a8_dot`), the (V, D) head's among
    them."""
    spec = UNTIED[family]
    jmodel, params, vision_x, ids = untied[family]
    qvars = jq.quantize_prefill_params(params, bits=bits)
    tmodel = port_model(spec, params, qvars)
    products = {"jax": [], "port": []}
    for module, key, n_axis in ((jax_w8a8, "jax", 1), (w8a8, "port", 0)):
        def spy(x, w_q, *args, real=module.w8a8_dot, key=key, n_axis=n_axis, **kw):
            products[key].append((w_q.shape[n_axis], w_q.shape[1 - n_axis]))      # (N, K)
            return real(x, w_q, *args, **kw)

        monkeypatch.setattr(module, "w8a8_dot", spy)
    mask = np.ones_like(ids)
    want = jax_step_logits(jmodel, qvars, vision_x, ids, mask, ids[:, :1], False)[0]
    got = port_step_logits(tmodel, vision_x, ids, mask, ids[:, :1], False)[0]
    close(got, want, LOGITS_ATOL)
    head = (spec["lm"]["vocab_size"], spec["lm"]["hidden_size"])
    assert head in products["port"]
    assert sorted(products["port"]) == sorted(products["jax"])


@pytest.mark.parametrize("k,n", [(7, 7), (67, 67), (32003, 67), (67, 32003)])
@pytest.mark.parametrize("m", [1, 16, 17])
def test_int_mm_padding_is_exact(rng, m, k, n):
    a = t(rng.integers(-128, 128, size=(m, k)).astype(np.int8))
    b = t(rng.integers(-128, 128, size=(n, k)).astype(np.int8))
    a_p, b_p = w8a8.pad_for_int_mm(a, b)
    assert a_p.dtype == b_p.dtype == torch.int8
    assert a_p.shape[0] > 16 and a_p.shape[1] % 8 == 0 and b_p.shape[0] % 8 == 0 and b_p.shape[1] == a_p.shape[1]
    assert torch.equal((a_p.double() @ b_p.double().t())[:m, :n], a.double() @ b.double().t())
    assert torch.equal(w8a8.int8_matmul(a, b), (a.double() @ b.double().t()).float())
