"""The port's training step against the JAX package's on the CPU: label
masking, the loss, the optimizer chain against optax, the trainable
partition, one and three train steps of the tiny OF-3B-shaped Flamingo
against JAX `make_train_step` (losses, every trainable gradient, the
parameters after three steps), the NaN skip, the embedding-row mask,
uint8 vision input, gradient checkpointing, and the decode kernels'
refusal of autograd.

The train steps run twice on each side: (a) both packages on their einsum
paths; (b) the JAX package with `flash_attention` and `masked_xattn`
forced into Pallas interpret mode (8-row blocks, so several per call) and
the port on its kernel route, whose autograd Functions run the plain
versions of K4/K4b and K5/K5b on CPU tensors. Weights come from the JAX
init through `convert/from_jax.py`, with the xattn gates at 0.5; both
batches hold right padding and an <|endofchunk|>, and the MMC4-like one
text before its first image. fp32 throughout: losses within 1e-5,
gradients and parameters within 1e-4 (different summation orders through
two layers and the optimizer's normalisation; lr 1e-4 keeps a gradient
whose sign is at rounding level from moving a parameter by more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import open_flamingo_tpu.models.lm as jax_lm
import open_flamingo_tpu.models.xattn as jax_xattn
import open_flamingo_tpu.ops.attention as jax_attention
import open_flamingo_tpu.ops.flash_attention as jax_flash
import open_flamingo_tpu.ops.masked_xattn as jax_mx
import open_flamingo_tpu_torch.models.xattn as port_xattn
import open_flamingo_tpu_torch.ops.attention as port_attention
import open_flamingo_tpu_torch.ops.flash_attention as port_flash
import open_flamingo_tpu_torch.ops.masked_xattn as port_mx
from open_flamingo_tpu.models.decoders.common import DecoderConfig as JaxDecoderConfig
from open_flamingo_tpu.models.flamingo import Flamingo as JaxFlamingo
from open_flamingo_tpu.models.flamingo import FlamingoConfig as JaxFlamingoConfig
from open_flamingo_tpu.models.vit import VisionConfig as JaxVisionConfig
from open_flamingo_tpu.train import losses as jax_losses
from open_flamingo_tpu.train import optimizer as jax_opt
from open_flamingo_tpu.train import train_loop as jax_loop
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_flat, state_dict_from_jax
from open_flamingo_tpu_torch.image_processing import CLIP_MEAN, CLIP_STD
from open_flamingo_tpu_torch.models.flamingo import Flamingo
from open_flamingo_tpu_torch.ops.decode_attention import decode_attention, decode_attention_update
from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode, reference_attn_block
from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp, reference_dense, reference_mlp
from open_flamingo_tpu_torch.train.losses import IGNORE, lm_loss, mask_labels_interleaved, mask_labels_paired
from open_flamingo_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer, split_params
from open_flamingo_tpu_torch.train.train_loop import TrainLoopConfig, TrainState, batch_losses, make_train_step

from test_train import ref_mask_interleaved

VOCAB, MEDIA, EOC, PAD = 64, 5, 6, 1
B, T_L, T_M = 2, 16, 24
LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4
VIS = dict(image_size=14, patch_size=7, hidden_size=24, num_layers=2, num_heads=2, intermediate_size=32)
LM = dict(
    family="mpt", vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, alibi=True, attention_bias=False, ln_no_bias=True,
)
FLAMINGO = dict(
    media_token_id=MEDIA, eoc_token_id=EOC, cross_attn_every_n=1,
    num_vis_latents=4, perceiver_depth=2, perceiver_heads=2, perceiver_dim_head=8,
)
OPT = dict(learning_rate=1e-4, warmup_steps=2, weight_decay=0.1)


# ---------------------------------------------------------------- losses


def test_mask_labels_match_jax_and_the_reference_loops(rng):
    for _ in range(20):
        ids = rng.integers(0, 12, size=(3, 24))
        got = mask_labels_interleaved(torch.from_numpy(ids), PAD, MEDIA, EOC).numpy()
        np.testing.assert_array_equal(got, ref_mask_interleaved(ids.copy(), PAD, MEDIA, EOC))
        np.testing.assert_array_equal(got, np.asarray(jax_losses.mask_labels_interleaved(jnp.asarray(ids), PAD, MEDIA, EOC)))
        np.testing.assert_array_equal(mask_labels_paired(torch.from_numpy(ids), PAD, MEDIA).numpy(),
                                      np.asarray(jax_losses.mask_labels_paired(jnp.asarray(ids), PAD, MEDIA)))
    assert IGNORE == jax_losses.IGNORE


def test_lm_loss_matches_jax(rng):
    logits = rng.normal(size=(3, 10, VOCAB)).astype(np.float32) * 3
    labels = rng.integers(0, VOCAB, size=(3, 10))
    labels[0, 4:] = IGNORE
    labels[2] = IGNORE                       # a row with no target
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(jax_losses.lm_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    none = np.full_like(labels, IGNORE)
    assert lm_loss(torch.from_numpy(logits), torch.from_numpy(none)).item() == 0.0


# ---------------------------------------------------------------- optimizer

OPT_PATHS = {
    ("params", "lm", "wte", "embedding"): (12, 8),
    ("params", "lm", "xattn_0", "attn", "to_q", "kernel"): (8, 6),
    ("params", "lm", "xattn_0", "attn_gate"): (1,),
    ("params", "perceiver", "latents"): (4, 8),
    ("params", "perceiver", "layers_0_ff", "fc1", "kernel"): (8, 16),
}


@pytest.mark.parametrize("sched", [
    dict(warmup_steps=0), dict(warmup_steps=2, schedule="cosine", total_steps=6),
    dict(warmup_steps=1, schedule="linear", total_steps=5),
])
def test_optimizer_matches_optax_chain(rng, sched):
    """Three updates on the same parameters and gradients; the gradients'
    global norm is above the clip, and the embedding rows are masked."""
    cfg = dict(learning_rate=3e-2, weight_decay=0.1, grad_clip=1.0, **sched)
    params = {k: rng.normal(size=shape).astype(np.float32) for k, shape in OPT_PATHS.items()}
    grads = [{k: rng.normal(size=shape).astype(np.float32) for k, shape in OPT_PATHS.items()} for _ in range(3)]
    media, eoc = 3, 7
    jtx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**cfg), media_token_id=media, eoc_token_id=eoc)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tparams = state_dict_from_flat(params)
    ttx = make_optimizer(OptimizerConfig(**cfg), media_token_id=media, eoc_token_id=eoc)
    tstate = ttx.init(tparams)
    for g in grads:
        assert float(optax.global_norm(g)) > 1.0
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = ttx.update(state_dict_from_flat(g), tstate, tparams)
        want = state_dict_from_flat({k: np.asarray(v) for k, v in jparams.items()})
        for name, p in tparams.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
    assert tstate.count == 3
    wte = tparams["lm.wte.weight"].numpy()
    others = np.setdiff1d(np.arange(12), [media, eoc])
    np.testing.assert_array_equal(wte[others], params[("params", "lm", "wte", "embedding")][others])


# ---------------------------------------------------------------- the train step


def set_gates(params, value=0.5):
    def f(path, x):
        name = jax.tree_util.keystr(path)
        return jnp.full_like(x, value) if ("attn_gate" in name or "ff_gate" in name) else x
    return jax.tree_util.tree_map_with_path(f, params)


def make_batches(rng):
    """LAION-like: <image> caption <|endofchunk|>, row 1 right-padded.
    MMC4-like: text, <image>, text, <|endofchunk|>, <image>, text; row 0
    right-padded."""
    ids_l = rng.integers(7, VOCAB, size=(B, T_L)).astype(np.int32)
    ids_l[:, 0] = MEDIA
    ids_l[0, T_L - 1] = EOC
    ids_l[1, 10] = EOC
    ids_l[1, 11:] = PAD
    mask_l = (np.arange(T_L)[None, :] < np.array([[T_L], [11]])).astype(np.int32)
    ids_m = rng.integers(7, VOCAB, size=(B, T_M)).astype(np.int32)
    ids_m[:, 2] = MEDIA
    ids_m[:, 10] = EOC
    ids_m[:, 11] = MEDIA
    ids_m[0, 20:] = PAD
    mask_m = (np.arange(T_M)[None, :] < np.array([[20], [T_M]])).astype(np.int32)
    bl = dict(vision_x=rng.normal(size=(B, 1, 1, 14, 14, 3)).astype(np.float32), input_ids=ids_l, attention_mask=mask_l)
    bm = dict(vision_x=rng.normal(size=(B, 2, 1, 14, 14, 3)).astype(np.float32), input_ids=ids_m, attention_mask=mask_m)
    return bl, bm


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_model(params, **cfg_kw):
    cfg = FlamingoConfig(vision=VisionConfig(**VIS), lm=DecoderConfig(**LM), **FLAMINGO, **cfg_kw)
    model = Flamingo(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    bl, bm = make_batches(rng)
    jmodel = JaxFlamingo(cfg=JaxFlamingoConfig(vision=JaxVisionConfig(**VIS), lm=JaxDecoderConfig(**LM), **FLAMINGO))
    params = set_gates(jmodel.init(jax.random.PRNGKey(0), bl["vision_x"], bl["input_ids"], bl["attention_mask"]))
    return jmodel, params, bl, bm


def jax_run(jmodel, params, bl, bm, steps):
    """Per step: JAX's (total, laion, mmc4) losses and gradients at the
    step's parameters, then `make_train_step`; and the final parameters."""
    train, frozen = jax_opt.split_params(params)
    tx = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT), media_token_id=MEDIA, eoc_token_id=EOC)
    cfg = jax_loop.TrainLoopConfig(pad_token_id=PAD)

    def loss_fn(trainable, frozen, bl, bm):
        loss_l, loss_m = jax_loop.batch_losses(jmodel, jax_opt.merge_params(trainable, frozen), bl, bm, cfg)
        return cfg.loss_multiplier_laion * loss_l + cfg.loss_multiplier_mmc4 * loss_m, (loss_l, loss_m)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    step = jax.jit(jax_loop.make_train_step(jmodel, tx, cfg))
    state = jax_loop.TrainState.create(train, tx)
    record = []
    for _ in range(steps):
        (total, (loss_l, loss_m)), grads = grad_fn(state.params, frozen, bl, bm)
        state, metrics = step(state, frozen, bl, bm)
        np.testing.assert_allclose(float(metrics["loss"]), float(total), rtol=1e-6)
        record.append(((float(total), float(loss_l), float(loss_m)), state_dict_from_flat(jax.tree.map(np.asarray, grads))))
    return record, state_dict_from_flat(jax.tree.map(np.asarray, state.params))


def port_run(model, bl, bm, steps):
    trainable, _ = split_params(model)
    tx = make_optimizer(OptimizerConfig(**OPT), media_token_id=MEDIA, eoc_token_id=EOC)
    step = make_train_step(model, tx, TrainLoopConfig(pad_token_id=PAD))
    state = TrainState.create(trainable, tx)
    record = []
    for _ in range(steps):
        state, m = step(state, torch_batch(bl), torch_batch(bm))
        record.append(((m["loss"].item(), m["loss_laion"].item(), m["loss_mmc4"].item()),
                       {n: p.grad.clone() for n, p in trainable.items()}))
    assert state.step == steps and state.opt_state.count == steps
    return record, {n: p.detach().clone() for n, p in trainable.items()}


def compare(jax_result, port_result):
    (jrec, jparams), (trec, tparams) = jax_result, port_result
    assert set(tparams) == set(jparams)
    for (jl, jg), (tl, tg) in zip(jrec, trec):
        np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
        for name, g in tg.items():
            np.testing.assert_allclose(g.numpy(), jg[name].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.fixture
def kernel_routes(monkeypatch):
    """JAX: flash_attention and masked_xattn in Pallas interpret mode with
    8-row blocks. Port: the kernel route on CPU tensors (its autograd
    Functions, which run the plain versions there). Counts the backward
    calls on both sides."""
    calls = {"jax_flash": 0, "jax_xattn": 0, "port_flash_bwd": 0, "port_xattn_bwd": 0}
    real_flash, real_mx = jax_flash.flash_attention, jax_mx.masked_xattn

    def flash(q, k, v, pad, slopes, q_offset, causal=True, scale=1.0, *_):
        calls["jax_flash"] += 1
        return real_flash(q, k, v, pad, slopes, q_offset, causal, scale, 8, 8, True)

    def xattn(q, k, v, tt, n_latents, scale=1.0, *_):
        calls["jax_xattn"] += 1
        return real_mx(q, k, v, tt, n_latents, scale, 8, 8, True)

    monkeypatch.setattr(jax_flash, "flash_attention", flash)
    monkeypatch.setattr(jax_mx, "masked_xattn", xattn)
    monkeypatch.setattr(jax_attention, "_use_flash", lambda q, attn: q.shape[1] >= 8 and attn.pad_mask is not None)
    for module in (jax_xattn, jax_lm):
        monkeypatch.setattr(module, "use_xattn_kernel", lambda tq, immediate: immediate and tq >= 8)

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(port_flash, "flash_attention_backward", "port_flash_bwd")
    counted(port_mx, "masked_xattn_backward", "port_xattn_bwd")
    for module in (port_attention, port_xattn):
        monkeypatch.setattr(module, "use_kernels", lambda x: not port_attention._PLAIN)
    return calls


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_einsum_path(setup, steps):
    jmodel, params, bl, bm = setup
    compare(jax_run(jmodel, params, bl, bm, steps), port_run(port_model(params), bl, bm, steps))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax_pallas_interpret(setup, kernel_routes, steps):
    jmodel, params, bl, bm = setup
    jax_result = jax_run(jmodel, params, bl, bm, steps)
    assert kernel_routes["jax_flash"] and kernel_routes["jax_xattn"]
    port_result = port_run(port_model(params), bl, bm, steps)
    layers = LM["num_layers"]
    # one backward per layer and source in every step
    assert kernel_routes["port_flash_bwd"] == kernel_routes["port_xattn_bwd"] == 2 * layers * steps
    compare(jax_result, port_result)


def test_split_params_matches_jax_partition(setup):
    jmodel, params, bl, _ = setup
    jtrain, jfrozen = jax_opt.split_params(params)
    model = port_model(params)
    trainable, frozen = split_params(model)
    assert set(trainable) == set(state_dict_from_flat(jtrain))
    assert set(frozen) == set(state_dict_from_flat(jfrozen))
    assert all(p.requires_grad for p in trainable.values()) and not any(p.requires_grad for p in frozen.values())
    # the model's own default is the same partition; the ViT runs without gradient
    fresh = port_model(params)
    assert {n for n, p in fresh.named_parameters() if p.requires_grad} == set(trainable)
    lat = fresh.embed_vision(torch.from_numpy(bl["vision_x"]))
    assert lat.requires_grad
    frozen_lm = split_params(port_model(params), freeze_lm_embeddings=True)[0]
    assert set(frozen_lm) == set(trainable) - {"lm.wte.weight"}


def test_nan_batch_is_skipped(setup):
    _, params, bl, bm = setup
    model = port_model(params)
    trainable, _ = split_params(model)
    tx = make_optimizer(OptimizerConfig(learning_rate=1e-3, warmup_steps=0), media_token_id=MEDIA, eoc_token_id=EOC)
    step = make_train_step(model, tx, TrainLoopConfig(pad_token_id=PAD))
    state = TrainState.create(trainable, tx)
    state, _ = step(state, torch_batch(bl), torch_batch(bm))       # moments become nonzero
    before = {n: p.detach().clone() for n, p in trainable.items()}
    mu = {n: m.clone() for n, m in state.opt_state.mu.items()}
    bad = dict(torch_batch(bl), vision_x=torch.full((B, 1, 1, 14, 14, 3), float("nan")))
    new_state, metrics = step(state, bad, torch_batch(bm))
    assert not np.isfinite(metrics["loss"].item())
    assert new_state.step == 2 and new_state.opt_state.count == 1
    for n, p in trainable.items():
        assert torch.equal(p.detach(), before[n]), n
        assert torch.equal(new_state.opt_state.mu[n], mu[n]), n


def test_embedding_rows_other_than_media_and_eoc_stay(setup):
    _, params, bl, bm = setup
    model = port_model(params)
    trainable, _ = split_params(model)
    wte0 = model.lm.wte.weight.detach().clone()
    tx = make_optimizer(OptimizerConfig(learning_rate=3e-3, warmup_steps=0), media_token_id=MEDIA, eoc_token_id=EOC)
    step = make_train_step(model, tx, TrainLoopConfig(pad_token_id=PAD))
    state = TrainState.create(trainable, tx)
    losses = []
    for _ in range(3):
        state, m = step(state, torch_batch(bl), torch_batch(bm))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    moved = (model.lm.wte.weight.detach() != wte0).any(-1)
    assert moved[MEDIA] and moved[EOC]
    moved[[MEDIA, EOC]] = False
    assert not moved.any()
    assert model.lm.wte.weight.grad[7:].abs().sum() > 0           # the raw gradient reaches every used row


def test_uint8_vision_matches_float(setup, rng):
    _, params, bl, bm = setup
    model = port_model(params)
    u8 = rng.integers(0, 256, size=(B, 1, 1, 14, 14, 3)).astype(np.uint8)
    host = ((u8.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32))
    cfg = TrainLoopConfig(pad_token_id=PAD)
    with torch.no_grad():
        got = batch_losses(model, dict(torch_batch(bl), vision_x=torch.from_numpy(u8)), torch_batch(bm), cfg)
        want = batch_losses(model, dict(torch_batch(bl), vision_x=torch.from_numpy(host)), torch_batch(bm), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)


def test_gradient_checkpointing_gives_equal_gradients(setup):
    _, params, bl, bm = setup
    grads = []
    for remat in (False, True):
        model = port_model(params, gradient_checkpointing=remat)
        assert model.lm.gradient_checkpointing is remat
        loss_l, loss_m = batch_losses(model, torch_batch(bl), torch_batch(bm), TrainLoopConfig(pad_token_id=PAD))
        (0.2 * loss_l + loss_m).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-7, rtol=0, msg=name)


def test_decode_kernels_refuse_autograd():
    """K1-K3 and K7 have no backward: with grad mode on and an operand that
    requires grad, their wrappers and plain versions raise instead of
    returning a tensor without grad_fn."""
    b, d, h, dh, s = 2, 16, 2, 8, 8
    x = torch.randn(b, d)
    w = torch.randn(24, d, requires_grad=True)
    w2 = torch.randn(d, 24)
    kc, vc = torch.randn(b, h, s, dh), torch.randn(b, h, s, dh)
    mask = torch.ones(b, s, dtype=torch.bool)
    wq, wo = torch.randn(h * dh, d, requires_grad=True), torch.randn(d, h * dh)
    q = torch.randn(b, h, dh, requires_grad=True)
    calls = {
        "fused_dense": lambda: fused_dense(x, w),
        "reference_dense": lambda: reference_dense(x, w),
        "fused_mlp": lambda: fused_mlp(x, w, w2),
        "reference_mlp": lambda: reference_mlp(x, w, w2),
        "attn_block_decode": lambda: attn_block_decode(x, torch.ones(d), None, wq, wo, kc, vc, mask, heads=h,
                                                       head_dim=dh, scale=0.3),
        "reference_attn_block": lambda: reference_attn_block(x, torch.ones(d), None, wq, wo, kc, vc, mask, heads=h,
                                                             head_dim=dh, scale=0.3),
        "decode_attention": lambda: decode_attention(q, kc, vc, mask),
        "decode_attention_update": lambda: decode_attention_update(q, kc.clone(), vc.clone(), q.detach(),
                                                                   q.detach(), mask, 3),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
