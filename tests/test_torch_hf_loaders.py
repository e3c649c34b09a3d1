"""The port's HF loaders on tiny random HF models built from configs
(nothing is downloaded), against HF and against the JAX package's
converters on the CPU:

  * `convert/hf_lm.py` for MPT, GPT-NeoX, LLaMA and OPT: the port's
    FlamingoLM loaded strictly from an HF CausalLM gives HF's fp32 logits
    within tests/test_hf_parity_lm.py's 3e-4 / 1e-4 at the valid positions,
    full and left-padded; the state_dict is tensor for tensor
    `from_jax.state_dict_from_jax` of JAX `convert_lm_params`, and
    `config_from_hf` of the config object, of its config.json dict and
    JAX's agree;
  * `convert/hf_clip.py`: the port's ViT from an HF CLIPVisionModel within
    3e-5 of its patch tokens (tests/test_hf_parity_vit.py's bound), equal
    to JAX's conversion; open_clip naming on a synthetic state_dict (open_clip
    is not installed) made from the same weights gives the same weights.
"""

import dataclasses

import numpy as np
import pytest
import torch
import transformers
from test_hf_parity_lm import _hf_model

from open_flamingo_tpu.convert import hf_clip as jax_hf_clip
from open_flamingo_tpu.convert import hf_lm as jax_hf_lm
from open_flamingo_tpu_torch.configs import DecoderConfig
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.convert.hf_clip import convert_clip_vision_params, vision_config_from_hf
from open_flamingo_tpu_torch.convert.hf_lm import config_from_hf, convert_lm_params
from open_flamingo_tpu_torch.models.lm import FlamingoLM
from open_flamingo_tpu_torch.models.vit import VisionTransformer

B, T, VOCAB = 2, 12, 96
FAMILIES = ["mpt", "gptneox", "llama", "opt"]


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_lm_loader_matches_hf_and_jax(rng, family, padded):
    torch.manual_seed(0)
    hf = _hf_model(family).eval()
    cfg = config_from_hf(hf.config)
    assert cfg == config_from_hf(hf.config.to_dict())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_hf_lm.config_from_hf(hf.config))
    sd = convert_lm_params(hf.state_dict(), cfg)
    jax_params = jax_hf_lm.convert_lm_params(jax_hf_lm.to_numpy_state_dict(hf), jax_hf_lm.config_from_hf(hf.config))
    assert_same(sd, state_dict_from_jax(jax_params))

    model = FlamingoLM(cfg, device="cpu")
    model.load_state_dict(sd)
    mask = np.ones((B, T), np.int64)
    if padded:
        mask[0, :3] = 0
        mask[1, :5] = 0
    ids = torch.tensor(rng.integers(0, VOCAB, size=(B, T)))
    mask_t = torch.tensor(mask)
    with torch.no_grad():
        kw = {} if family == "mpt" else {"position_ids": (mask_t.cumsum(-1) - 1).clamp(min=0)}
        want = hf(input_ids=ids, attention_mask=mask_t, **kw).logits.numpy()
        got, _ = model(ids, mask_t)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=3e-4, rtol=1e-4)


def test_gptj_waits_for_its_block():
    hf_cfg = transformers.GPTJConfig(n_embd=64, n_head=4, n_layer=2, rotary_dim=8, vocab_size=VOCAB)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_hf(hf_cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert_lm_params({}, DecoderConfig(family="gptj", vocab_size=VOCAB, hidden_size=64, num_layers=2,
                                            num_heads=4, intermediate_size=256))


def tiny_clip():
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=28, patch_size=7, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, hidden_act="quick_gelu", attention_dropout=0.0,
    )
    torch.manual_seed(0)
    return transformers.CLIPVisionModel(hf_cfg).eval()


@pytest.mark.parametrize("post_ln", [False, True])
def test_clip_loader_matches_hf_and_jax(rng, post_ln):
    hf = tiny_clip()
    cfg = dataclasses.replace(vision_config_from_hf(hf.config), post_ln_tokens=post_ln)
    assert cfg == dataclasses.replace(vision_config_from_hf(hf.config.to_dict()), post_ln_tokens=post_ln)
    jcfg = dataclasses.replace(jax_hf_clip.vision_config_from_hf(hf.config), post_ln_tokens=post_ln)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sd = convert_clip_vision_params(hf.state_dict(), cfg)
    assert_same(sd, state_dict_from_jax(jax_hf_clip.convert_clip_vision_params(hf.state_dict(), jcfg)))

    vit = VisionTransformer(cfg, device="cpu")
    missing = vit.load_state_dict(sd, strict=False).missing_keys
    assert missing == ([] if post_ln else ["post_layernorm.weight", "post_layernorm.bias"])
    imgs = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.tensor(imgs.transpose(0, 3, 1, 2))).last_hidden_state
        want = (hf.vision_model.post_layernorm(out) if post_ln else out)[:, 1:].numpy()
        got = vit(torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def open_clip_state_dict(hf, prefix="visual."):
    """The HF tower's weights under open_clip's VisionTransformer names."""
    sd = {k.removeprefix("vision_model."): v for k, v in hf.state_dict().items()}
    out = {
        "class_embedding": sd["embeddings.class_embedding"],
        "positional_embedding": sd["embeddings.position_embedding.weight"],
        "conv1.weight": sd["embeddings.patch_embedding.weight"],
        "ln_pre.weight": sd["pre_layrnorm.weight"], "ln_pre.bias": sd["pre_layrnorm.bias"],
        "ln_post.weight": sd["post_layernorm.weight"], "ln_post.bias": sd["post_layernorm.bias"],
        "proj": torch.randn(32, 16),
    }
    for i in range(hf.config.num_hidden_layers):
        h, o = f"encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for p in ("weight", "bias"):
            out[o + "attn.in_proj_" + p] = torch.cat([sd[h + f"self_attn.{n}_proj.{p}"] for n in "qkv"])
            out[o + f"attn.out_proj.{p}"] = sd[h + f"self_attn.out_proj.{p}"]
            out[o + f"ln_1.{p}"] = sd[h + f"layer_norm1.{p}"]
            out[o + f"ln_2.{p}"] = sd[h + f"layer_norm2.{p}"]
            out[o + f"mlp.c_fc.{p}"] = sd[h + f"mlp.fc1.{p}"]
            out[o + f"mlp.c_proj.{p}"] = sd[h + f"mlp.fc2.{p}"]
    out = {prefix + k: v for k, v in out.items()}
    if prefix:       # a whole CLIP: the text tower is skipped
        out["token_embedding.weight"] = torch.randn(VOCAB, 32)
    return out


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_open_clip_naming(prefix):
    hf = tiny_clip()
    cfg = vision_config_from_hf(hf.config)
    oc = open_clip_state_dict(hf, prefix)
    got = convert_clip_vision_params(oc, cfg)
    assert_same(got, convert_clip_vision_params(hf.state_dict(), cfg))
    want = state_dict_from_jax(jax_hf_clip.convert_clip_vision_params({k: v.numpy() for k, v in oc.items()}, cfg))
    assert_same(got, {k: v for k, v in want.items() if k != "proj"})     # the port's ViT has no projection


def test_state_dict_arrays_and_bf16_load_alike():
    """Arrays and bf16 tensors come in as fp32 tensors."""
    torch.manual_seed(0)
    hf = _hf_model("gptneox")
    cfg = config_from_hf(hf.config)
    want = convert_lm_params(hf, cfg)
    assert_same(convert_lm_params({k: v.numpy() for k, v in hf.state_dict().items()}, cfg), want)
    bf16 = convert_lm_params({k: v.bfloat16() for k, v in hf.state_dict().items()}, cfg)
    assert all(v.dtype == torch.float32 for v in bf16.values())
    assert_same(bf16, {k: v.bfloat16().float() for k, v in want.items()})
