"""The port's entry point and its transforms against the JAX package on the
CPU: `create_model_and_transforms` (configs, special-token ids, vocabulary,
random weights, local HF checkpoints grafted with the added vocabulary rows
kept), the tokenizer, image processing, the released trainable-only
checkpoint format and `save_pretrained` / `load_pretrained`.

Bounds: the tokenizer's ids, `ImageProcessor`'s pixels and every converted
or saved weight are bit for bit; `preprocess_images_on_device` is within
IMAGE_ATOL of JAX's `jax.image.resize` path (its weights are built in fp32
as JAX builds them; XLA contracts some products into FMAs, ~1 ulp, and sums
in another order).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from test_factory import TINY_LM as JAX_TINY_LM
from test_factory import TINY_VIS as JAX_TINY_VIS
from test_flamingo import tiny_flamingo
from test_tokenization import _tiny_hf_tokenizer

from open_flamingo_tpu import factory as jax_factory
from open_flamingo_tpu import image_processing as jax_images
from open_flamingo_tpu import serialization as jax_serialization
from open_flamingo_tpu import tokenization as jax_tokenization
from open_flamingo_tpu.convert import flamingo_ckpt as jax_ckpt
from open_flamingo_tpu_torch import create_model_and_transforms, image_processing, tokenization
from open_flamingo_tpu_torch.configs import DecoderConfig, FlamingoConfig, VisionConfig
from open_flamingo_tpu_torch.convert.flamingo_ckpt import convert_flamingo_checkpoint, export_flamingo_checkpoint
from open_flamingo_tpu_torch.convert.from_jax import state_dict_from_jax
from open_flamingo_tpu_torch.models.flamingo import Flamingo, init_random
from open_flamingo_tpu_torch.serialization import config_to_dict, load_pretrained, save_pretrained
from open_flamingo_tpu_torch.train.optimizer import is_trainable

IMAGE_ATOL = 1e-5
TINY_VIS = VisionConfig(**dataclasses.asdict(JAX_TINY_VIS))
TINY_LM = DecoderConfig(**dataclasses.asdict(JAX_TINY_LM))


def as_dict(cfg):
    """A FlamingoConfig of either package as a dict, JAX's scan_layers left out."""
    d = dataclasses.asdict(cfg)
    d.pop("scan_layers", None)
    return d


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


# ---------------------------------------------------------------- entry point

FACTORY_CASES = {
    "tiny_every2": ((TINY_VIS, "openai", TINY_LM), (JAX_TINY_VIS, "openai", JAX_TINY_LM), dict(cross_attn_every_n_layers=2)),
    "vit_tiny_gc": (("ViT-Tiny", "openai", TINY_LM), ("ViT-Tiny", "openai", JAX_TINY_LM),
                    dict(gradient_checkpointing=True)),
    "of3b": (("ViT-L-14", "openai", "mosaicml/mpt-1b-redpajama-200b"),) * 2 + (dict(),),
    "of4b": (("ViT-L-14", "openai", "togethercomputer/RedPajama-INCITE-Base-3B-v1"),) * 2
            + (dict(cross_attn_every_n_layers=2),),
    "vit_b32_mpt7b": (("ViT-B-32", "openai", "mosaicml/mpt-7b"),) * 2 + (dict(cross_attn_every_n_layers=4),),
}


@pytest.mark.parametrize("case", list(FACTORY_CASES))
def test_factory_configs_and_ids_equal_jax(case):
    port_args, jax_args, kw = FACTORY_CASES[case]
    model, image_processor, tok = create_model_and_transforms(*port_args, device="cpu", **kw)
    jmodel, params, jproc, jtok = jax_factory.create_model_and_transforms(*jax_args, **kw)
    assert params is None and model.device.type == "meta"      # shapes only, as JAX gives no params
    assert as_dict(model.cfg) == as_dict(jmodel.cfg)
    assert dataclasses.asdict(image_processor) == dataclasses.asdict(jproc)
    text = f"{tokenization.MEDIA_TOKEN}a photo of a cat{tokenization.EOC_TOKEN} {tokenization.MEDIA_TOKEN}a dog"
    assert tok.encode(text) == jtok.encode(text)
    assert tok.encode(tokenization.MEDIA_TOKEN) == [model.cfg.media_token_id]
    assert tok.encode(tokenization.EOC_TOKEN) == [model.cfg.eoc_token_id]
    np.testing.assert_array_equal(tok(text)["input_ids"], jtok(text)["input_ids"])
    assert int(tok(text, return_tensors="pt")["input_ids"].max()) < model.cfg.lm.vocab_size


def test_factory_of3b_ids():
    model, _, _ = create_model_and_transforms(device="cpu")
    assert (model.cfg.eoc_token_id, model.cfg.media_token_id, model.cfg.lm.vocab_size) == (50432, 50433, 50434)


def test_factory_init_params_is_init_random():
    model, _, _ = create_model_and_transforms(TINY_VIS, "openai", TINY_LM, init_params=True, init_seed=3,
                                              device="cpu", dtype=torch.bfloat16)
    want = init_random(model.cfg, 3, device="cpu", dtype=torch.bfloat16)
    assert_same(model.state_dict(), want.state_dict())
    with torch.no_grad():
        logits, _, _ = model(torch.zeros(1, 1, 1, 14, 14, 3), torch.tensor([[97, 5, 6, 7]]))
    assert logits.shape == (1, 4, 98)


def test_factory_grafts_local_hf_checkpoints(tmp_path):
    """A local HF MPT directory (config and weights) and tokenizer, and an HF
    CLIP state_dict: base vocabulary rows and blocks from the checkpoint, the
    added token rows and everything else from init_random."""
    hf_cfg = transformers.MptConfig(
        d_model=32, n_heads=4, n_layers=2, vocab_size=27, max_seq_len=64,
        attn_config=transformers.models.mpt.configuration_mpt.MptAttentionConfig(attn_pdrop=0.0))
    torch.manual_seed(0)
    hf = transformers.MptForCausalLM(hf_cfg)
    hf.save_pretrained(tmp_path / "mpt", safe_serialization=True)
    tok_dir = tmp_path / "tok"
    tok_dir.mkdir()
    _tiny_hf_tokenizer(tok_dir).save_pretrained(tok_dir)
    clip = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        image_size=14, patch_size=7, hidden_size=24, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, hidden_act="quick_gelu"))

    kw = dict(tokenizer_path=str(tok_dir), vision_checkpoint=clip.state_dict())
    model, _, tok = create_model_and_transforms(TINY_VIS, "openai", str(tmp_path / "mpt"), device="cpu",
                                                init_seed=1, **kw)
    # JAX's factory reads the same config and tokenizer (its params, which
    # it would init and graft, are left out: the port's weights are checked below)
    jlm, _ = jax_factory._resolve_lm_config(str(tmp_path / "mpt"))
    jtok, media, eoc = jax_tokenization.prepare_hf_tokenizer(_tiny_hf_tokenizer(tmp_path))
    # <|endofchunk|>, <image>, <PAD> after the 28 GPT-2 ids; vocab 31 > the LM's 27
    assert (model.cfg.eoc_token_id, model.cfg.media_token_id, model.cfg.lm.vocab_size) == (eoc, media, 31) == (28, 29, 31)
    assert dataclasses.asdict(model.cfg.lm) == dataclasses.asdict(dataclasses.replace(jlm, vocab_size=31))
    text = f"{tokenization.MEDIA_TOKEN}abc{tokenization.EOC_TOKEN}"
    assert tok(text)["input_ids"] == jtok(text)["input_ids"]

    base = init_random(model.cfg, 1, device="cpu")
    sd, ref = model.state_dict(), base.state_dict()
    torch.testing.assert_close(sd["lm.wte.weight"][:27], hf.transformer.wte.weight.detach(), atol=0, rtol=0)
    torch.testing.assert_close(sd["lm.wte.weight"][27:], ref["lm.wte.weight"][27:], atol=0, rtol=0)
    torch.testing.assert_close(sd["lm.blocks.1.Wqkv.weight"], hf.transformer.blocks[1].attn.Wqkv.weight.detach(),
                               atol=0, rtol=0)
    torch.testing.assert_close(sd["vision_encoder.blocks.0.fc1.weight"], clip.vision_model.encoder.layers[0].mlp.fc1
                               .weight.detach(), atol=0, rtol=0)
    untouched = [k for k in sd if k.startswith(("perceiver.", "lm.xattn."))]
    assert untouched and all(torch.equal(sd[k], ref[k]) for k in untouched)


def test_graft_refuses_unknown_and_misshapen_weights():
    from open_flamingo_tpu_torch.factory import _graft

    model = init_random(FlamingoConfig(vision=TINY_VIS, lm=TINY_LM, media_token_id=97, eoc_token_id=96,
                                       num_vis_latents=4, perceiver_depth=1), 0, device="cpu")
    with pytest.raises(KeyError, match="does not have"):
        _graft(model.lm, {"blocks.9.Wqkv.weight": torch.zeros(96, 32)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        _graft(model.lm, {"blocks.0.Wqkv.weight": torch.zeros(96, 31)}, resize_vocab=True)


# ---------------------------------------------------------------- tokenizer

def test_simple_tokenizer_equals_jax():
    words = ["a", "photo", "of", "cat"]
    tok, jtok = tokenization.SimpleTokenizer(words, vocab_size=12), jax_tokenization.SimpleTokenizer(words, vocab_size=12)
    for t in (tok, jtok):
        t.pin(tokenization.EOC_TOKEN, 100)
        t.pin(tokenization.MEDIA_TOKEN, 101)
        t.padding_side = "left"
    texts = [f"{tokenization.MEDIA_TOKEN}a photo of a cat{tokenization.EOC_TOKEN}", "a dog and a bird</s>", "x y z w v"]
    for text in texts:
        assert tok.encode(text) == jtok.encode(text)
    got, want = tok(texts, max_length=6, padding="max_length", truncation=True), jtok(texts, max_length=6,
                                                                                    padding="max_length",
                                                                                    truncation=True)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert tok.batch_decode(want["input_ids"], True) == jtok.batch_decode(want["input_ids"], True)
    assert len(tok) == len(jtok) == 102


def test_prepare_hf_tokenizer_equals_jax(tmp_path):
    got = tokenization.prepare_hf_tokenizer(_tiny_hf_tokenizer(tmp_path))
    want = jax_tokenization.prepare_hf_tokenizer(_tiny_hf_tokenizer(tmp_path))
    assert got[1:] == want[1:] and len(got[0]) == len(want[0])
    text = f"{tokenization.MEDIA_TOKEN}abc{tokenization.EOC_TOKEN}"
    assert got[0](text)["input_ids"] == want[0](text)["input_ids"]


# ---------------------------------------------------------------- images

IMAGE_SHAPES = [(30, 20), (20, 30), (10, 12), (14, 14), (9, 31), (40, 40)]     # down, up, square, not


@pytest.mark.parametrize("flip", [False, True])
def test_image_processor_bit_equal_jax(rng, flip):
    from PIL import Image

    proc = image_processing.ImageProcessor(image_size=14, random_flip=flip)
    jproc = jax_images.ImageProcessor(image_size=14, random_flip=flip)
    images = [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) for h, w in IMAGE_SHAPES]
    images.append(Image.fromarray(images[0]).convert("L"))
    for i, im in enumerate(images):
        got = proc(im, np.random.default_rng(i))
        np.testing.assert_array_equal(got, jproc(im, np.random.default_rng(i)))
        np.testing.assert_array_equal(proc.raw_uint8(im, np.random.default_rng(i)),
                                      jproc.raw_uint8(im, np.random.default_rng(i)))
    np.testing.assert_array_equal(proc.raw_uint8(images[:2], np.random.default_rng(9)),
                                  jproc.raw_uint8(images[:2], np.random.default_rng(9)))


@pytest.mark.parametrize("hw", IMAGE_SHAPES)
def test_preprocess_images_on_device_matches_jax(rng, hw):
    x = rng.integers(0, 256, size=(2, *hw, 3)).astype(np.uint8)
    want = np.asarray(jax_images.preprocess_images_on_device(jnp.asarray(x), image_size=14))
    got = image_processing.preprocess_images_on_device(torch.from_numpy(x), image_size=14)
    assert got.shape == want.shape == (2, 14, 14, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_ATOL, rtol=0)
    bf16 = image_processing.preprocess_images_on_device(torch.from_numpy(x), image_size=14, dtype=torch.bfloat16)
    torch.testing.assert_close(bf16, got.to(torch.bfloat16), atol=0, rtol=0)


def test_resize_weights_match_jax():
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    for m, n in ((30, 14), (10, 14), (50, 23), (7, 31)):
        want = np.asarray(compute_weight_mat(m, n, n / m, 0.0, _fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(image_processing.bicubic_weights(m, n).numpy(), want, atol=2e-7, rtol=0)


# ---------------------------------------------------------------- released checkpoint

@pytest.fixture(scope="module")
def tiny_pair():
    """JAX params of a tiny MPT Flamingo (random everywhere: the gates start
    at 0) and the port's model holding them."""
    jmodel = tiny_flamingo()
    rng = np.random.default_rng(0)
    x, ids = jnp.zeros((1, 1, 1, 14, 14, 3)), jnp.asarray([[5, 9, 10]], jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, ids, jnp.ones_like(ids))
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), params)
    cfg = jmodel.cfg
    tcfg = FlamingoConfig(vision=VisionConfig(**dataclasses.asdict(cfg.vision)),
                          lm=DecoderConfig(**dataclasses.asdict(cfg.lm)), **{
                              k: v for k, v in as_dict(cfg).items() if k not in ("vision", "lm")})
    model = Flamingo(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def trainable(model):
    return {k: v for k, v in model.state_dict().items() if is_trainable(k)}


def test_released_checkpoint_from_jax_export(tiny_pair):
    """JAX's export, as the reference's .pt holds it (and with the
    `module.` prefix and the pre-filter xattn naming), loads into the
    port's trainable set."""
    _, params, model = tiny_pair
    sd = {k: torch.tensor(v) for k, v in jax_ckpt.export_flamingo_checkpoint(params).items()}
    want = trainable(model)
    assert_same(convert_flamingo_checkpoint(sd), want)
    assert_same(convert_flamingo_checkpoint({"module." + k: v for k, v in sd.items()}), want)
    prefilter = {k.replace("transformer.blocks.", "gated_cross_attn_layers.").replace(".gated_cross_attn_layer.", "."): v
                 for k, v in sd.items()}
    assert any(k.startswith("lang_encoder.gated_cross_attn_layers.1.") for k in prefilter)
    assert_same(convert_flamingo_checkpoint(prefilter), want)


@pytest.mark.parametrize("family", ["mpt", "gptneox", "llama", "opt"])
def test_released_checkpoint_export_round_trip(tiny_pair, family):
    jmodel, params, model = tiny_pair
    sd = export_flamingo_checkpoint(model, family)
    want = {k: torch.tensor(v) for k, v in jax_ckpt.export_flamingo_checkpoint(params, family).items()}
    assert_same(sd, want)
    assert_same(convert_flamingo_checkpoint(sd), trainable(model))


def test_released_checkpoint_untied_head_and_refusals():
    sd = {"lang_encoder.embed_out.weight": torch.ones(8, 4), "lang_encoder.gpt_neox.embed_in.weight": torch.zeros(8, 4),
          "lang_encoder.gpt_neox.layers.0.attention.dense.weight": torch.zeros(4, 4)}
    assert sorted(convert_flamingo_checkpoint(sd)) == ["lm.lm_head.weight", "lm.wte.weight"]
    with pytest.raises(ValueError, match="unconditioned"):
        convert_flamingo_checkpoint({"perceiver.latents": torch.zeros(4, 8)})
    with pytest.raises(ValueError, match="no recognizable"):
        convert_flamingo_checkpoint({"vision_encoder.x": torch.zeros(1)})


# ---------------------------------------------------------------- serialization

def test_save_load_round_trip_and_jax_config(tmp_path, tiny_pair):
    jmodel, _, model = tiny_pair
    assert config_to_dict(model.cfg) == jax_serialization._cfg_to_dict(jmodel.cfg)
    save_pretrained(str(tmp_path / "m"), model)
    back = load_pretrained(str(tmp_path / "m"), device="cpu")
    assert back.cfg == model.cfg
    assert_same(back.state_dict(), model.state_dict())
    bf16 = load_pretrained(str(tmp_path / "m"), device="cpu", dtype=torch.bfloat16)
    assert_same(bf16.state_dict(), {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()})
    # a config.json the JAX package wrote, its scanned layout included
    scanned = jax_serialization._cfg_to_dict(dataclasses.replace(jmodel.cfg, scan_layers=True))
    (tmp_path / "m" / "config.json").write_text(json.dumps(scanned))
    assert load_pretrained(str(tmp_path / "m"), device="cpu").cfg == model.cfg
    assert jax_serialization._cfg_from_dict(json.loads(json.dumps(config_to_dict(model.cfg)))) == jmodel.cfg
