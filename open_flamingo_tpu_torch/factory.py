"""Public factory: create_model_and_transforms, the port's copy of the JAX
package's `factory` (the reference's open_flamingo/src/factory.py).

Architecture configs come from the registries, or from a local HF
checkpoint directory; weights from `models.flamingo.init_random` with local
HF / open_clip checkpoints grafted over them. Nothing is downloaded.
`transformers` is imported only for a local HF directory (a model or a
tokenizer); the card machine has none, so there pass state_dicts or `.pt`
files (`lm_checkpoint`, `vision_checkpoint`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch

from . import configs as _configs
from .configs import DecoderConfig, FlamingoConfig, VisionConfig
from .device import resolve_device
from .image_processing import ImageProcessor
from .models.flamingo import Flamingo, init_random
from .tokenization import EOC_TOKEN, MEDIA_TOKEN, SimpleTokenizer, prepare_hf_tokenizer

_VISION_REGISTRY = {
    "ViT-L-14": _configs.VIT_L_14,
    "ViT-B-32": _configs.VIT_B_32,
    "ViT-Tiny": _configs.VIT_TINY,
}

_LM_REGISTRY = {
    "mosaicml/mpt-1b-redpajama-200b": _configs.MPT_1B,
    "mosaicml/mpt-1b-redpajama-200b-dolly": _configs.MPT_1B,
    "togethercomputer/RedPajama-INCITE-Base-3B-v1": _configs.REDPAJAMA_3B,
    "togethercomputer/RedPajama-INCITE-Instruct-3B-v1": _configs.REDPAJAMA_3B,
    "mosaicml/mpt-7b": _configs.MPT_7B,
}


def _resolve_lm_config(lang_encoder_path):
    """A DecoderConfig, a registry name or a local HF checkpoint directory
    -> (config, local directory or None)."""
    if isinstance(lang_encoder_path, DecoderConfig):
        return lang_encoder_path, None
    if lang_encoder_path in _LM_REGISTRY:
        return _LM_REGISTRY[lang_encoder_path], None
    if os.path.isdir(lang_encoder_path):
        import transformers

        from .convert.hf_lm import config_from_hf

        hf_cfg = transformers.AutoConfig.from_pretrained(lang_encoder_path, trust_remote_code=True,
                                                         local_files_only=True)
        return config_from_hf(hf_cfg), lang_encoder_path
    raise ValueError(
        f"unknown lang encoder {lang_encoder_path!r}; pass a registry name ({list(_LM_REGISTRY)}) or a local HF "
        "checkpoint directory"
    )


def create_model_and_transforms(
    clip_vision_encoder_path="ViT-L-14",
    clip_vision_encoder_pretrained: str = "openai",
    lang_encoder_path="mosaicml/mpt-1b-redpajama-200b",
    tokenizer_path: Optional[str] = None,
    cross_attn_every_n_layers: int = 1,
    use_local_files: bool = True,
    decoder_layers_attr_name: Optional[str] = None,
    freeze_lm_embeddings: bool = False,
    cache_dir: Optional[str] = None,
    gradient_checkpointing: bool = False,
    *,
    scan_layers: bool = False,
    init_params: bool = False,
    init_seed: int = 0,
    vision_checkpoint=None,
    lm_checkpoint=None,
    device="cuda",
    dtype=torch.float32,
):
    """Build the port's Flamingo. Returns (model, image_processor,
    tokenizer), the reference's triple: the model holds its weights.

    Weights: `init_random(cfg, init_seed)` on `device` in `dtype` when
    `init_params` or a checkpoint is given, with the checkpoints grafted
    over them: `lm_checkpoint` (a local HF directory, an HF state_dict or a
    `.pt` of one; a local HF `lang_encoder_path` is its default) and
    `vision_checkpoint` (HF CLIP or open_clip naming). Vocabulary rows the
    tokenizer added keep their random values. Without any, the model's
    parameters live on the meta device (shapes only, as the JAX package
    returns params=None). The tokenizer is the HF one at a local
    `tokenizer_path` with the Flamingo tokens added, else `SimpleTokenizer`
    with <|endofchunk|> and <image> pinned after the LM's vocabulary.
    `scan_layers` is accepted for the JAX package's signature: the port has
    one layer layout. `freeze_lm_embeddings` is the training setup's
    (`train.optimizer.split_params`); the path and naming arguments are the
    reference's and are not needed offline."""
    dev = resolve_device(device)
    if isinstance(clip_vision_encoder_path, VisionConfig):
        vision_cfg = clip_vision_encoder_path
    elif clip_vision_encoder_path in _VISION_REGISTRY:
        vision_cfg = _VISION_REGISTRY[clip_vision_encoder_path]
    else:
        raise ValueError(f"unknown vision encoder {clip_vision_encoder_path!r}")
    lm_cfg, lm_dir = _resolve_lm_config(lang_encoder_path)

    if tokenizer_path and os.path.isdir(tokenizer_path):
        import transformers

        tok = transformers.AutoTokenizer.from_pretrained(tokenizer_path, trust_remote_code=True,
                                                         local_files_only=True)
        tokenizer, media_id, eoc_id = prepare_hf_tokenizer(tok)
        vocab_size = max(lm_cfg.vocab_size, len(tokenizer))
    else:
        # the reference's layout: the ids appended after the LM's vocabulary,
        # the same ids in the tokenizer and the model
        tokenizer = SimpleTokenizer(vocab_size=lm_cfg.vocab_size)
        eoc_id = tokenizer.pin(EOC_TOKEN, lm_cfg.vocab_size)
        media_id = tokenizer.pin(MEDIA_TOKEN, lm_cfg.vocab_size + 1)
        vocab_size = lm_cfg.vocab_size + 2

    lm_cfg = dataclasses.replace(lm_cfg, vocab_size=vocab_size)
    cfg = FlamingoConfig(
        vision=vision_cfg, lm=lm_cfg, media_token_id=media_id, eoc_token_id=eoc_id,
        cross_attn_every_n=cross_attn_every_n_layers, gradient_checkpointing=gradient_checkpointing,
    )
    image_processor = ImageProcessor(image_size=vision_cfg.image_size)
    lm_checkpoint = lm_checkpoint if lm_checkpoint is not None else lm_dir
    if not (init_params or vision_checkpoint is not None or lm_checkpoint is not None):
        return Flamingo(cfg, device="meta", dtype=dtype), image_processor, tokenizer

    model = init_random(cfg, init_seed, device=dev, dtype=dtype)
    if lm_checkpoint is not None:
        from .convert.hf_lm import convert_lm_params

        _graft(model.lm, convert_lm_params(_load_state_dict(lm_checkpoint), lm_cfg), resize_vocab=True)
    if vision_checkpoint is not None:
        from .convert.hf_clip import convert_clip_vision_params

        _graft(model.vision_encoder, convert_clip_vision_params(_load_state_dict(vision_checkpoint), vision_cfg))
    return model, image_processor, tokenizer


def _load_state_dict(path_or_sd) -> Mapping:
    """A state_dict as it is; a local HF directory through transformers; a
    file through torch.load (tensors only)."""
    if not isinstance(path_or_sd, (str, os.PathLike)):
        return path_or_sd
    path = str(path_or_sd)
    if os.path.isdir(path):
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(path, trust_remote_code=True, local_files_only=True)
        return hf.state_dict()
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def _graft(module: torch.nn.Module, converted: Mapping[str, torch.Tensor], resize_vocab: bool = False) -> None:
    """Copy converted weights over `module`'s, cast to its dtype. With
    `resize_vocab`, a weight with fewer rows than the module's (the
    embedding and untied head before the added tokens) fills the first rows;
    the rest keep their random values (the reference's
    resize_token_embeddings)."""
    params = module.state_dict()
    unknown = sorted(set(converted) - set(params))
    if unknown:
        raise KeyError(f"converted weights the model does not have: {unknown[:5]}")
    for name, src in converted.items():
        dst = params[name]
        if src.shape != dst.shape:
            if not (resize_vocab and src.shape[1:] == dst.shape[1:] and src.shape[0] < dst.shape[0]):
                raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)}, model {tuple(dst.shape)}")
            dst = dst[:src.shape[0]]
        dst.copy_(src)
