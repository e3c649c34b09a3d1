"""CLIP vision checkpoint -> the port's `VisionTransformer` state_dict.

The port's own copy of the JAX package's `convert/hf_clip.py`, for HF
CLIPVisionModel naming and open_clip VisionTransformer naming (the
reference's vision tower), written to the port's names directly. The patch
conv (D, C, P, P) becomes the patch Dense (D, P*P*C) over (ph, pw, c)
features. The visual projection is not loaded: the port's ViT returns
patch tokens only.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs import VisionConfig
from .hf_lm import _get, _put, to_state_dict


def vision_config_from_hf(hf_config) -> VisionConfig:
    """A VisionConfig from an HF CLIPVisionConfig (object or dict)."""
    return VisionConfig(
        image_size=_get(hf_config, "image_size"),
        patch_size=_get(hf_config, "patch_size"),
        hidden_size=_get(hf_config, "hidden_size"),
        num_layers=_get(hf_config, "num_hidden_layers"),
        num_heads=_get(hf_config, "num_attention_heads"),
        intermediate_size=_get(hf_config, "intermediate_size"),
        layer_norm_eps=_get(hf_config, "layer_norm_eps"),
        hidden_act=_get(hf_config, "hidden_act"),
        projection_dim=_get(hf_config, "projection_dim", None),
    )


def _patch_weight(w: torch.Tensor) -> torch.Tensor:
    d, c, p, _ = w.shape
    return w.permute(0, 2, 3, 1).reshape(d, p * p * c).contiguous()


def convert_clip_vision_params(sd, cfg: VisionConfig) -> Dict[str, torch.Tensor]:
    """A CLIP vision state_dict (HF, or open_clip's whole-CLIP or visual
    tower) as `VisionTransformer` weights. post_layernorm comes along where
    the config applies it to the tokens or the checkpoint has a projection,
    as in the JAX package."""
    sd = to_state_dict(sd)
    if any(k.startswith("visual.") or k == "positional_embedding" for k in sd):
        if any(k.startswith("visual.") for k in sd):
            sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
        return _convert_open_clip(sd, cfg)
    return _convert_hf(sd, cfg)


def _convert_hf(sd, cfg) -> Dict[str, torch.Tensor]:
    pre = "vision_model." if "vision_model.embeddings.class_embedding" in sd else ""
    out = {
        "class_embedding": sd[pre + "embeddings.class_embedding"],
        "position_embedding": sd[pre + "embeddings.position_embedding.weight"],
        "patch_embed.weight": _patch_weight(sd[pre + "embeddings.patch_embedding.weight"]),
    }
    _put(out, "pre_layernorm", sd, pre + "pre_layrnorm")    # HF's spelling
    for i in range(cfg.num_layers):
        b, o = f"{pre}encoder.layers.{i}.", f"blocks.{i}"
        _put(out, f"{o}.layer_norm1", sd, b + "layer_norm1")
        for lin in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put(out, f"{o}.{lin}", sd, b + "self_attn." + lin)
        _put(out, f"{o}.layer_norm2", sd, b + "layer_norm2")
        _put(out, f"{o}.fc1", sd, b + "mlp.fc1")
        _put(out, f"{o}.fc2", sd, b + "mlp.fc2")
    if cfg.post_ln_tokens or "visual_projection.weight" in sd:
        _put(out, "post_layernorm", sd, pre + "post_layernorm")
    return out


def _convert_open_clip(sd, cfg) -> Dict[str, torch.Tensor]:
    out = {
        "class_embedding": sd["class_embedding"],
        "position_embedding": sd["positional_embedding"],
        "patch_embed.weight": _patch_weight(sd["conv1.weight"]),
    }
    _put(out, "pre_layernorm", sd, "ln_pre")
    for i in range(cfg.num_layers):
        b, o = f"transformer.resblocks.{i}.", f"blocks.{i}"
        _put(out, f"{o}.layer_norm1", sd, b + "ln_1")
        # (3D, D) fused q | k | v
        ws = sd[b + "attn.in_proj_weight"].chunk(3, dim=0)
        bs = sd[b + "attn.in_proj_bias"].chunk(3, dim=0)
        for lin, w, bias in zip(("q_proj", "k_proj", "v_proj"), ws, bs):
            out[f"{o}.{lin}.weight"], out[f"{o}.{lin}.bias"] = w.contiguous(), bias.contiguous()
        _put(out, f"{o}.out_proj", sd, b + "attn.out_proj")
        _put(out, f"{o}.layer_norm2", sd, b + "ln_2")
        _put(out, f"{o}.fc1", sd, b + "mlp.c_fc")
        _put(out, f"{o}.fc2", sd, b + "mlp.c_proj")
    if cfg.post_ln_tokens or "proj" in sd:
        _put(out, "post_layernorm", sd, "ln_post")
    return out
