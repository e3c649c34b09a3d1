"""Released OpenFlamingo checkpoint (.pt, trainable set only) <-> the port's
state_dict; the port's own copy of the JAX package's
`convert/flamingo_ckpt.py`.

The released checkpoint.pt files hold the trainable set only (the
reference's filter_state_dict_to_trainable): perceiver.*, the gated xattn
blocks and the input embedding (and an untied output head). The filter
deletes the `lang_encoder.gated_cross_attn_layers.*` aliases, so the xattn
weights sit under the FlamingoLayer naming:

  perceiver.latents
  perceiver.layers.{i}.0.{norm_media,norm_latents,to_q,to_kv,to_out}.*
  perceiver.layers.{i}.1.{0,1,3}.*           # FeedForward Sequential
  perceiver.norm.*
  lang_encoder.<decoder attr>.{i}.gated_cross_attn_layer.{attn_gate,ff_gate}
  lang_encoder.<decoder attr>.{i}.gated_cross_attn_layer.attn.{norm,to_q,to_kv,to_out}.*
  lang_encoder.<decoder attr>.{i}.gated_cross_attn_layer.ff.{0,1,3}.*
  lang_encoder.<family embedding path>.weight  # wte / embed_in / embed_tokens
  lang_encoder.embed_out.weight / lm_head.weight  # untied output head

The pre-filter naming (`lang_encoder.gated_cross_attn_layers.{i}.*`) and
a `module.` prefix are read too. The exporter writes the released format
for a family, which the reference loads with load_state_dict(strict=False).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from .hf_lm import to_state_dict

# released name inside perceiver.layers.{i} -> the port's
_PERCEIVER_LAYER = {
    **{f"0.{n}.{p}": f"attn.{n}.{p}" for n in ("norm_media", "norm_latents") for p in ("weight", "bias")},
    **{f"0.{n}.weight": f"attn.{n}.weight" for n in ("to_q", "to_kv", "to_out")},
    "1.0.weight": "ff.norm.weight", "1.0.bias": "ff.norm.bias",
    "1.1.weight": "ff.fc1.weight", "1.3.weight": "ff.fc2.weight",
}
# released name inside a gated_cross_attn_layer -> the port's inside lm.xattn.{i}
_XATTN_LAYER = {
    "attn_gate": "attn_gate", "ff_gate": "ff_gate",
    "attn.norm.weight": "attn.norm.weight", "attn.norm.bias": "attn.norm.bias",
    **{f"attn.{n}.weight": f"attn.{n}.weight" for n in ("to_q", "to_kv", "to_out")},
    "ff.0.weight": "ff.norm.weight", "ff.0.bias": "ff.norm.bias",
    "ff.1.weight": "ff.fc1.weight", "ff.3.weight": "ff.fc2.weight",
}
_PERCEIVER_TOP = ("perceiver.latents", "perceiver.norm.weight", "perceiver.norm.bias")
# both namings of a gated xattn block; {i} is the decoder-layer index in both
_XATTN_KEY = re.compile(r"lang_encoder\.(?:gated_cross_attn_layers\.(\d+)|[\w.]+\.(\d+)\.gated_cross_attn_layer)\.(.+)")

# decoder-layer attr, embedding and untied head keys per family (the
# reference's __KNOWN_DECODER_LAYERS_ATTR_NAMES and each family's HF names)
_FAMILY_PATHS = {
    "mpt": ("transformer.blocks", "transformer.wte.weight", None),
    "gptneox": ("gpt_neox.layers", "gpt_neox.embed_in.weight", "embed_out.weight"),
    "llama": ("model.layers", "model.embed_tokens.weight", "lm_head.weight"),
    "gptj": ("transformer.h", "transformer.wte.weight", "lm_head.weight"),
    "opt": ("model.decoder.layers", "model.decoder.embed_tokens.weight", "lm_head.weight"),
}


def convert_flamingo_checkpoint(sd) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict as the port's partial state_dict
    (fp32, `Flamingo.state_dict()` names) to load over a model's weights.
    Keys outside the trainable set are skipped."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in to_state_dict(sd).items()}
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        m = re.fullmatch(r"perceiver\.layers\.(\d+)\.(.+)", key)
        x = _XATTN_KEY.fullmatch(key)
        if key in _PERCEIVER_TOP:
            out[key] = v
        elif m and m.group(2) in _PERCEIVER_LAYER:
            out[f"perceiver.layers.{m.group(1)}.{_PERCEIVER_LAYER[m.group(2)]}"] = v
        elif x and x.group(3) in _XATTN_LAYER:
            out[f"lm.xattn.{x.group(1) or x.group(2)}.{_XATTN_LAYER[x.group(3)]}"] = v
        elif not key.startswith("lang_encoder.") or "gated_cross_attn" in key:
            continue
        elif key.endswith(("wte.weight", "embed_in.weight", "embed_tokens.weight")):
            out["lm.wte.weight"] = v
        elif key.endswith(("embed_out.weight", "lm_head.weight")):
            # the untied head, kept by the reference's filter: the rows of
            # <image> / <|endofchunk|> matter
            out["lm.lm_head.weight"] = v
    if not out:
        raise ValueError(f"checkpoint contained no recognizable OpenFlamingo keys (got e.g. {sorted(sd)[:5]})")
    if any(k.startswith("perceiver.") for k in out) and not any(k.startswith("lm.xattn.") for k in out):
        raise ValueError(
            "checkpoint has perceiver weights but no gated cross-attention weights were recognized: the model "
            f"would run as an unconditioned base LM. Keys seen: {sorted(sd)[:10]} ..."
        )
    return out


def export_flamingo_checkpoint(model_or_sd, family: str = "mpt") -> Dict[str, torch.Tensor]:
    """The trainable set of a port model (or its state_dict) in the released
    checkpoint's naming for `family`, as fp32 CPU tensors: xattn under
    `lang_encoder.<decoder attr>.{i}.gated_cross_attn_layer.*`, the
    embedding (and an untied head) under the family's HF key."""
    layers_attr, embed_key, head_key = _FAMILY_PATHS[family]
    perceiver = {v: k for k, v in _PERCEIVER_LAYER.items()}
    xattn = {v: k for k, v in _XATTN_LAYER.items()}
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    names: Dict[str, str] = {}
    for key in sd:
        m = re.fullmatch(r"perceiver\.layers\.(\d+)\.(.+)", key)
        x = re.fullmatch(r"lm\.xattn\.(\d+)\.(.+)", key)
        if key in _PERCEIVER_TOP:
            names[key] = key
        elif m and m.group(2) in perceiver:
            names[f"perceiver.layers.{m.group(1)}.{perceiver[m.group(2)]}"] = key
        elif x and x.group(2) in xattn:
            names[f"lang_encoder.{layers_attr}.{x.group(1)}.gated_cross_attn_layer.{xattn[x.group(2)]}"] = key
        elif key == "lm.wte.weight":
            names[f"lang_encoder.{embed_key}"] = key
        elif key == "lm.lm_head.weight" and head_key is not None:
            names[f"lang_encoder.{head_key}"] = key
    # only the trainable set comes to the host
    return to_state_dict({released: sd[key] for released, key in names.items()})
