"""HF CausalLM checkpoint -> the port's `FlamingoLM` state_dict.

The port's own copy of the JAX package's `convert/hf_lm.py`, written to the
port's names directly: a torch Linear weight (out, in) is the port's Linear
weight as it is, so nothing is transposed. `config_from_hf` takes a
transformers config or the plain dict of its `config.json`; the converters
take an HF state_dict of tensors or arrays (or a module) and return fp32
tensors keyed as `FlamingoLM.state_dict()` is (`wte.weight`,
`blocks.0.Wqkv.weight`, ...), without the gated cross-attention. MPT,
GPT-NeoX, LLaMA and OPT; GPT-J waits for its decoder block (ROADMAP.md 7c).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from ..configs import DecoderConfig

_MISSING = object()


def _get(cfg, name: str, default=_MISSING):
    """A field of a transformers config or of its config.json dict."""
    val = cfg.get(name, default) if isinstance(cfg, Mapping) else getattr(cfg, name, default)
    if val is _MISSING:
        raise KeyError(f"HF config has no {name!r}")
    return val


def to_state_dict(model_or_sd) -> Dict[str, torch.Tensor]:
    """An nn.Module or a mapping of tensors / arrays as fp32 CPU tensors."""
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    out = {}
    for k, v in sd.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[k] = t.to(device="cpu", dtype=torch.float32).contiguous()
    return out


def config_from_hf(hf_config) -> DecoderConfig:
    """A DecoderConfig from an HF config (object or config.json dict)."""
    mt = _get(hf_config, "model_type")
    if mt == "mpt":
        attn = _get(hf_config, "attn_config", {}) or {}
        return DecoderConfig(
            family="mpt",
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "d_model"),
            num_layers=_get(hf_config, "n_layers"),
            num_heads=_get(hf_config, "n_heads"),
            intermediate_size=4 * _get(hf_config, "d_model"),
            max_position_embeddings=_get(hf_config, "max_seq_len"),
            layer_norm_eps=_get(hf_config, "layer_norm_epsilon", 1e-5),
            alibi=True,
            alibi_bias_max=_get(attn, "alibi_bias_max", 8),
            clip_qkv=_get(attn, "clip_qkv", None),
            attention_bias=False,
            tie_word_embeddings=True,
            ln_no_bias=True,
        )
    if mt == "gpt_neox":
        return DecoderConfig(
            family="gptneox",
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "hidden_size"),
            num_layers=_get(hf_config, "num_hidden_layers"),
            num_heads=_get(hf_config, "num_attention_heads"),
            intermediate_size=_get(hf_config, "intermediate_size"),
            max_position_embeddings=_get(hf_config, "max_position_embeddings"),
            layer_norm_eps=_get(hf_config, "layer_norm_eps"),
            rotary_pct=_get(hf_config, "rotary_pct"),
            rope_theta=_get(hf_config, "rotary_emb_base"),
            use_parallel_residual=_get(hf_config, "use_parallel_residual"),
            attention_bias=True,
            tie_word_embeddings=_get(hf_config, "tie_word_embeddings", False),
        )
    if mt == "llama":
        return DecoderConfig(
            family="llama",
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "hidden_size"),
            num_layers=_get(hf_config, "num_hidden_layers"),
            num_heads=_get(hf_config, "num_attention_heads"),
            num_kv_heads=_get(hf_config, "num_key_value_heads", None),
            intermediate_size=_get(hf_config, "intermediate_size"),
            max_position_embeddings=_get(hf_config, "max_position_embeddings"),
            layer_norm_eps=_get(hf_config, "rms_norm_eps"),
            rope_theta=_get(hf_config, "rope_theta", 10000.0),
            attention_bias=_get(hf_config, "attention_bias", False),
            tie_word_embeddings=_get(hf_config, "tie_word_embeddings", False),
            hidden_act="silu",
        )
    if mt == "opt":
        return DecoderConfig(
            family="opt",
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "hidden_size"),
            num_layers=_get(hf_config, "num_hidden_layers"),
            num_heads=_get(hf_config, "num_attention_heads"),
            intermediate_size=_get(hf_config, "ffn_dim"),
            max_position_embeddings=_get(hf_config, "max_position_embeddings"),
            attention_bias=True,
            tie_word_embeddings=True,
        )
    if mt == "gptj":
        raise NotImplementedError("decoder family 'gptj' is not ported yet (ROADMAP.md)")
    raise ValueError(f"unsupported HF model_type: {mt}")


def convert_lm_params(sd, cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    """An HF CausalLM state_dict (or module) as `FlamingoLM` weights (no
    xattn)."""
    sd = to_state_dict(sd)
    convert = {"mpt": _convert_mpt, "gptneox": _convert_gptneox, "llama": _convert_llama, "opt": _convert_opt}
    if cfg.family not in convert:
        raise NotImplementedError(f"decoder family {cfg.family!r} is not ported yet (ROADMAP.md)")
    return convert[cfg.family](sd, cfg)


def _put(out: dict, name: str, sd, prefix: str, bias: bool = True) -> None:
    """HF module `prefix`'s weight (and bias, where it has one and `bias`)
    as the port's module `name`'s: Linear and LayerNorm alike."""
    out[f"{name}.weight"] = sd[prefix + ".weight"]
    if bias and prefix + ".bias" in sd:
        out[f"{name}.bias"] = sd[prefix + ".bias"]


def _convert_mpt(sd, cfg) -> Dict[str, Any]:
    # HF MptForCausalLM ("transformer." prefix) or mosaicml's mosaic_gpt
    # names (ln_1 / ln_2, mlp.mlp_up / mlp.mlp_down)
    pre = "transformer." if "transformer.wte.weight" in sd else ""
    out = {"wte.weight": sd[pre + "wte.weight"]}
    for i in range(cfg.num_layers):
        b, o = f"{pre}blocks.{i}.", f"blocks.{i}"
        n1 = b + ("norm_1" if b + "norm_1.weight" in sd else "ln_1")
        n2 = b + ("norm_2" if b + "norm_2.weight" in sd else "ln_2")
        up = b + ("ffn.up_proj" if b + "ffn.up_proj.weight" in sd else "mlp.mlp_up")
        down = b + ("ffn.down_proj" if b + "ffn.down_proj.weight" in sd else "mlp.mlp_down")
        _put(out, f"{o}.norm_1", sd, n1, bias=not cfg.ln_no_bias)
        _put(out, f"{o}.Wqkv", sd, b + "attn.Wqkv", bias=False)
        _put(out, f"{o}.out_proj", sd, b + "attn.out_proj", bias=False)
        _put(out, f"{o}.norm_2", sd, n2, bias=not cfg.ln_no_bias)
        _put(out, f"{o}.up_proj", sd, up, bias=False)
        _put(out, f"{o}.down_proj", sd, down, bias=False)
    _put(out, "norm_f", sd, pre + ("norm_f" if pre + "norm_f.weight" in sd else "ln_f"), bias=not cfg.ln_no_bias)
    return out


def _convert_gptneox(sd, cfg) -> Dict[str, Any]:
    pre = "gpt_neox." if "gpt_neox.embed_in.weight" in sd else ""
    out = {"wte.weight": sd[pre + "embed_in.weight"]}
    for i in range(cfg.num_layers):
        b, o = f"{pre}layers.{i}.", f"blocks.{i}"
        _put(out, f"{o}.input_layernorm", sd, b + "input_layernorm")
        _put(out, f"{o}.query_key_value", sd, b + "attention.query_key_value")
        _put(out, f"{o}.dense", sd, b + "attention.dense")
        _put(out, f"{o}.post_attention_layernorm", sd, b + "post_attention_layernorm")
        _put(out, f"{o}.dense_h_to_4h", sd, b + "mlp.dense_h_to_4h")
        _put(out, f"{o}.dense_4h_to_h", sd, b + "mlp.dense_4h_to_h")
    _put(out, "norm_f", sd, pre + "final_layer_norm")
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["embed_out.weight"]
    return out


def _convert_opt(sd, cfg) -> Dict[str, Any]:
    pre = "model.decoder." if "model.decoder.embed_tokens.weight" in sd else (
        "decoder." if "decoder.embed_tokens.weight" in sd else "")
    out = {"wte.weight": sd[pre + "embed_tokens.weight"], "wpe.weight": sd[pre + "embed_positions.weight"]}
    for i in range(cfg.num_layers):
        b, o = f"{pre}layers.{i}.", f"blocks.{i}"
        _put(out, f"{o}.self_attn_layer_norm", sd, b + "self_attn_layer_norm")
        for lin in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put(out, f"{o}.{lin}", sd, b + "self_attn." + lin)
        _put(out, f"{o}.final_layer_norm", sd, b + "final_layer_norm")
        _put(out, f"{o}.fc1", sd, b + "fc1")
        _put(out, f"{o}.fc2", sd, b + "fc2")
    _put(out, "norm_f", sd, pre + "final_layer_norm")
    return out


def _convert_llama(sd, cfg) -> Dict[str, Any]:
    pre = "model." if "model.embed_tokens.weight" in sd else ""
    out = {"wte.weight": sd[pre + "embed_tokens.weight"]}
    for i in range(cfg.num_layers):
        b, o = f"{pre}layers.{i}.", f"blocks.{i}"
        out[f"{o}.input_layernorm.weight"] = sd[b + "input_layernorm.weight"]
        for lin in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put(out, f"{o}.{lin}", sd, b + "self_attn." + lin, cfg.attention_bias)
        out[f"{o}.post_attention_layernorm.weight"] = sd[b + "post_attention_layernorm.weight"]
        for lin in ("gate_proj", "up_proj", "down_proj"):
            _put(out, f"{o}.{lin}", sd, b + "mlp." + lin, bias=False)
    out["norm_f.weight"] = sd[pre + "norm.weight"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out
