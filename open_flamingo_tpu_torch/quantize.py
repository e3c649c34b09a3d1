"""Post-load int8 / int4 quantization of the decode-streamed LM weights and
of the ViT for W8A8 prefill, the JAX package's `quantize.py`
(`quantize_weight`, `QUANT_PARENTS`, `quantize_decode_params`,
`quantize_prefill_params`, `dequantize_roundtrip`).

Single-token decode on the card is bound by the weight bytes: per-out-
channel symmetric int8 halves them and int4 quarters them.
`quantize_decode_weights(model, bits)` attaches to every decode-streamed
linear of the LM (and to the vocab head) a quantized copy `weight_q` and its
per-out-channel fp32 scale `weight_s`, as non-persistent buffers: the bf16
weights and `state_dict()` stay as they are, prefill keeps using the bf16
weight, and the fused decode kernels (K1, K2, K3, K6) stream the quantized
copy (`stream_weight`). Quantization is opt-in, as in the JAX package.

int4 storage. The JAX package keeps int4-grid values as int8 and casts them
to `jnp.int4` inside its graph. The port packs them once, here: a
(N, K/2) `torch.uint8` tensor, element 2j in the low nibble and 2j + 1 in
the high nibble of byte j, each in two's complement. The dtype tells the
kernels which form they get: `int8` is int8, `uint8` is packed int4. The
vocab head stays int8 in int4 mode (JAX `quantize.py:79-92`).

W8A8 prefill (`ops.w8a8`, `models.layers.Dense`) multiplies int8 weights:
`quantize_prefill_weights(model, bits)` quantizes the LM as above and gives
the six linears of every ViT block (q/k/v, out_proj, fc1, fc2) an int8
`weight_q` and its scale, int8 in either mode (patch_embed, the perceiver
and the xattn `to_kv` stay unquantized, as in the JAX package). In int4
mode the W8A8 product reads the int4 grid's values as int8, as JAX's
`kernel_q4` gives them: `w8a8_weight` unpacks the packed stream at each use
(a transient (N, K) int8 tensor per linear), so no second copy of the LM's
stream is kept.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn

# the LM's nn.Linear names whose weight streams through the decode kernels
# (JAX QUANT_PARENTS, for the families the port has): MPT Wqkv/out_proj/
# up_proj/down_proj, GPT-NeoX query_key_value/dense/dense_h_to_4h/
# dense_4h_to_h, gated xattn to_q/to_out and FF fc1/fc2, the untied head.
# `to_kv` is not among them: the media K/V are projected once, at prefill.
QUANT_PARENTS = frozenset({
    "Wqkv", "out_proj", "up_proj", "down_proj",
    "query_key_value", "dense", "dense_h_to_4h", "dense_4h_to_h",
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
    "fc_in", "fc_out",
    "fc1", "fc2",
    "to_q", "to_out",
    "lm_head",
})


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric quantization of a (N, K) weight over K:
    scale = amax / qmax (1 where amax is 0), q = clip(round(w / scale)),
    qmax 127 (bits 8) or 7 (bits 4). Returns (q int8 (N, K), scale fp32
    (N,)); torch.round rounds half to even and both divisions are true
    ones, as in the JAX package, so the values agree bit for bit. (A CUDA
    tensor divided by a Python number is multiplied by its reciprocal
    instead, one ulp off at times: qmax is divided as a tensor.)"""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    w = w.float()
    amax = w.abs().amax(dim=1)
    qmax = 127 if bits == 8 else 7
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax / torch.full_like(amax, qmax))
    q = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax).to(torch.int8)
    return q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 values in [-8, 7] -> (N, K/2) uint8, element 2j in the
    low nibble of byte j, 2j + 1 in the high nibble, two's complement."""
    if q.dtype != torch.int8 or q.shape[-1] % 2:
        raise ValueError(f"pack_int4: needs int8 with an even last dim, got {q.dtype} {tuple(q.shape)}")
    u = q.to(torch.uint8) & 0xF
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """pack_int4's inverse: (N, K/2) uint8 -> (N, K) int8."""
    if p.dtype != torch.uint8:
        raise ValueError(f"unpack_int4: needs uint8, got {p.dtype}")
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    q = torch.stack((lo, hi), dim=-1).reshape(*p.shape[:-1], 2 * p.shape[-1])
    return torch.where(q > 7, q - 16, q)


def weight_values(w: torch.Tensor) -> torch.Tensor:
    """A stored weight as its values: int8 as it is, packed int4 unpacked,
    a float weight unchanged."""
    return unpack_int4(w) if w.dtype == torch.uint8 else w


def _quantizable(lm: nn.Module) -> Iterator[Tuple[str, nn.Module, bool]]:
    """(name, module, head) for every module of the LM that the JAX package
    quantizes: the QUANT_PARENTS linears and the `wte` embedding (its (V, D)
    table is the tied head)."""
    for name, mod in lm.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, nn.Linear) and leaf in QUANT_PARENTS:
            yield name, mod, leaf == "lm_head"
        elif isinstance(mod, nn.Embedding) and leaf == "wte":
            yield name, mod, True


def attach(module: nn.Module, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Attach a quantized copy (int8, or packed int4 as uint8) and its fp32
    scale to `module` as non-persistent buffers, on the module's device."""
    dev = module.weight.device
    module.register_buffer("weight_q", q.to(dev), persistent=False)
    module.register_buffer("weight_s", scale.to(device=dev, dtype=torch.float32), persistent=False)


@torch.no_grad()
def quantize_decode_weights(model: nn.Module, bits: int = 8) -> nn.Module:
    """The counterpart of JAX `quantize_decode_params`: attach int8 (bits 8)
    or packed int4 (bits 4, the head int8) copies of the LM's decode-
    streamed weights to `model` (a Flamingo or its FlamingoLM). Returns the
    model."""
    lm = getattr(model, "lm", model)
    for _, mod, head in _quantizable(lm):
        q, s = quantize_weight(mod.weight, 8 if head else bits)
        attach(mod, pack_int4(q) if (bits == 4 and not head) else q, s)
    return model


def attach_decode_weights(model: nn.Module, weights: dict) -> nn.Module:
    """Attach {module name: (weight_q, weight_s)}, names from `model` down
    (`convert.from_jax.decode_weights_from_jax`). Returns the model."""
    for name, (q, s) in weights.items():
        attach(model.get_submodule(name), q, s)
    return model


@torch.no_grad()
def quantize_prefill_weights(model: nn.Module, bits: int = 8) -> nn.Module:
    """The counterpart of JAX `quantize_prefill_params`: the LM as
    `quantize_decode_weights(model, bits)` does, then an int8 copy of each
    ViT block's q/k/v, out_proj, fc1 and fc2 for the W8A8 prefill path.
    Returns the model."""
    quantize_decode_weights(model, bits)
    vision = getattr(model, "vision_encoder", None)
    if vision is not None:
        for _, mod, _ in _quantizable(vision):
            attach(mod, *quantize_weight(mod.weight, 8))
    return model


def w8a8_weight(module: nn.Module) -> Optional[torch.Tensor]:
    """The int8 (N, K) weight of `module`'s W8A8 product, or None: an int8
    `weight_q`, or a packed int4 stream unpacked (JAX
    `PDense._w8a8_weight`: `kernel_q` when int8, else `kernel_q4`)."""
    q = getattr(module, "weight_q", None)
    return None if q is None else weight_values(q)


def drop_decode_weights(model: nn.Module) -> nn.Module:
    """Remove every attached quantized copy: decode streams the model's own
    weights again. Returns the model."""
    for mod in model.modules():
        for name in ("weight_q", "weight_s"):
            mod._buffers.pop(name, None)
    return model


def decode_weights(model: nn.Module) -> dict:
    """{module name: (weight_q, weight_s)} of the attached quantized copies,
    names from `model` down."""
    return {name: (mod.weight_q, mod.weight_s) for name, mod in model.named_modules()
            if getattr(mod, "weight_q", None) is not None}


def stream_weight(module: nn.Module) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(weight, scale) for the decode kernels: the quantized copy and its
    scale when one is attached, else (weight, None). JAX
    `PDense.stream_weight` / `scan_decode._w`."""
    q = getattr(module, "weight_q", None)
    return (module.weight, None) if q is None else (q, module.weight_s)


@torch.no_grad()
def dequantize_roundtrip(model: nn.Module, bits: int = 8) -> nn.Module:
    """Replace every quantizable weight by dequant(quant(w)) in its dtype,
    in place (JAX `dequantize_roundtrip`): quantized decode over these
    weights then computes what unquantized decode does, up to fp32 sums."""
    lm = getattr(model, "lm", model)
    for _, mod, head in _quantizable(lm):
        q, s = quantize_weight(mod.weight, 8 if head else bits)
        mod.weight.copy_((q.float() * s[:, None]).to(mod.weight.dtype))
    return model
