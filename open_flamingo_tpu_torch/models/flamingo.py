"""Top-level Flamingo model: frozen ViT + frozen LM bridged by the
PerceiverResampler and gated cross-attention.

Vision latents and media locations are explicit values, decode state is
an explicit KVCache. On CUDA tensors prefill and training attention run the
hand-written kernels (`ops/attention.py`; K4/K5 and, under autograd, their
backward K4b/K5b) and each single-token decode step the fused route K1-K3
(`ops/dense_stream.py`, `ops/decode_layer.py`); `ops.attention.plain_path()`
runs their plain versions on the same device, the reference the kernels are
held against.

Training: the perceiver, every gated xattn block and the token embedding
require grad (`train.optimizer.is_trainable`), the ViT and the LM blocks do
not; with `freeze_vision` the ViT runs under no_grad. `forward` is
differentiable; `decode_step` and `flamingo_generate` run under no_grad.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..configs import FlamingoConfig
from ..device import resolve_device
from ..train.optimizer import is_trainable
from .decoders.common import KVCache
from .lm import FlamingoLM
from .perceiver import PerceiverResampler
from .vit import VisionTransformer
from .xattn import media_time_from_locations


class Flamingo(nn.Module):
    def __init__(self, cfg: FlamingoConfig, device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.vision_encoder = VisionTransformer(cfg.vision, **kw)
        self.perceiver = PerceiverResampler(
            cfg.vision.hidden_size, cfg.perceiver_depth, cfg.perceiver_dim_head,
            cfg.perceiver_heads, cfg.num_vis_latents, **kw,
        )
        self.lm = FlamingoLM(
            cfg.lm, cfg.vision.hidden_size, cfg.cross_attn_every_n,
            cfg.only_attend_immediate_media, gradient_checkpointing=cfg.gradient_checkpointing, **kw,
        )
        for name, p in self.named_parameters():
            p.requires_grad_(is_trainable(name))

    @property
    def device(self) -> torch.device:
        return self.lm.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm.wte.weight.dtype

    def embed_vision(self, vision_x: torch.Tensor) -> torch.Tensor:
        """(B, T_img, F, H, W, C) NHWC pixels -> (B, T_img, n_latents, D):
        the ViT over every frame (without gradient when freeze_vision), then
        the perceiver."""
        b, t, f, h, w, c = vision_x.shape
        with torch.no_grad() if self.cfg.freeze_vision else contextlib.nullcontext():
            x = self.vision_encoder(vision_x.reshape(b * t * f, h, w, c))
        v, d = x.shape[-2:]
        return self.resample_vision(x.reshape(b, t, f, v, d))

    def resample_vision(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T_img, F, v, D) ViT patch tokens -> perceiver latents."""
        return self.perceiver(x)

    def forward(
        self,
        vision_x: Optional[torch.Tensor],
        lang_x: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        *,
        media_latents: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
    ):
        """Full forward / prefill. Returns (logits, media_latents, cache).
        Pass `media_latents` to skip the vision encode."""
        if media_latents is None:
            media_latents = self.embed_vision(vision_x)
        text_time = media_time_from_locations(lang_x == self.cfg.media_token_id)
        logits, cache = self.lm(
            lang_x, attention_mask, media=media_latents, text_time=text_time,
            cache=cache,
        )
        return logits, media_latents, cache

    @torch.no_grad()
    def decode_step(self, media_latents, lang_x, attention_mask, cache: KVCache, num_media, side=None):
        """Incremental decode: every current token attends to the last
        cached media. num_media: (B,) count of media tokens in the prefix.
        `side`: an `absorb_vit.SideHook` whose ViT layers this step carries
        (the JAX package's `decode_step_absorb`); its `result()` is then the
        next batch's workspace."""
        text_time = num_media[:, None].expand(lang_x.shape[0], lang_x.shape[1])
        return self.lm(
            lang_x, attention_mask, media=media_latents, text_time=text_time,
            cache=cache, side=side,
        )


def count_media(lang_x: torch.Tensor, media_token_id: int) -> torch.Tensor:
    return (lang_x == media_token_id).long().sum(-1)


@torch.no_grad()
def init_random(cfg: FlamingoConfig, seed: int, device="cuda", dtype=torch.float32) -> Flamingo:
    """A Flamingo with random weights drawn from a `torch.Generator` on
    `device`. Weights are drawn in fp32 and cast, so one seed gives the
    same weights in every dtype. Linear weights ~ N(0, 1/fan_in), the token
    embedding ~ N(0, 1/D), CLIP's class/position embeddings ~ N(0, 0.02²),
    perceiver latents ~ N(0, 1), norms at 1/0. The xattn gates are 0.5, not
    the reference's 0: with tanh(0) = 0 the cross-attention would never
    reach the logits."""
    dev = resolve_device(device)
    model = Flamingo(cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * std

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_gate", "ff_gate"):
            val = torch.full(p.shape, 0.5)
        elif name.endswith("wte.weight"):
            val = normal(p.shape, p.shape[1] ** -0.5)
        elif leaf in ("class_embedding", "position_embedding"):
            val = normal(p.shape, 0.02)
        elif leaf == "latents":
            val = normal(p.shape, 1.0)
        elif p.ndim == 2:
            val = normal(p.shape, p.shape[1] ** -0.5)
        elif leaf == "weight":  # LayerNorm scale
            val = torch.ones(p.shape)
        else:  # biases
            val = torch.zeros(p.shape)
        p.copy_(val)
    return model
