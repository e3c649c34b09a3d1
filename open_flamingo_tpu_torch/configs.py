"""Architecture configs of the released models: OF-3B (MPT-1B, xattn
before every layer), OF-4B (RedPajama-INCITE-3B, every 2), OF-9B
(MPT-7B, every 4); and the factory's other vision towers (ViT-B/32,
ViT-Tiny).

The port's own copies of the JAX package's `VisionConfig`,
`DecoderConfig` and `FlamingoConfig`, with the same fields and defaults
where the port uses them. The MPT (OF-3B, OF-9B) and GPT-NeoX (OF-4B)
families run in this package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # OpenAI CLIP
    # True: ln_post over all tokens before dropping CLS (open_clip
    # output_tokens semantics, what Flamingo consumes).
    post_ln_tokens: bool = True
    projection_dim: Optional[int] = None

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    family: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    num_kv_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rotary_pct: float = 1.0
    rotary_dim: Optional[int] = None
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    alibi: bool = False
    alibi_bias_max: float = 8.0
    clip_qkv: Optional[float] = None
    attention_bias: bool = True
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    hidden_act: str = "gelu"
    ln_no_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


@dataclasses.dataclass(frozen=True)
class FlamingoConfig:
    vision: VisionConfig
    lm: DecoderConfig
    media_token_id: int
    eoc_token_id: int  # <|endofchunk|>
    cross_attn_every_n: int = 1
    num_vis_latents: int = 64
    perceiver_depth: int = 6
    perceiver_heads: int = 8
    perceiver_dim_head: int = 64
    only_attend_immediate_media: bool = True
    # training: the ViT runs without gradient; each decoder and xattn block
    # recomputes its forward in the backward (torch.utils.checkpoint)
    freeze_vision: bool = True
    gradient_checkpointing: bool = False


VIT_L_14 = VisionConfig(
    image_size=224, patch_size=14, hidden_size=1024, num_layers=24,
    num_heads=16, intermediate_size=4096, hidden_act="quick_gelu",
    projection_dim=768,
)

# Tiny smoke-run tower (not a real CLIP): the same 224px input, 2 layers of
# D 128 (the factory's "ViT-Tiny")
VIT_TINY = VisionConfig(
    image_size=224, patch_size=32, hidden_size=128, num_layers=2,
    num_heads=2, intermediate_size=256, hidden_act="quick_gelu",
    projection_dim=64,
)

# OpenAI CLIP ViT-B/32, the reference's RICES retrieval encoder
VIT_B_32 = VisionConfig(
    image_size=224, patch_size=32, hidden_size=768, num_layers=12,
    num_heads=12, intermediate_size=3072, hidden_act="quick_gelu",
    projection_dim=512,
)

# mosaicml/mpt-1b-redpajama-200b (d_model 2048, 24 layers, 16 heads)
MPT_1B = DecoderConfig(
    family="mpt", vocab_size=50432, hidden_size=2048, num_layers=24,
    num_heads=16, intermediate_size=8192, max_position_embeddings=2048,
    alibi=True, attention_bias=False, ln_no_bias=True, tie_word_embeddings=True,
)

# togethercomputer/RedPajama-INCITE-Base-3B-v1 (GPT-NeoX arch)
REDPAJAMA_3B = DecoderConfig(
    family="gptneox", vocab_size=50432, hidden_size=2560, num_layers=32,
    num_heads=32, intermediate_size=10240, max_position_embeddings=2048,
    rotary_pct=1.0, use_parallel_residual=False, attention_bias=True,
    tie_word_embeddings=False,
)

# mosaicml/mpt-7b (d_model 4096, 32 layers, 32 heads)
MPT_7B = DecoderConfig(
    family="mpt", vocab_size=50432, hidden_size=4096, num_layers=32,
    num_heads=32, intermediate_size=16384, max_position_embeddings=2048,
    alibi=True, attention_bias=False, ln_no_bias=True, tie_word_embeddings=True,
)


def flamingo_config(
    name: str, media_token_id: int = 50433, eoc_token_id: int = 50432
) -> FlamingoConfig:
    """name in {OF-3B, OF-4B, OF-9B}. The vocabulary grows to hold the
    added special tokens (<|endofchunk|>, <image>)."""
    if name == "OF-3B":
        lm, n = MPT_1B, 1
    elif name == "OF-4B":
        lm, n = REDPAJAMA_3B, 2
    elif name == "OF-9B":
        lm, n = MPT_7B, 4
    else:
        raise ValueError(name)
    vocab = max(lm.vocab_size, max(media_token_id, eoc_token_id) + 1)
    return FlamingoConfig(
        vision=VIT_L_14,
        lm=dataclasses.replace(lm, vocab_size=vocab),
        media_token_id=media_token_id,
        eoc_token_id=eoc_token_id,
        cross_attn_every_n=n,
    )
