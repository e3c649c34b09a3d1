"""CLIP Vision Transformer, the frozen vision tower.

NHWC pixels at the public function, as in the JAX package. The patch
embedding is a reshape to (p, p, C) features followed by one Linear, not a
convolution, so the weights keep the JAX feature order and no cuDNN
convolution (TF32 by default on the card) is involved.

Every block's `layer_norm1`/`layer_norm2` and its attention core take the
hand-written kernels K10 (`ops.layer_norm`) and K9 (`ops.vit_attention`)
where the JAX block calls its Pallas kernels: on CUDA tensors by default,
on CPU tensors under their `FORCE` hooks (the plain versions run there).
`pre_layernorm` and `post_layernorm` stay plain, as in the JAX package.
The six linears of every block are `layers.Dense`: with the int8 side-car
(`quantize.quantize_prefill_weights`) and `ops.w8a8.ENABLED` they take the
W8A8 product, as the JAX block's `PDense` does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import VisionConfig
from ..ops.layer_norm import layer_norm, use_ln_kernel
from ..ops.vit_attention import use_vit_kernel, vit_attention_heads
from .layers import Dense, LayerNorm, attend, gelu_exact, merge_heads, quick_gelu, split_heads

_ACTS = {"quick_gelu": quick_gelu, "gelu": gelu_exact}


class ViTBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.q_proj = Dense(d, d, **kw)
        self.k_proj = Dense(d, d, **kw)
        self.v_proj = Dense(d, d, **kw)
        self.out_proj = Dense(d, d, **kw)
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.fc1 = Dense(d, cfg.intermediate_size, **kw)
        self.fc2 = Dense(cfg.intermediate_size, d, **kw)
        self.act = _ACTS[cfg.hidden_act]

    def forward(self, x):
        nh, dh = self.cfg.num_heads, self.cfg.head_dim
        ln_kernel = use_ln_kernel(x)
        h = self.norm(self.layer_norm1, x, ln_kernel)
        # (B, S, H, Dh) views of the projections: K9 reads them through strides
        q, k, v = (split_heads(proj(h), nh) for proj in (self.q_proj, self.k_proj, self.v_proj))
        if use_vit_kernel(x):
            out = vit_attention_heads(q, k, v, dh**-0.5)
        else:
            out = attend(q * (dh**-0.5), k, v)
        x = x + self.out_proj(merge_heads(out))
        h = self.fc2(self.act(self.fc1(self.norm(self.layer_norm2, x, ln_kernel))))
        return x + h

    @staticmethod
    def norm(ln: LayerNorm, x, kernel: bool):
        return layer_norm(x, ln.weight, ln.bias, ln.eps) if kernel else ln(x)


class VisionTransformer(nn.Module):
    """pixel_values (B, H, W, C) NHWC -> patch tokens (B, num_patches, D)."""

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(p * p * cfg.num_channels, d, bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.zeros(d, **kw))
        self.position_embedding = nn.Parameter(torch.zeros(cfg.num_patches + 1, d, **kw))
        self.pre_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.blocks = nn.ModuleList(ViTBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.post_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)

    def embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The front half: (B, H, W, C) pixels -> (B, num_patches + 1, D)
        tokens (CLS first) after the positions and the pre-LN."""
        cfg = self.cfg
        b, _, _, c = pixel_values.shape
        p, g = cfg.patch_size, cfg.grid
        x = pixel_values.to(self.patch_embed.weight.dtype)
        # patchify: (B, g, p, g, p, C) -> (B, g*g, p*p*C), features (ph, pw, c)
        x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)
        x = self.patch_embed(x)
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None]
        return self.pre_layernorm(x)

    def patch_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The back half: the blocks' (B, num_patches + 1, D) output -> the
        (B, num_patches, D) patch tokens, post-LN applied, CLS dropped."""
        if self.cfg.post_ln_tokens:
            x = self.post_layernorm(x)
        return x[:, 1:]  # Flamingo consumes the patch tokens only

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.embed(pixel_values)
        for block in self.blocks:
            x = block(x)
        return self.patch_tokens(x)
