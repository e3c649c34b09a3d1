"""The training step: dual-source (paired LAION + interleaved MMC4) loss,
one backward, the optimizer chain and the NaN skip (the JAX package's
`train/train_loop.py`).

`train_step(state, batch_laion, batch_mmc4)` runs both forwards, masks the
labels, takes total = 0.2 * laion + 1.0 * mmc4 and one backward through
the frozen LM into the trainable perceiver, gated xattn and embedding
table, then updates the trainable parameters in place. A non-finite total
loss leaves the parameters and the optimizer state untouched and still
advances the step counter (the JAX package's `lax.cond`); deciding it reads
the loss on the host once per step. On CUDA tensors the attention runs the
kernels K4/K4b and K5/K5b through their autograd Functions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..image_processing import normalize_images_on_device
from .losses import lm_loss, mask_labels_interleaved, mask_labels_paired
from .optimizer import FlamingoOptimizer, OptState, global_norm


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    loss_multiplier_laion: float = 0.2
    loss_multiplier_mmc4: float = 1.0
    pad_token_id: int = 0
    skip_nan_batches: bool = True


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]   # the model's trainable parameters, updated in place
    opt_state: OptState

    @staticmethod
    def create(trainable: Dict[str, torch.nn.Parameter], tx: FlamingoOptimizer) -> "TrainState":
        return TrainState(step=0, params=trainable, opt_state=tx.init(trainable))


def _vision_input(model, vision_x: torch.Tensor) -> torch.Tensor:
    """uint8 batches normalise on the device; float batches pass through."""
    if vision_x.dtype == torch.uint8:
        return normalize_images_on_device(vision_x, dtype=model.dtype)
    return vision_x


def batch_losses(model, batch_laion: Dict[str, torch.Tensor], batch_mmc4: Dict[str, torch.Tensor],
                 cfg: TrainLoopConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-source LM losses. Batches carry vision_x (B, T_img, F, H, W, C),
    input_ids (B, T) and attention_mask (B, T)."""
    media_id, eoc_id = model.cfg.media_token_id, model.cfg.eoc_token_id
    bl, bm = batch_laion, batch_mmc4
    logits_l = model(_vision_input(model, bl["vision_x"]), bl["input_ids"], bl["attention_mask"])[0]
    loss_l = lm_loss(logits_l, mask_labels_paired(bl["input_ids"], cfg.pad_token_id, media_id))
    logits_m = model(_vision_input(model, bm["vision_x"]), bm["input_ids"], bm["attention_mask"])[0]
    loss_m = lm_loss(logits_m, mask_labels_interleaved(bm["input_ids"], cfg.pad_token_id, media_id, eoc_id))
    return loss_l, loss_m


def make_train_step(model, tx: FlamingoOptimizer, cfg: TrainLoopConfig):
    """Returns train_step(state, batch_laion, batch_mmc4) -> (state, metrics).
    After a step each trainable parameter's `.grad` holds its raw gradient."""

    def train_step(state: TrainState, batch_laion, batch_mmc4):
        params = state.params
        for p in params.values():
            p.grad = None
        loss_l, loss_m = batch_losses(model, batch_laion, batch_mmc4, cfg)
        total = cfg.loss_multiplier_laion * loss_l + cfg.loss_multiplier_mmc4 * loss_m
        total.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
        opt_state = state.opt_state
        if not cfg.skip_nan_batches or torch.isfinite(total).item():
            opt_state = tx.update(grads, opt_state, params)
        metrics = {"loss": total.detach(), "loss_laion": loss_l.detach(), "loss_mmc4": loss_m.detach(),
                   "grad_norm": global_norm(grads.values())}
        return TrainState(step=state.step + 1, params=params, opt_state=opt_state), metrics

    return train_step
