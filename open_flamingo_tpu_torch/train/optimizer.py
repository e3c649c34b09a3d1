"""Optimizer, schedules and the trainable/frozen partition, the JAX
package's `train/optimizer.py` over the port's parameter names.

The update is the JAX package's optax chain, in its order and with its
semantics (not `torch.optim.AdamW`'s):
  1. embedding-row gradient mask: only the <image> and <|endofchunk|> rows
     of `lm.wte.weight` keep their gradient (the JAX package's
     `mask_embedding_rows`; with frozen embeddings the table is not among
     the trainable tensors, so there is nothing to mask);
  2. clip to global norm `grad_clip`, on the masked gradient;
  3. Adam with bias correction, eps outside the square root, moments in
     the parameter dtype;
  4. + weight_decay * p, on the gated-xattn parameters only;
  5. * -lr, lr read from the schedule at the update count before it is
     incremented (so with warmup the first update's lr is 0).
Written with `torch._foreach_*` over the trainable tensors; parameters are
updated in place. The raw gradients (`p.grad`) are left as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

WTE = "lm.wte.weight"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.1
    warmup_steps: int = 5000
    total_steps: int = 500_000
    schedule: str = "constant"  # constant | linear | cosine
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def is_trainable(name: str, freeze_lm_embeddings: bool = False) -> bool:
    """Perceiver + gated xattn (+ the input embeddings unless frozen) train;
    the ViT and the base LM stay frozen."""
    if name.startswith(("perceiver.", "lm.xattn.")):
        return True
    return not freeze_lm_embeddings and name == WTE


def is_decayed(name: str) -> bool:
    """Weight decay applies to the gated-xattn parameters only."""
    return name.startswith("lm.xattn.")


def split_params(model: nn.Module, freeze_lm_embeddings: bool = False
                 ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name; sets each one's
    requires_grad to match."""
    train, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = is_trainable(name, freeze_lm_embeddings)
        p.requires_grad_(keep)
        (train if keep else frozen)[name] = p
    return train, frozen


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant `init` when steps <= 0."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate at an update count: linear warmup from 0 over
    warmup_steps, then constant / linear to 0 / cosine to 0 over the rest
    (optax.join_schedules switching at warmup_steps)."""
    rest = cfg.total_steps - cfg.warmup_steps
    if cfg.schedule == "constant":
        sched = lambda count: cfg.learning_rate
    elif cfg.schedule == "linear":
        sched = _linear(cfg.learning_rate, 0.0, rest)
    elif cfg.schedule == "cosine":
        if rest <= 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got {rest} decay steps")
        sched = lambda count: cfg.learning_rate * 0.5 * (1 + math.cos(math.pi * min(count, rest) / rest))
    else:
        raise ValueError(cfg.schedule)
    warmup = _linear(0.0, cfg.learning_rate, cfg.warmup_steps)
    return lambda count: warmup(count) if count < cfg.warmup_steps else sched(count - cfg.warmup_steps)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, on the device."""
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class OptState:
    count: int                      # updates applied: Adam's and the schedule's count
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FlamingoOptimizer:
    """The optax chain of `make_optimizer` as init / update over a dict of
    named trainable parameters."""

    def __init__(self, cfg: OptimizerConfig, media_token_id: Optional[int] = None,
                 eoc_token_id: Optional[int] = None):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.rows = None if media_token_id is None else (media_token_id, eoc_token_id)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return OptState(count=0, mu=zeros(), nu=zeros())

    def _row_mask(self, g: torch.Tensor) -> torch.Tensor:
        rows = torch.zeros(g.shape[0], 1, dtype=g.dtype, device=g.device)
        for r in self.rows:
            rows[r] = 1.0
        return g * rows

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState, params: Dict[str, torch.Tensor]) -> OptState:
        """Apply one update to `params` in place; returns the new state (the
        moments are updated in place too)."""
        cfg = self.cfg
        names = list(params)
        g = [self._row_mask(grads[n]) if self.rows and n == WTE else grads[n] for n in names]
        norm = global_norm(g)
        # optax.clip_by_global_norm: g unchanged below the limit, else g / norm * limit
        clip = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
        g = [t * clip.to(t.dtype) for t in g]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - cfg.b2)
        count = state.count + 1
        den = torch._foreach_div(nu, 1.0 - cfg.b2**count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(mu, 1.0 - cfg.b1**count)
        torch._foreach_div_(upd, den)
        decayed = [i for i, n in enumerate(names) if is_decayed(n)]
        if cfg.weight_decay and decayed:
            torch._foreach_add_([upd[i] for i in decayed], [params[names[i]] for i in decayed],
                                alpha=cfg.weight_decay)
        torch._foreach_add_([params[n] for n in names], upd, alpha=-self.schedule(state.count))
        return OptState(count=count, mu=state.mu, nu=state.nu)


def make_optimizer(cfg: OptimizerConfig, *, media_token_id: Optional[int] = None,
                   eoc_token_id: Optional[int] = None) -> FlamingoOptimizer:
    """AdamW over the trainable parameters (a dict keyed by name); the
    embedding rows are masked when the special token ids are given."""
    return FlamingoOptimizer(cfg, media_token_id, eoc_token_id)
