"""Next-token loss and the reference's label-masking rules, vectorised (the
JAX package's `train/losses.py`).

  paired (LAION):     pad -> IGNORE, <image> -> IGNORE
  interleaved (MMC4): pad -> IGNORE, everything before the first <image>,
                      every span from just after an <|endofchunk|> until
                      (exclusive) the next <image>, and <image> -> IGNORE.
The interleaved rule is O(T) with cumulative-max indices (`torch.cummax`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE = -100


def mask_labels_paired(input_ids: torch.Tensor, pad_id: int, media_id: int) -> torch.Tensor:
    drop = (input_ids == pad_id) | (input_ids == media_id)
    return input_ids.masked_fill(drop, IGNORE)


def mask_labels_interleaved(input_ids: torch.Tensor, pad_id: int, media_id: int, eoc_id: int) -> torch.Tensor:
    ids = input_ids
    is_media = ids == media_id
    is_eoc = ids == eoc_id
    before_first = torch.cumsum(is_media.long(), dim=-1) == 0
    # last index (strictly before each position) of an eoc / a media token; -1 if none
    idx = torch.arange(ids.shape[-1], device=ids.device).expand(ids.shape)
    none = torch.full_like(idx, -1)
    last_eoc = torch.cummax(torch.where(is_eoc, idx, none), dim=-1).values
    last_media = torch.cummax(torch.where(is_media, idx, none), dim=-1).values

    def shift(x):
        return torch.cat([torch.full_like(x[..., :1], -1), x[..., :-1]], dim=-1)

    # inside an eoc -> media gap iff the latest eoc is more recent than the latest media
    in_gap = shift(last_eoc) > shift(last_media)
    drop = (ids == pad_id) | is_media | before_first | (in_gap & ~is_media)
    return ids.masked_fill(drop, IGNORE)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross entropy (B, T, V) logits against (B, T) labels, mean
    over the targets that are not IGNORE (0 when there are none)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                          ignore_index=IGNORE, reduction="sum")
    return nll / (targets != IGNORE).sum().clamp(min=1)
