"""Tokenizer wrapper: adds the Flamingo special tokens to any HF
tokenizer (open_flamingo/src/factory.py:50-63), plus a dependency-free
whitespace tokenizer for tests and offline smoke runs. The port's own copy
of the JAX package's `tokenization`, with the same ids; `return_tensors="pt"`
gives torch.long tensors for the port's entry points.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

EOC_TOKEN = "<|endofchunk|>"
MEDIA_TOKEN = "<image>"
PAD_TOKEN = "<PAD>"


def prepare_hf_tokenizer(tokenizer, padding_side: str = "right"):
    """Add <|endofchunk|>/<image> (and <PAD> if needed) to an HF tokenizer.
    Returns (tokenizer, media_token_id, eoc_token_id)."""
    tokenizer.add_special_tokens(
        {"additional_special_tokens": [EOC_TOKEN, MEDIA_TOKEN]}
    )
    if tokenizer.pad_token is None:
        tokenizer.add_special_tokens({"pad_token": PAD_TOKEN})
    tokenizer.padding_side = padding_side
    media_id = tokenizer.encode(MEDIA_TOKEN)[-1]
    eoc_id = tokenizer.encode(EOC_TOKEN)[-1]
    return tokenizer, media_id, eoc_id


class SimpleTokenizer:
    """Minimal whitespace tokenizer with the HF surface the framework
    touches (encode/decode/__call__ with padding+truncation, pad/eos ids,
    padding_side). For tests and offline demos only."""

    def __init__(self, vocab: Optional[Sequence[str]] = None, vocab_size: int = 512):
        self.id_to_token: List[str] = ["<PAD>", "<unk>", "<s>", "</s>"]
        self.token_to_id = {t: i for i, t in enumerate(self.id_to_token)}
        self.vocab_budget = vocab_size
        self.pinned: dict = {}       # token -> fixed id (may exceed budget)
        self.pinned_rev: dict = {}   # id -> token
        self.pad_token = "<PAD>"
        self.eos_token = "</s>"
        self.padding_side = "right"
        for t in vocab or []:
            self._add(t)
        for t in (EOC_TOKEN, MEDIA_TOKEN):
            self._add(t)

    def _add(self, tok: str) -> int:
        if tok in self.pinned:
            return self.pinned[tok]
        if tok not in self.token_to_id:
            if len(self.id_to_token) >= self.vocab_budget:
                return self.token_to_id["<unk>"]  # vocab full: never emit
                # ids the model's embedding table doesn't have
            self.token_to_id[tok] = len(self.id_to_token)
            self.id_to_token.append(tok)
        return self.token_to_id[tok]

    def pin(self, tok: str, idx: int) -> int:
        """Force `tok` to a fixed id (the factory appends the Flamingo
        special tokens after the base LM vocab, factory.py:90). Pinned ids
        live outside the organic vocab and may exceed vocab_size."""
        old = self.token_to_id.pop(tok, None)
        if old is not None:
            self.id_to_token[old] = f"<unused{old}>"
            self.token_to_id[self.id_to_token[old]] = old
        self.pinned[tok] = idx
        self.pinned_rev[idx] = tok
        return idx

    # --- HF-ish surface ---------------------------------------------------
    def __len__(self):
        top = max(self.pinned_rev, default=-1) + 1
        return max(len(self.id_to_token), self.vocab_budget, top)

    @property
    def pad_token_id(self):
        return self.token_to_id[self.pad_token]

    @property
    def eos_token_id(self):
        return self.token_to_id[self.eos_token]

    def add_special_tokens(self, mapping):
        for tok in mapping.get("additional_special_tokens", []):
            self._add(tok)
        if "pad_token" in mapping:
            self.pad_token = mapping["pad_token"]
            self._add(self.pad_token)
        return 0

    def tokenize(self, text: str) -> List[str]:
        # split out special tokens first
        out, rest = [], text
        specials = [EOC_TOKEN, MEDIA_TOKEN, self.eos_token]
        parts = [rest]
        for sp in specials:
            nxt = []
            for p in parts:
                if sp not in p:
                    nxt.append(p)
                    continue
                for i, seg in enumerate(p.split(sp)):
                    if i:
                        nxt.append(sp)
                    if seg:
                        nxt.append(seg)
            parts = nxt
        for p in parts:
            if p in self.token_to_id:
                out.append(p)
            else:
                out.extend(p.split())
        return out

    def encode(self, text: str) -> List[int]:
        return [self._add(t) for t in self.tokenize(text)]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i in self.pinned_rev:
                t = self.pinned_rev[i]
            elif i >= len(self.id_to_token):
                continue
            else:
                t = self.id_to_token[i]
            if skip_special_tokens and (
                t in (self.pad_token, self.eos_token, EOC_TOKEN, MEDIA_TOKEN)
                or t.startswith("<")
            ):
                continue
            toks.append(t)
        return " ".join(toks)

    def batch_decode(self, batch, skip_special_tokens: bool = False):
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(
        self,
        texts,
        max_length: Optional[int] = None,
        padding: str = "longest",
        truncation: bool = False,
        return_tensors: str = "np",
    ):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t) for t in texts]
        if truncation and max_length:
            seqs = [s[:max_length] for s in seqs]
        if padding == "max_length" and max_length:
            width = max_length
        else:
            width = max((len(s) for s in seqs), default=0)
        ids = np.full((len(seqs), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            if self.padding_side == "right":
                ids[i, : len(s)] = s
                mask[i, : len(s)] = 1
            else:
                ids[i, width - len(s):] = s
                mask[i, width - len(s):] = 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids).long(), "attention_mask": torch.from_numpy(mask).long()}
        return {"input_ids": ids, "attention_mask": mask}
