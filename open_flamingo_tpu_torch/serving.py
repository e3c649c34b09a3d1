"""Continuous-batching serving engine (iteration-level scheduling), the JAX
package's `serving.py`.

Static-batch generation retires a batch at the speed of its slowest
sequence; this engine keeps every cache row busy instead: when a sequence
finishes, a queued request is admitted into its row while the other rows
keep decoding. It runs the existing decode machinery unchanged, on two
properties of the cache (models/decoders/common.py `make_attn_inputs`):

  * positions are per row (a row's pad_mask sum), so a row admitted at any
    global write slot sees its own 0-based positions: RoPE and the causal
    structure are exact;
  * the attends mask by each row's pad_mask, so tenants never see each
    other's slots, and one write slot (`cache.index`, and `cache.slot` on
    the device, which K3 writes at) is shared by every row: each decode
    step advances it by one for all rows.

Admission is dynamic left-padding: a request's prompt is left-padded into a
(1 or B, max_prompt_len) window, prefilled into a cache of its own, and
its K/V copied right-aligned so its last prompt token sits at slot
`index - 1` (`common.admit_rows`); its row's pad_mask marks exactly those
slots (ALiBi distances stay slot-contiguous within a row). A wave of
admissions is one B-row vision encode + prefill and one merge. Decode runs
in chunks of `chunk_tokens` greedy steps of `Flamingo.decode_step`, on the
fused route (K1-K3) on the card; a chunk makes no host sync, and its tokens
stay on the device until harvested. The engine's cache, media K/V,
latents, logits and per-row state are allocated once (the cache and media
at the first admission) and updated in place, so they keep their
addresses; each wave's prefill makes its own small cache, as its
activations are its own.

Emitted tokens are exactly `flamingo_generate`'s greedy tokens for the same
request, whatever the admission order. When the write slot would pass
max_seq_len the engine drains (admits nothing more) and resets the epoch:
caches zeroed in place, the slot back to the prompt window. Greedy only.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import torch

from .device import resolve_device
from .generation import GenerationConfig, _process_logits, prefill
from .models.absorb_vit import SideHook, finish_tokens, make_plan, patch_embed_flat
from .models.decoders.common import KVCache, LayerKV, admit_rows, reset_cache
from .models.flamingo import Flamingo, count_media
from .ops.dense_stream import fused_route


@dataclasses.dataclass
class _Request:
    rid: int
    vision_x: torch.Tensor        # (T_img, F, H, W, C) pixels
    input_ids: torch.Tensor       # (P,)
    attention_mask: torch.Tensor  # (P,)
    max_new_tokens: int
    t_submit: float = 0.0         # perf_counter at submit


@dataclasses.dataclass
class _RowState:
    rid: int
    emitted: List[int]
    max_new: int
    done: bool = False
    horizon: int = 0              # slot index by which this tenant must retire
    retired: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0          # host clock when the first token was observed
    t_last: float = 0.0


class ServingEngine:
    """Fixed-shape continuous-batching server around one Flamingo model:
    `batch_size` rows x `max_seq_len` cache slots, prompts left-padded to
    `max_prompt_len` (a multiple of 16), decode in chunks of `chunk_tokens`
    steps, admission and retirement on the host between chunks.

    pipeline_depth > 0 keeps up to that many decoded chunks in flight before
    their tokens are read on the host: each chunk's tokens are copied
    (non_blocking, into pinned host memory on the card) behind an event, so
    the read of the oldest overlaps the later chunks' work. Tokens are routed
    by the tenancy snapshot taken at dispatch; retires are observed up to
    `depth` chunks late. 0 reads every chunk at once.

    int8_kv (`gen.int8_kv`) holds the K/V and media caches as int8 where
    decode takes the fused route, as `flamingo_generate` does.
    absorb_vision: queued requests' images are encoded as K2b side tiles of
    the decode chunks (`models/absorb_vit.py`), `absorb_batch` images a
    cycle (default batch_size); their admission then skips the vision encode
    (the absorbed ViT's latents, `embed_vision`'s up to the order of its
    sums; the side tiles leave the decode's own outputs bit for bit). A
    geometry the plan refuses, or the unfused route, turns it off."""

    def __init__(self, model: Flamingo, *, batch_size: int, max_seq_len: int, max_prompt_len: int,
                 t_img: int = 1, chunk_tokens: int = 8, gen: Optional[GenerationConfig] = None,
                 pipeline_depth: int = 0, absorb_vision: bool = False, absorb_batch: Optional[int] = None,
                 device="cuda"):
        if max_prompt_len % 16 or max_seq_len % 16:
            raise ValueError("max_prompt_len and max_seq_len must be multiples of 16")
        if max_prompt_len + chunk_tokens > max_seq_len:
            raise ValueError("max_prompt_len + chunk_tokens exceeds max_seq_len")
        self.dev = resolve_device(device)
        if model.device != self.dev:
            raise ValueError(f"model lives on {model.device}, the engine asked for {self.dev}")
        self.model = model
        self.b, self.s_max, self.p_max = batch_size, max_seq_len, max_prompt_len
        self.t_img, self.chunk = t_img, chunk_tokens
        self.depth = int(pipeline_depth)
        self.gen = gen or GenerationConfig(max_new_tokens=0)
        if self.gen.do_sample or self.gen.num_beams != 1:
            raise ValueError("the serving engine is greedy-only")
        fused = fused_route(self.dev)
        self._int8_kv = self.gen.int8_kv and fused

        self._queue: deque = deque()
        self._rows: List[Optional[_RowState]] = [None] * batch_size
        self._results: "OrderedDict[int, List[int]]" = OrderedDict()
        # {rid: {"ttft_s", "tpot_s", "e2e_s", "n"}}: observed at harvest on
        # the host clock, so pipeline_depth's late reads count as latency
        self.latencies: Dict[int, Dict[str, float]] = {}
        self._next_rid = 0
        self._draining = False
        self.epochs = 0                 # completed drain + reset cycles
        self._pending: deque = deque()  # (host tokens, event or None, tenancy snapshot)
        pin = self.dev.type == "cuda"
        self._host = [torch.empty(batch_size, chunk_tokens, dtype=torch.long, pin_memory=pin)
                      for _ in range(self.depth + 1)]
        self._ring = 0
        self._cache: Optional[KVCache] = None
        self._latents = self._logits = None
        self._n_media = torch.zeros(batch_size, dtype=torch.long, device=self.dev)
        self._finished = torch.ones(batch_size, dtype=torch.bool, device=self.dev)
        self._step = torch.zeros(batch_size, dtype=torch.long, device=self.dev)
        self._ones = torch.ones(batch_size, 1, dtype=torch.long, device=self.dev)

        self._absorb_on = bool(absorb_vision) and fused
        self._abs_bpre = absorb_batch or batch_size
        self._abs_plan = None
        self._abs_xw = None          # the open cycle's flat ViT workspace
        self._abs_done = 0           # absorbing steps run in this cycle
        self._abs_rids: List[int] = []
        self._abs_seen: set = set()  # rids encoded or in flight
        self._lat_pool: Dict[int, torch.Tensor] = {}
        self.absorb_hits = 0         # admissions served from the pool
        self.absorb_misses = 0       # admissions that ran the ViT

    # --- state ---------------------------------------------------------------

    @property
    def _idx(self) -> int:
        return self._cache.index

    def _new_epoch(self) -> None:
        """The engine state at the start of an epoch: the write slot at
        max_prompt_len, so that the first admissions have a whole prompt
        window behind them; caches and rows zeroed in place after the first."""
        if self._cache is None:
            m = self.model
            self._cache = KVCache.create(m.cfg.lm, self.b, self.s_max, m.dtype, self.dev, int8=self._int8_kv)
            self._cache.index = self.p_max
            self._cache.slot.fill_(self.p_max)
        else:
            reset_cache(self._cache, self.p_max)
            for x in (self._latents, self._logits, self._n_media, self._step):
                if x is not None:
                    x.zero_()
            self._finished.fill_(True)

    def _containers(self, pre: KVCache, latents: torch.Tensor, logits: torch.Tensor) -> None:
        """The B-row media K/V, latents and logits, shaped by the first
        admission's prefill: zeros (int8 scales 1)."""
        if self._cache.media is None and pre.media is not None:
            def widen(x, fill=0.0):
                return None if x is None else torch.full((self.b, *x.shape[1:]), fill, dtype=x.dtype,
                                                         device=self.dev)

            self._cache.media = tuple(LayerKV(widen(m.k), widen(m.v), widen(m.k_s, 1.0), widen(m.v_s, 1.0))
                                      for m in pre.media)
        if self._latents is None:
            self._latents = torch.zeros((self.b, *latents.shape[1:]), dtype=latents.dtype, device=self.dev)
            self._logits = torch.zeros((self.b, logits.shape[-1]), dtype=logits.dtype, device=self.dev)

    # --- admission -----------------------------------------------------------

    def _admit(self, admits, lat=None) -> None:
        """Admit [(row, request)]: one left-padded prefill of 1 row (a single
        admission) or of B rows aligned to the engine's (a wave; dummy rows
        zeros, left out of the merge), then one in-place merge. `lat`
        ({rid: latents}) skips the vision encode (the absorb pool)."""
        r = 1 if len(admits) == 1 else self.b
        src = [0] if r == 1 else [row for row, _ in admits]
        ids = torch.zeros(r, self.p_max, dtype=torch.long)
        mask = torch.zeros(r, self.p_max, dtype=torch.long)
        for k, (_, req) in zip(src, admits):
            p = req.input_ids.shape[0]
            ids[k, self.p_max - p:] = req.input_ids
            mask[k, self.p_max - p:] = req.attention_mask
        ids, mask = ids.to(self.dev), mask.to(self.dev)
        m = self.model
        if lat is not None:
            some = next(iter(lat.values()))
            latents = torch.zeros((r, *some.shape), dtype=m.dtype, device=self.dev)
            for k, (_, req) in zip(src, admits):
                latents[k] = lat[req.rid]
        else:
            vx = torch.zeros((r, *admits[0][1].vision_x.shape), dtype=m.dtype, device=self.dev)
            for k, (_, req) in zip(src, admits):
                vx[k] = req.vision_x.to(device=self.dev, dtype=m.dtype)
            latents = m.embed_vision(vx)
        logits, pre = prefill(m, latents, ids, mask, self.p_max, self._int8_kv)
        self._containers(pre, latents, logits)
        rows = torch.tensor([row for row, _ in admits], device=self.dev)
        src_t = torch.tensor(src, device=self.dev)
        admit_rows(self._cache, pre, rows, src_t)
        self._latents[rows] = latents[src_t]
        self._logits[rows] = logits[src_t, -1]
        self._n_media[rows] = count_media(ids, m.cfg.media_token_id)[src_t]
        self._finished[rows] = False
        self._step[rows] = 0
        for row, req in admits:
            self._rows[row] = _RowState(req.rid, [], req.max_new_tokens, horizon=self._horizon(req.max_new_tokens),
                                        t_submit=req.t_submit)

    # --- decode --------------------------------------------------------------

    def _decode_chunk(self, n_abs: int = 0) -> torch.Tensor:
        """`chunk_tokens` greedy steps for every row, exactly
        `greedy_or_sample`'s tokens (pad after EOS, each row's own step for
        min_new_tokens); finished rows are fed pad. The first `n_abs` steps
        each carry the open absorb cycle's next `per_step` ViT layers.
        Returns the tokens (B, chunk) on the device; no host sync."""
        cfg, m = self.gen, self.model
        toks = []
        for i in range(self.chunk):
            logits = _process_logits(self._logits, self._step, cfg)
            tok = torch.argmax(logits, dim=-1)
            if cfg.eos_token_id is not None:
                tok = torch.where(self._finished, cfg.pad_token_id, tok)
                self._finished |= tok == cfg.eos_token_id
            side = None
            if i < n_abs:
                p, done = self._abs_plan, self._abs_done
                blocks = m.vision_encoder.blocks[done * p.per_step:(done + 1) * p.per_step]
                side = SideHook(blocks, self._abs_xw, p)
            new_logits, self._cache = m.decode_step(self._latents, tok[:, None], self._ones, self._cache,
                                                    self._n_media, side)
            if side is not None:
                self._abs_xw = side.result()
                self._abs_done += 1
            self._logits.copy_(new_logits[:, 0])
            self._step += 1
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _dispatch(self, toks: torch.Tensor) -> None:
        """Start the copy of a chunk's tokens to the host (non_blocking into
        a pinned buffer of the ring, behind an event) and queue it with the
        dispatch-time tenancy."""
        host = self._host[self._ring % len(self._host)]
        self._ring += 1
        host.copy_(toks, non_blocking=True)
        event = None
        if self.dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending.append((host, event, list(self._rows)))

    def _harvest_one(self) -> None:
        """Read the oldest in-flight chunk's tokens and do its bookkeeping,
        routed by the tenancy snapshot of its dispatch: pads a finished
        tenant was fed never reach the row's next tenant."""
        host, event, snap = self._pending.popleft()
        if event is not None:
            event.synchronize()
        toks = host.tolist()
        now = time.perf_counter()
        eos = self.gen.eos_token_id
        for row, rs in enumerate(snap):
            if rs is None:
                continue
            for t in toks[row]:
                if len(rs.emitted) < rs.max_new and not rs.done:
                    rs.emitted.append(t)
                    if rs.t_first == 0.0:
                        rs.t_first = now
                    rs.t_last = now
                    if eos is not None and t == eos:
                        rs.done = True
            if not rs.retired and (rs.done or len(rs.emitted) >= rs.max_new):
                rs.retired = True
                n_out = min(len(rs.emitted), rs.max_new)
                self._results[rs.rid] = rs.emitted[:n_out]
                self.latencies[rs.rid] = {
                    "ttft_s": rs.t_first - rs.t_submit,
                    "tpot_s": (rs.t_last - rs.t_first) / (n_out - 1) if n_out > 1 else 0.0,
                    "e2e_s": rs.t_last - rs.t_submit,
                    "n": n_out,
                }
                if self._rows[row] is rs:
                    self._rows[row] = None

    def _flush(self) -> None:
        while self._pending:
            self._harvest_one()

    # --- absorbed-ViT pre-encode ---------------------------------------------

    def _abs_maybe_start(self) -> None:
        """Open a pre-encode cycle over the next queued requests not yet
        encoded: their pixels patch-embedded into a fresh workspace. The
        first cycle fixes the plan from their geometry; a geometry the plan
        refuses turns absorption off (as `flamingo_generate(next_pixels=)`
        falls back)."""
        if not self._absorb_on or self._abs_xw is not None:
            return
        cands = [r for r in self._queue if r.rid not in self._abs_seen][:self._abs_bpre]
        if not cands:
            return
        m = self.model
        if self._abs_plan is None:
            f = int(cands[0].vision_x.shape[1])
            self._abs_plan = make_plan(m.cfg, (self._abs_bpre, self.t_img, f), max_new_tokens=10**9)
            if self._abs_plan is None:
                self._absorb_on = False
                return
        p = self._abs_plan
        px = torch.zeros((p.b, *cands[0].vision_x.shape), dtype=m.dtype, device=self.dev)
        for i, r in enumerate(cands):
            px[i] = r.vision_x.to(device=self.dev, dtype=m.dtype)
            self._abs_seen.add(r.rid)
        self._abs_rids = [r.rid for r in cands]
        self._abs_done = 0
        self._abs_xw = patch_embed_flat(m.vision_encoder, px.reshape(p.bv, *px.shape[3:]), p)

    def _abs_harvest_cycle(self) -> None:
        """A finished cycle's workspace -> perceiver latents, one pool entry
        per rid not admitted meanwhile."""
        m = self.model
        lat = m.resample_vision(finish_tokens(m.vision_encoder, self._abs_xw, self._abs_plan))
        for i, rid in enumerate(self._abs_rids):
            if rid in self._abs_seen:
                self._lat_pool[rid] = lat[i]
        self._abs_xw, self._abs_done, self._abs_rids = None, 0, []

    def _abs_pool_take(self, admits):
        """{rid: latents} for an admission wave, or None unless every
        admitted rid has a pool entry (all or nothing: the wave then runs the
        vision encode). The pool and cycle entries of admitted rids are
        dropped either way."""
        if not self._absorb_on and not self._lat_pool:
            return None
        hit = bool(self._lat_pool) and all(req.rid in self._lat_pool for _, req in admits)
        out = None
        if hit:
            out = {req.rid: self._lat_pool[req.rid] for _, req in admits}
            self.absorb_hits += len(admits)
        elif self._absorb_on:
            self.absorb_misses += len(admits)
        for _, req in admits:
            self._lat_pool.pop(req.rid, None)
            self._abs_seen.discard(req.rid)
        return out

    # --- host API ------------------------------------------------------------

    def submit(self, vision_x, input_ids, attention_mask=None, max_new_tokens: int = 32) -> int:
        """Enqueue one request: vision_x (T_img, F, H, W, C) pixels,
        input_ids / attention_mask (P,) with P <= max_prompt_len (tensors or
        arrays). Returns its id."""
        ids = torch.as_tensor(input_ids).long().cpu()
        if ids.shape[0] > self.p_max:
            raise ValueError(f"a prompt of {ids.shape[0]} tokens exceeds max_prompt_len={self.p_max}")
        vision_x = torch.as_tensor(vision_x)
        if vision_x.shape[0] != self.t_img:
            raise ValueError(f"vision_x must carry t_img={self.t_img} media slots, got {vision_x.shape[0]}")
        if self.p_max + self._chunks(max_new_tokens) > self.s_max:
            raise ValueError(f"max_new_tokens={max_new_tokens} cannot fit an epoch: "
                             "max_prompt_len + ceil(max_new / chunk) * chunk > max_seq_len")
        mask = torch.ones_like(ids) if attention_mask is None else torch.as_tensor(attention_mask).long().cpu()
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, vision_x, ids, mask, max_new_tokens, t_submit=time.perf_counter()))
        return rid

    def _chunks(self, max_new: int) -> int:
        return -(-max_new // self.chunk) * self.chunk

    def _horizon(self, max_new: int) -> int:
        """The slot index by which a tenant admitted now must have retired.
        The dispatch guard's safety rests on `_fits` using this same
        expression."""
        return self._idx + self._chunks(max_new)

    def _fits(self, max_new: int) -> bool:
        """A request admitted at the current slot is live for at most
        ceil(max_new / chunk) chunks: it fits iff that horizon stays inside
        the cache."""
        return self._horizon(max_new) <= self.s_max

    @torch.no_grad()
    def step(self) -> bool:
        """Admit, decode one chunk, harvest and retire. Returns True while
        there is (or will be) work in flight."""
        # epoch reset once drained; the pipeline is flushed only once no row
        # is visibly live, so the drain tail keeps its pipeline depth
        if self._draining and not any(r is not None for r in self._rows):
            self._flush()
        if self._draining and all(r is None for r in self._rows):
            self._new_epoch()
            self._draining = False
            self.epochs += 1
        if self._cache is None:
            self._new_epoch()
        if not self._draining:
            admits = []
            for row in range(self.b):
                if self._rows[row] is None and self._queue:
                    # every live row must retire before the slot reaches
                    # max_seq_len (make_attn_inputs refuses to write past it)
                    if not self._fits(self._queue[0].max_new_tokens):
                        self._draining = True
                        break
                    admits.append((row, self._queue.popleft()))
            if admits:
                self._admit(admits, lat=self._abs_pool_take(admits))
        if all(r is None for r in self._rows) and not self._pending:
            if self._queue:
                self._draining = True   # nothing live: reset next step
                return True
            return False
        # harvest-lag guard: dispatch only while some tenant can still need
        # tokens; else retires observed `depth` chunks late would keep
        # dispatching pad-only chunks past max_seq_len
        if not any(rs is not None and self._idx < rs.horizon for rs in self._rows):
            self._flush()
            return bool(self._queue) or any(r is not None for r in self._rows)
        if self._idx + self.chunk > self.s_max:
            raise RuntimeError("engine invariant: live rows always fit (admission horizon)")
        self._abs_maybe_start()
        n_abs = 0
        if self._abs_xw is not None:
            n_abs = min(self.chunk, self._abs_plan.n_steps - self._abs_done)
        self._dispatch(self._decode_chunk(n_abs))
        if self._abs_xw is not None and self._abs_done >= self._abs_plan.n_steps:
            self._abs_harvest_cycle()
        # horizon re-tenancy: a tenant whose horizon the slot has reached
        # can receive no token from a later chunk, so its row frees now; its
        # tokens still land through the dispatch-time snapshots
        for row, rs in enumerate(self._rows):
            if rs is not None and self._idx >= rs.horizon:
                self._rows[row] = None
        while len(self._pending) > self.depth:
            self._harvest_one()
        return bool(self._queue) or any(r is not None for r in self._rows) or bool(self._pending)

    def run(self) -> Dict[int, List[int]]:
        """Serve until the queue drains; returns {rid: generated ids}."""
        while self.step():
            pass
        out, self._results = self._results, OrderedDict()
        return out

    def latency_stats(self) -> Dict[str, float]:
        """p50 / p99 TTFT, TPOT and end-to-end latency over every retired
        request, in seconds on the host clock at harvest (pipeline depth's
        late reads count). Empty before the first retire."""
        if not self.latencies:
            return {}
        recs = list(self.latencies.values())

        def pct(key, q):
            vals = sorted(r[key] for r in recs)
            return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]

        return {"n_requests": len(recs),
                **{f"{key}_{p}_s": pct(f"{key}_s", q) for key in ("ttft", "tpot", "e2e")
                   for p, q in (("p50", 0.50), ("p99", 0.99))}}
