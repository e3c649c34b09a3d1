"""Cross-batch absorbed ViT: the next batch's vision encode rides this
batch's decode loop as K2b side tiles (the JAX package's
`models/absorb_vit.py`).

The decode step streams weights and leaves the card's tensor cores idle.
`flamingo_generate(next_pixels=)` schedules the NEXT batch's CLIP ViT
forward as side tiles of the step's K2 `fused_mlp` launches (the xattn FF
and each decoder block's MLP, in program order), with K8
`flat_vit_attention` as the attention glue on the flat (B, S_pad, H*Dh)
workspace between the projection slots. With `ATTN_CARRIERS` the K3
`attn_block_decode` launches carry tiles too (K2b-attn): the gated block's
q-only attention in every family, MPT's self-attention (the only family
whose self-attention is K3), in program order before each K2.

Schedule per ViT layer, every side product an (M, D/F) x (D/F or D) tile
(F = `split`; fc1 cut into column slices and fc2 into row slices of its
JAX (I, D) kernel, so every slot is uniform):

  slots [0, 3F)            q/k/v column parts (LayerNorm 1 in the tile)
  glue                     flat attention on the (B, S_pad, D) workspace
  slots [3F, 4F)           out-projection parts (+ the workspace's columns)
  slots [4F, 4F + n1*F)    fc1 column slices (LayerNorm 2 in the tile)
  slots [.., end)          fc2 slices (quick_gelu in the tile, + the chain)

One decode step carries `per_step` ViT layers over its first `side_groups`
groups of n layers (n = cross_attn_every_n), `macro` groups a layer; the
first `n_steps` decode forwards absorb, the rest run plain.

The weights are the ViT's own `nn.Linear` (out, in) tensors, read in place:
JAX's column slices are row slices of the torch weight, and its fc2 row
slices are column slices of torch's (D, I) fc2 weight, which the side
kernel reads with a row stride. Nothing is stacked or copied per call.

With the ViT's int8 side-car attached (`quantize.quantize_prefill_weights`)
and `SIDE_INT8` on (the default, as in the JAX package), every slot hands
its carrier int8 weight slices and their scales: the W8A8 side tile (K2b
int8), whose activations are quantized per row over the slot's own K (an
fc2 slot's D-wide slice of the hidden row), so the absorbed W8A8 ViT is not
the serial W8A8 ViT of `embed_vision`.

Differences from the JAX plan: the port has one per-layer layout, which
runs the kernels of the JAX scan engine, so `scan_layers` does not gate the
plan; `m_pad` rounds to the side kernel's row tile, not to the TPU grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import use_kernels
from ..ops.dense_stream import SIDE_ROWS  # the side tile kernel's row tile: m_pad's quantum
from ..ops.vit_attention import flat_vit_attention, reference_flat_vit_attention


@dataclasses.dataclass(frozen=True)
class AbsorbPlan:
    """Static geometry of one absorbed-ViT run."""
    b: int            # batch of the NEXT batch's pixels
    t: int            # T_img
    f: int            # frames
    s_real: int       # ViT sequence = num_patches + 1 (CLS)
    s_pad: int        # per-image padded sequence (a multiple of 8)
    m_f: int          # b*t*f * s_pad flat rows
    m_pad: int        # m_f rounded up to the side kernel's row tile
    d: int            # ViT hidden size
    heads: int
    n_fc1: int        # intermediate_size // d column slices
    n_fc2: int
    act: str          # ViT MLP activation (quick_gelu for CLIP)
    eps: float        # ViT LayerNorm eps
    macro: int        # decode groups per absorbed ViT layer
    per_step: int     # ViT layers absorbed per decode step
    n_steps: int      # decode steps that carry side work
    n_vit_layers: int
    split: int = 1    # every side product cut into `split` column / row parts
    attn_carriers: bool = False   # K3's launches carry tiles too

    @property
    def side_groups(self) -> int:
        """Groups of each absorbing decode step that carry side tiles."""
        return self.macro * self.per_step

    @property
    def bv(self) -> int:
        return self.b * self.t * self.f

    @property
    def slots_per_layer(self) -> int:
        return self.split * (4 + self.n_fc1 + self.n_fc2)


# split-factor preference order (test hook, as in the JAX package)
PREFER_SPLIT = (1, 2)
# K3 attention-block launches join the carrier set (off by default, as in JAX)
ATTN_CARRIERS = False
# W8A8 side tiles when the ViT's int8 side-car is attached
SIDE_INT8 = True


def make_plan(cfg, vision_shape, max_new_tokens: int, num_beams: int = 1, prefer_split=None) -> Optional[AbsorbPlan]:
    """The schedule for the next batch's pixels of shape (b, t, f, ...), or
    None when the geometry cannot carry it (the caller encodes serially)."""
    v, lm = cfg.vision, cfg.lm
    if num_beams != 1:
        return None
    d, heads = v.hidden_size, v.num_heads
    dh = d // heads
    # the flat attention's column-block rule (the JAX kernel's lane width),
    # kept so that both packages engage on the same geometries
    hpb = max(1, 128 // dh) if d > 128 else heads
    while heads % hpb:
        hpb -= 1
    w = hpb * dh
    if not (w % 128 == 0 or w == d):
        return None
    if v.intermediate_size % d:
        return None
    n_fc1 = n_fc2 = v.intermediate_size // d
    n = cfg.cross_attn_every_n or 1
    if lm.num_layers % n:
        return None
    spg = n + 1                     # the xattn FF + n decoder MLPs per group
    if ATTN_CARRIERS:               # + the gated block's K3, + MPT's n self-attention K3s
        spg += 1 + (n if lm.family == "mpt" else 0)
    g = lm.num_layers // n
    macro = split = None
    for fs in prefer_split or PREFER_SPLIT:
        spl = fs * (4 + n_fc1 + n_fc2)
        if fs > 1 and (d // fs) % 128:
            continue
        cand = -(-spl // spg)
        if cand > g:
            continue
        macro, split = cand, fs
        break
    if macro is None:
        return None
    # the fewest ViT layers per decode step that max_new_tokens allows
    per_step = None
    for cand in range(1, g // macro + 1):
        if v.num_layers % cand or macro * cand > g:
            continue
        if v.num_layers // cand <= max_new_tokens:
            per_step = cand
            break
    if per_step is None:
        return None
    b, t, f = vision_shape
    s_real = v.num_patches + 1
    s_pad = -(-s_real // 8) * 8
    m_f = b * t * f * s_pad
    return AbsorbPlan(
        b=b, t=t, f=f, s_real=s_real, s_pad=s_pad, m_f=m_f, m_pad=-(-m_f // SIDE_ROWS) * SIDE_ROWS,
        d=d, heads=heads, n_fc1=n_fc1, n_fc2=n_fc2, act="quick_gelu" if v.hidden_act == "quick_gelu" else "gelu",
        eps=v.layer_norm_eps, macro=macro, per_step=per_step, n_steps=v.num_layers // per_step,
        n_vit_layers=v.num_layers, split=split, attn_carriers=ATTN_CARRIERS,
    )


def patch_embed_flat(vit, pixels: torch.Tensor, plan: AbsorbPlan) -> torch.Tensor:
    """The ViT's front half (`VisionTransformer.embed`) on (bv, H, W, C)
    pixels as the flat padded workspace (m_pad, D); pad rows are zeros."""
    if pixels.shape[0] != plan.bv:
        raise ValueError(f"patch_embed_flat: {pixels.shape[0]} images, the plan has {plan.bv}")
    x = F.pad(vit.embed(pixels), (0, 0, 0, plan.s_pad - plan.s_real)).reshape(plan.m_f, plan.d)
    return F.pad(x, (0, 0, 0, plan.m_pad - plan.m_f))


def finish_tokens(vit, xw: torch.Tensor, plan: AbsorbPlan) -> torch.Tensor:
    """The workspace after every absorbed layer -> (b, t, f, v, D) patch
    tokens (`VisionTransformer.patch_tokens` of the real rows)."""
    x = vit.patch_tokens(xw[: plan.m_f].reshape(plan.bv, plan.s_pad, plan.d)[:, : plan.s_real])
    return x.reshape(plan.b, plan.t, plan.f, plan.s_real - 1, plan.d)


class VitSideFeed:
    """One ViT layer's slot schedule: hands each carrier launch its side
    kwargs (`kwargs`) and routes the side output back (`take`). `block` is
    the layer's `ViTBlock`, `xw` the (m_pad, D) workspace entering it."""

    def __init__(self, block, xw: torch.Tensor, plan: AbsorbPlan):
        self.block, self.xw, self.plan = block, xw, plan
        self.slot = 0
        self.qkv = [[], [], []]    # column parts per projection
        self.x2_parts = []
        self.x2 = self.att = self.acc = None
        self.h = []

    def _glue(self) -> torch.Tensor:
        p = self.plan

        def flat(parts):
            x = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
            return x[: p.m_f].reshape(p.bv, p.s_pad, p.d)

        attend = flat_vit_attention if use_kernels(self.xw) else reference_flat_vit_attention
        out = attend(*(flat(parts) for parts in self.qkv), (p.d // p.heads) ** -0.5, heads=p.heads, s_real=p.s_real)
        return F.pad(out.reshape(p.m_f, p.d), (0, 0, 0, p.m_pad - p.m_f))

    def kwargs(self) -> dict:
        blk, p, s = self.block, self.plan, self.slot
        nf = p.split
        w = p.d // nf

        def rows(t, i):      # part i of an output axis (a weight's rows, a bias)
            return t[i * w:(i + 1) * w]

        def weight(lin, i, cols=False):
            """side_w (+ side_w_scale from the int8 side-car, JAX `_w`): part i
            of the output rows, with the scales' part; or (cols) of the input
            columns, read with the weight's row stride, with every scale."""
            q = getattr(lin, "weight_q", None) if SIDE_INT8 else None
            if q is None:
                return dict(side_w=lin.weight[:, i * w:(i + 1) * w] if cols else rows(lin.weight, i))
            if cols:
                return dict(side_w=q[:, i * w:(i + 1) * w], side_w_scale=lin.weight_s)
            return dict(side_w=rows(q, i), side_w_scale=rows(lin.weight_s, i))

        kw = dict(side_eps=p.eps)
        if s < 3 * nf:
            lin = (blk.q_proj, blk.k_proj, blk.v_proj)[s // nf]
            i = s % nf
            ln = blk.layer_norm1
            return dict(side_x=self.xw, **weight(lin, i), side_ln=(ln.weight, ln.bias), side_b=rows(lin.bias, i),
                        **kw)
        if s < 4 * nf:
            if self.att is None:
                self.att = self._glue()
            i = s - 3 * nf
            return dict(side_x=self.att, **weight(blk.out_proj, i), side_b=rows(blk.out_proj.bias, i),
                        side_residual=self.xw[:, i * w:(i + 1) * w], **kw)
        if s < (4 + p.n_fc1) * nf:
            i = s - 4 * nf
            ln = blk.layer_norm2
            return dict(side_x=self.x2, **weight(blk.fc1, i), side_ln=(ln.weight, ln.bias),
                        side_b=rows(blk.fc1.bias, i), **kw)
        i = s - (4 + p.n_fc1) * nf
        return dict(side_x=self.h[i], **weight(blk.fc2, i, cols=True), side_act=p.act,
                    side_b=blk.fc2.bias if i == 0 else None, side_residual=self.acc, **kw)

    def take(self, so: torch.Tensor) -> None:
        s, p = self.slot, self.plan
        nf = p.split
        self.slot += 1
        if s < 3 * nf:
            self.qkv[s // nf].append(so)
        elif s < 4 * nf:
            self.x2_parts.append(so)
            if len(self.x2_parts) == nf:
                self.x2 = self.x2_parts[0] if nf == 1 else torch.cat(self.x2_parts, -1)
                self.acc = self.x2     # the fc2 residual chain starts at x2
        elif s < (4 + p.n_fc1) * nf:
            self.h.append(so)
        else:
            self.acc = so

    def result(self) -> torch.Tensor:
        if self.slot != self.plan.slots_per_layer:
            raise RuntimeError(f"side schedule consumed {self.slot} of {self.plan.slots_per_layer} slots")
        return self.acc


class SideHook:
    """One absorbing decode step's side schedule (the JAX `_SideHook` and the
    scan engine's macro blocking): `group(g)` at the start of each group of
    n decoder layers opens ViT layer g // macro of this step at every macro
    boundary below `side_groups`; `kw()` gives the next K2 launch its side
    tile, None past the layer's slots (pad launches) and after
    `side_groups`; `attn_kw()` the next K3 launch, when the plan counts
    attention carriers; `take` routes the side output back. `result()` is
    the workspace after the step's layers."""

    def __init__(self, blocks, xw: torch.Tensor, plan: AbsorbPlan):
        self.blocks, self.xw, self.plan = list(blocks), xw, plan
        self.feed = None
        self.layers = 0

    def _close(self) -> None:
        if self.feed is not None:
            self.xw = self.feed.result()
            self.feed = None

    def group(self, g: int) -> None:
        if g % self.plan.macro:
            return
        self._close()
        j = g // self.plan.macro
        if j < len(self.blocks):
            self.feed = VitSideFeed(self.blocks[j], self.xw, self.plan)
            self.layers += 1

    def kw(self) -> Optional[dict]:
        if self.feed is None or self.feed.slot >= self.plan.slots_per_layer:
            return None
        return self.feed.kwargs()

    def attn_kw(self) -> Optional[dict]:
        return self.kw() if self.plan.attn_carriers else None

    def take(self, so: torch.Tensor) -> None:
        self.feed.take(so)

    def result(self) -> torch.Tensor:
        self._close()
        if self.layers != len(self.blocks):
            raise RuntimeError(f"decode step absorbed {self.layers} of {len(self.blocks)} ViT layers")
        return self.xw


def carry(side: Optional[SideHook], fn, *args, attn: bool = False, **kwargs):
    """`fn(*args, **kwargs)` carrying the side hook's next tile when one is
    due: fused_mlp or its plain version, or with `attn` attn_block_decode
    or its plain version (`SideHook.attn_kw`). The side output, which the
    carrier returns last, goes back to the hook. Returns what `fn` returns
    without a tile."""
    skw = None if side is None else side.attn_kw() if attn else side.kw()
    if skw is None:
        return fn(*args, **kwargs)
    *out, so = fn(*args, **kwargs, **skw)
    side.take(so)
    return out[0] if len(out) == 1 else tuple(out)
