#!/usr/bin/env python3
"""Where one greedy generate call, or one training step, of the PyTorch
port spends its time on the card.

    python3 chip_profile.py            # generate, the fused decode route (K1-K3)
    python3 chip_profile.py fused_layer  # the same with K11 in every MPT and gated block (fused_layer.DISABLE = False)
    python3 chip_profile.py xattn_only # the same with K11 in the gated blocks alone (fused_layer.XATTN_ONLY)
    python3 chip_profile.py unfused    # generate, the unfused route (K7, DISABLE_FUSED)
    python3 chip_profile.py train      # one bf16 train step (K4/K5 and K4b/K5b)
    python3 chip_profile.py of4b       # OF-4B generate, the fused route (K1, K6, K2; K3)
    python3 chip_profile.py int8       # OF-3B generate, fused, int8 weights and the int8 K/V + media caches
    python3 chip_profile.py int4       # OF-3B generate, fused, int4 weights (the head int8)
    python3 chip_profile.py llama      # LLaMA-7B generate, the fused route (3 K1, K6, K2 SwiGLU; K3)
    python3 chip_profile.py opt        # OPT-1.3B generate, the fused route (3 K1, K6, K2 relu; K3)
    python3 chip_profile.py gemv       # K1 and K2 alone at every row of PERF.md's kernel table, B 8 and 64
    python3 chip_profile.py vit        # K9, K10 and the ViT-L/14 forward alone (B 8, 32), kernels and plain
    python3 chip_profile.py vit --parent=<csrc dir> [--variants=no_softmax,no_products,loads_stores]
                                       # K9 and K8 alone and the ViT-L/14 forward, this tree's
                                       # vit_attention.cu and another checkout's in turns in one process
    python3 chip_profile.py k2         # plain K2 and K3 at OF-3B's shapes (bf16, int8, int4): the parent/change A/B
    python3 chip_profile.py k36 [--parent=<csrc dir>] [--variants=no_split,...]
                                       # K3 and K6 alone, B 8 and 64, this tree's decode_layer.cu,
                                       # another checkout's and variants in turns in one process
    python3 chip_profile.py k7 [--parent=<csrc dir>] [--variants=no_compute,no_loads,...]
                                       # K7 alone at its path shapes and LLaMA-7B's S 2,048 (B 1, 8), this
                                       # tree's decode_attention.cu, another checkout's and plan variants in turns
    python3 chip_profile.py k11 [--parent=<csrc dir>] [--variants=trace,stop1,no_prefetch,...]
                                       # K11 alone at LAYER_TIMED's layers, B 1, 8, 13, 72, this tree's
                                       # fused_layer.cu, another checkout's and variants in turns, K3 + K2 beside
    python3 chip_profile.py stream [--variants=empty,...]  # K1/K2's weight-streaming body against variants
    python3 chip_profile.py wall [model]  # host clock of 7 bf16 generate calls (OF-3B unless named)
    python3 chip_profile.py k45        # K4/K5's tensor-core body against variants of its source, one call
    python3 chip_profile.py k45b       # K4b/K5b's tensor-core body against variants of its source, one call
    python3 chip_profile.py side [out.pt] [--variants=no_prologue,...]
                                       # K2b / K2b int8 / K2b-attn cases and their carriers alone: the
                                       # parent/change A/B of the side tiles
    python3 chip_profile.py side_compare a.pt b.pt ...  # saved `side` outputs held bit for bit
    python3 chip_profile.py absorb     # an absorbing decode step against a plain one; the next batch's ViT
                                       # serial, as side tiles, and on a second CUDA stream; the B 64
                                       # int4 + W8A8 pipe, with and without ATTN_CARRIERS

Builds OF-3B (OF-4B for `of4b`; chip_smoke.py's LLaMA-7B and OPT-1.3B
configurations for `llama` and `opt`) at full width with random weights
(bf16), runs the same inputs as chip_smoke.py (generate: 8 prompts of 32
tokens, one image each, 32 new tokens; train: LAION 8x32 and MMC4 4x256
with six images), warms up once, times one untraced call, then traces one
call with torch.profiler; the generate modes of OF-3B's fused route
(`fused`, `fused_layer`, `xattn_only`) trace one decode step too (its
device events and busy time).
Prints one JSON line: wall seconds, the device's busy time (sum of the
device events' times; one stream, so they do not overlap) and idle share,
the device time of each hand-written kernel, the row GEMV's share of the
busy time, and the kernels with the most device time.

`gemv` times K1/K2 (bf16 activations, CUDA-graph replay) at every K1 and
K2 row of PERF.md's kernel table (B 8: OF-3B's, OF-4B's, LLaMA-7B's and
OPT-1.3B's shapes, every weight type and epilogue there) and at the B 64
pipe's (the tied head in int8, the MPT MLP in int4), with each case's
bound and its library call (`F.linear` over the bf16 weights). It imports
only the wrappers, the quantizers and chip_smoke.py's timer, so a copy of
this file in an older checkout times that checkout's kernels: parent and
change in turns in one call (unpack both trees under `_trees/`).

`vit` times K9 and K10 (bf16, CUDA-graph replay) at chip_smoke.py's
ViT-L/14 cases (B 8 and 32) and the ViT-L/14 forward with the kernels and
on the plain route (`DISABLE`), in turns kernels, plain, plain, kernels,
then traces one forward at B 8 on each route: device time by kind. It
imports only chip_smoke.py's ViT helpers and timer, so a copy in an older
checkout times that checkout's kernels.

`vit --parent=<csrc dir>` builds csrc/vit_attention.cu as this tree has it
and as another checkout's csrc directory has it (both at once,
`build_variants`; the C interface is the same) and times, through the
wrappers on each library in turns in one process (`times_in_turns`:
change, parent, parent, change), K9 at chip_smoke.py's ViT-L/14 B 8 and
32 and S 17 cases and K8 at the absorbed ViT's B' 8, 32 and 64, each with
its bound, SDPA's time on the same inputs (with the key mask for K8) and
the largest difference of the output from this tree's (`--variants=`
adds builds with VIT_VARIANTS' edits: the softmax, the products or both
skipped, what each part costs); then the bf16
ViT-L/14 forward at B 8 and 32 on each library in turns and on the plain
route, and one traced forward on each library: device time by kind.

`k2` times K2 without a side tile (bf16, B = 8, CUDA-graph replay) at
OF-3B's MPT MLP in bf16, int8 and int4 (and int4 at the pipe's B 64) and
its xattn FF, and K3 at OF-3B's
self-attention layer (slot 40 of 64) in bf16 and int8 and its gated
cross-attention layer: the separate launches K11 is held to. It imports
only `fused_mlp`, `attn_block_decode`, the
quantizers and chip_smoke.py's timer, so a copy in an older checkout times
that checkout's kernels (parent, change, change, parent in one call); it
saves each case's output beside the built kernels
(`open_flamingo_tpu_torch/_build/k2_outputs_<tree>.pt`), so two trees'
outputs can be held bit for bit.

`k36` builds csrc/decode_layer.cu as this tree has it and, with
`--parent=`, as another checkout's csrc directory has it (both at once,
`build_variants`), and times K3 and K6 through their wrappers on each
library in turns in one process (`times_in_turns`: change, parent, parent,
change; the other library behind this tree's C interface,
`ParentDecodeLayer`; `--variants=` adds builds with STREAM_VARIANTS' edits
of csrc/rows_stream.cuh) at `k36_cases`: K3's OF-3B self-attention and gated
block at B 8 and 64 with bf16, int8, int4 weights and int8 over the int8
cache, K6 at OF-4B, LLaMA-7B and OPT-1.3B, K3 carrying a bf16 and a W8A8
tile; each case with its bound, its library call and y's largest
difference from this tree's.

`k7` builds csrc/decode_attention.cu as this tree has it and, with
`--parent=`, as another checkout's csrc directory has it (both at once,
`build_variants`), and times K7 through its wrappers on each library in
turns in one process (`times_in_turns`: change, parent, parent, change; the
parent's one-block-per-(b, h) library behind this tree's C interface,
`ParentDecodeAttention`; `--variants=` adds this library under other split
plans, K7_PLAN_VARIANTS: 4 splits at most, a two-tile ring, and builds with
K7_SRC_VARIANTS' edits: the compute or the loads skipped, 16 warps, other
tile sizes, base e, no watchdog) at
`k7_cases`: chip_smoke.py's K7 cases at OF-3B's, LLaMA-7B's and OPT-1.3B's
unfused decode (S 64) and at LLaMA-7B's S 2,048, B 1 and 8, both entry
points, each call reading the next of several cache copies (out of the L2);
bf16, each case with its bound, SDPA's time on the same inputs where SDPA
computes the same function, and the output's largest difference from this
tree's.

`k11` builds csrc/fused_layer.cu as this tree has it and, with
`--parent=`, as another checkout's csrc directory has it (both at once,
`build_variants`), and times K11 through its wrapper on each library in
turns in one process (`times_in_turns`; the parent's library behind this
tree's C interface, `ParentFusedLayer`, at B <= 64, the most the parent
takes in bf16; `--variants=` adds builds with K11_VARIANTS' edits: the
layer stopped after phase 1, 2, 3 or 4, each phase's first weight stages
issued after its barrier instead of before, the barriers doubled with and
without the stages in flight, the phases inlined into the kernel, and
`trace`, whose blocks write their `%globaltimer` at each phase's bounds:
one call a case on it prints when the first and the last block passed
each) at `k11_cases`: chip_smoke.py's LAYER_TIMED
layers (OF-3B's MPT-1B layer and gated block, MPT-7B's layer) with bf16,
int8 and int4 weights at B 1, 8, 13 and 72; bf16 activations, each case
with its bound, the K3 + K2 route's time on the same inputs and y's largest
difference from this tree's.

`k45` builds csrc/prefill_attention.cu as it is and as variants, each a
copy with one constant or branch changed (two blocks per SM for the
causal mask too, a three-stage ring, 32-key tiles, the compute skipped:
what staging, launch and stores cost alone), and times their bf16
entries on the same inputs (CUDA-graph replay, the variants in turns, each
twice) at K4's and K5's main shapes: generate's prefill S64 and T1, the
train step's LAION T32 and MMC4 T256, the ragged S 257. `k45b` does the
same for csrc/attention_backward.cu (the compute of both launches skipped,
two blocks per SM for the causal dq, one for dkv, a three-stage ring) at K4b's and
K5b's train shapes, LAION T32 and MMC4 T256, the dq and the dkv launch
timed apart (from the forward kernel's out and lse).

`side` times (bf16, CUDA-graph replay) chip_smoke.py's K2b, K2b int8 and
K2b-attn timed cases (ABSORB_TIMED, W8A8_TIMED: the absorbed ViT-L/14's
q/k/v and fc2 slots at the next batch's B 8 and the pipe's B 64, on OF-3B's
K2 and K3 carriers in bf16, int8 and int4) and each carrier launch alone.
It imports only the wrappers, the quantizers and chip_smoke.py's timer, so
a copy in an older checkout times that checkout (parent, change, change,
parent in one call); with an output path it saves every case's outputs,
and `side_compare` holds the W8A8 tiles and the carriers' outputs of two
trees bit for bit and reports the bf16 tiles' largest difference.
`--variants=` also builds csrc/dense_stream.cu and csrc/decode_layer.cu
with edits of csrc/side_tile.cuh (`SIDE_VARIANTS`: the prologue, the
products, the W loads or the epilogue skipped) and times the same cases
through them.

`absorb` (bf16 OF-3B, B 8, the next batch's 8 images): device time by
kind of one decode step carrying ViT layer 0 as side tiles against the
same step without them (one traced step each, after a warm-up); then the
next batch's encode three ways, host clock to a synchronize, in turns:
generate followed by embed_vision (serial), generate(next_pixels=) (side
tiles), and embed_vision enqueued on a second CUDA stream before generate
on the default one (a measurement only: the package has no second-stream
path); then one traced call of each form, device time by kind. Then the
JAX package's pipe (`bench.py` `b64_i4_pipe`) at B 64: int4 decode weights
with the ViT's int8 side-car (`quantize_prefill_weights(model, 4)`), W8A8
prefill, the current batch's latents given; with K2 carriers alone and with
`ATTN_CARRIERS` (K3 carrying half the W8A8 tiles): the absorbing step's
device time by kind against the plain step, and one traced pipe call
against one traced serial call (generate, then a W8A8 `embed_vision`).

Run from the repository root with one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import re
import sys
import time
from pathlib import Path

import torch


def k12_cases(dev):
    """Every K1 and K2 row of PERF.md's kernel table (bf16 activations, B 8,
    chip_smoke.py's shapes) and the B 64 pipe's (OF-3B's tied head in int8,
    its MPT MLP in int4): yields (kernel, case, call, bytes, flops, library
    call). Weights are made per case and dropped after it."""
    import torch.nn.functional as F

    from chip_smoke import B
    from open_flamingo_tpu_torch.models.layers import layer_norm
    from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp, normalize
    from open_flamingo_tpu_torch.quantize import pack_int4, quantize_weight

    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    def stored(w, bits):      # (the weight as streamed, its scale, its bytes)
        if bits is None:
            return w, None, w.numel() * 2
        q, sc = quantize_weight(w.float(), bits)
        q = q if bits == 8 else pack_int4(q)
        return q, sc, q.numel() + 4 * sc.numel()

    sfx = {None: "", 8: "_int8", 4: "_int4"}
    # K1: (case, B, D, N, bits, LN bias, bias, norm)
    for case, b, d, n, bits_list, lnb, bias, norm in (
            ("head_V50434", B, 2048, 50434, (None, 8), False, False, "layer"),
            ("neox_qkv_bias", B, 2560, 7680, (None, 8, 4), True, True, "layer"),
            ("neox_head_untied_V50434", B, 2560, 50434, (None,), True, False, "layer"),
            ("llama_q_rms", B, 4096, 4096, (None, 8, 4), False, False, "rms"),
            ("llama_head_rms_V32003", B, 4096, 32003, (None, 8), False, False, "rms"),
            ("opt_q_ln_bias", B, 2048, 2048, (None,), True, True, "layer"),
            ("head_V50434_B64", 64, 2048, 50434, (8,), False, False, "layer")):
        x, ln = rn(b, d), 1 + rn(d, scale=0.1)
        ln_b, b_ = (rn(d, scale=0.1) if lnb else None), (rn(n, scale=0.1) if bias else None)
        eps = 1e-6 if norm == "rms" else 1e-5
        hn = normalize(x, ln, ln_b, eps, norm)
        w = rn(n, d, scale=d**-0.5)
        for bits in bits_list:
            q, sc, wbytes = stored(w, bits)
            kw = dict(w_scale=sc, bias=b_, ln_scale=ln, ln_bias=ln_b, eps=eps, norm=norm)
            nbytes = wbytes + 2 * (b * d + d * (1 + lnb) + n * bias + b * n)
            name = case.replace("_B64", "") + sfx[bits] + ("_B64" if case.endswith("_B64") else "")
            yield ("fused_dense", name, lambda x=x, q=q, kw=kw: fused_dense(x, q, **kw), nbytes, 2 * b * n * d,
                   lambda hn=hn, w=w, b_=b_: F.linear(hn, w, b_))
        del w, q
    # K2: (case, B, D, hidden, bits, LN bias, biases, gate, act, SwiGLU)
    for case, b, d, k2, bits_list, lnb, biases, gated, act, swiglu in (
            ("mpt_mlp", B, 2048, 8192, (None, 8, 4), False, False, False, "gelu", False),
            ("xattn_ff", B, 2048, 8192, (None,), True, False, True, "gelu", False),
            ("neox_mlp_bias", B, 2560, 10240, (None,), True, True, False, "gelu", False),
            ("llama_xattn_ff_K2_16384", B, 4096, 16384, (None,), True, False, True, "gelu", False),
            ("opt_mlp_relu_bias", B, 2048, 8192, (None,), True, True, False, "relu", False),
            ("mlp_gelu_new", B, 2048, 8192, (None,), True, False, False, "gelu_new", False),
            ("mlp_quick_gelu", B, 2048, 8192, (None,), True, False, False, "quick_gelu", False),
            ("llama_swiglu", B, 4096, 11008, (None, 8, 4), False, False, False, "silu", True),
            ("swiglu_ragged_K2_11000", B, 4096, 11000, (None,), False, False, False, "silu", True),
            ("mpt_mlp_B64", 64, 2048, 8192, (4,), False, False, False, "gelu", False)):
        x, ln = rn(b, d), 1 + rn(d, scale=0.1)
        ln_b = rn(d, scale=0.1) if lnb else None
        norm, eps = ("rms", 1e-6) if swiglu else ("layer", 1e-5)
        hn = normalize(x, ln, ln_b, eps, norm) if swiglu else layer_norm(x, ln, ln_b)
        w1, w2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
        wg = rn(k2, d, scale=d**-0.5) if swiglu else None
        b1, b2 = (rn(k2, scale=0.1), rn(d, scale=0.1)) if biases else (None, None)
        gate = torch.full((1,), 0.5, device=dev, dtype=dt) if gated else None
        if swiglu:
            lib = lambda hn=hn, w1=w1, wg=wg, w2=w2: F.linear(F.silu(F.linear(hn, w1)) * F.linear(hn, wg), w2)
        else:
            lib = lambda hn=hn, w1=w1, w2=w2, b1=b1, b2=b2: F.linear(F.linear(hn, w1, b1), w2, b2)
        for bits in bits_list:
            (q1, s1, by1), (q2, s2, by2) = stored(w1, bits), stored(w2, bits)
            qg, sg, byg = stored(wg, bits) if swiglu else (None, None, 0)
            kw = dict(w1_gate=qg, w1_scale=s1, w2_scale=s2, w1_gate_scale=sg, b1=b1, b2=b2, ln_scale=ln,
                      ln_bias=ln_b, eps=eps, norm=norm, act=act, residual=x, gate=gate)
            nbytes = by1 + by2 + byg + 2 * (2 * b * d + d * (1 + lnb) + (k2 + d) * biases + gated)
            name = case.replace("_B64", "") + sfx[bits] + ("_B64" if case.endswith("_B64") else "")
            yield ("fused_mlp", name, lambda x=x, q1=q1, q2=q2, kw=kw: fused_mlp(x, q1, q2, **kw), nbytes,
                   2 * b * d * k2 * (3 if swiglu else 2), lib)
        del w1, w2, wg, q1, q2


def gemv_times() -> int:
    from chip_smoke import bound, card_line, device_ms

    dev, dt = torch.device("cuda", 0), torch.bfloat16
    for kernel, case, fn, nbytes, flops, lib in k12_cases(dev):
        b_ms, b_by = bound(nbytes, flops, dt)
        print(json.dumps({"profile": "gemv_bf16", "kernel": kernel, "case": case, "ms": device_ms(fn),
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(lib)}), flush=True)
    print(card_line(), flush=True)
    return 0


def wall_times(argv) -> int:
    """Host clock of whole bf16 generate calls (OF-3B, or the model named,
    B 8, the fused route): a warm-up, then 7 calls each ended by a
    synchronize; every call's seconds and the median. It imports only
    chip_smoke.py's model helpers, so a copy in an older checkout times
    that checkout: parent and change in turns in one call."""
    import statistics

    from chip_smoke import NEW_TOKENS, build_model, card_line, make_inputs, model_config
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate

    name = argv[0] if argv else "OF-3B"
    dev = torch.device("cuda", 0)
    cfg = model_config(name)
    model = build_model(cfg, dev, torch.bfloat16)
    vision_x, ids, mask = make_inputs(cfg, dev)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    runs = []
    with torch.no_grad():
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
            torch.cuda.synchronize()
            if i:
                runs.append(time.perf_counter() - t0)
    print(json.dumps({"profile": "generate_wall_bf16", "model": name, "runs_s": runs,
                      "median_s": statistics.median(runs)}), flush=True)
    print(card_line(), flush=True)
    return 0


def k2_times() -> int:
    import os

    from chip_smoke import B, card_line, device_ms
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
    from open_flamingo_tpu_torch.ops import build
    from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import fused_mlp
    from open_flamingo_tpu_torch.quantize import pack_int4, quantize_weight

    dev, dt = torch.device("cuda", 0), torch.bfloat16
    tree = os.path.basename(os.getcwd())
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    d, k2 = 2048, 8192
    x, ln, ln_b = rn(B, d), 1 + rn(d, scale=0.1), rn(d, scale=0.1)
    gate = torch.tensor([0.5], device=dev, dtype=dt)
    w1, w2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
    cases = {"mpt_mlp": (w1, w2, {}), "xattn_ff": (w1, w2, dict(ln_bias=ln_b, gate=gate))}
    for bits in (8, 4):
        (q1, s1), (q2, s2) = quantize_weight(w1, bits), quantize_weight(w2, bits)
        if bits == 4:
            q1, q2 = pack_int4(q1), pack_int4(q2)
        cases[f"mpt_mlp_int{bits}"] = (q1, q2, dict(w1_scale=s1, w2_scale=s2))
    cases["mpt_mlp_int4_B64"] = cases["mpt_mlp_int4"]     # the B 64 pipe's rows
    x64 = rn(64, d)
    outputs = {}
    for case, (a, b, kw) in cases.items():
        xc = x64 if case.endswith("_B64") else x
        fn = lambda a=a, b=b, kw=kw, xc=xc: fused_mlp(xc, a, b, ln_scale=ln, residual=xc, **kw)
        outputs[f"k2_{case}"] = fn().cpu()
        print(json.dumps({"profile": "k2_bf16", "tree": tree, "case": case, "ms": device_ms(fn)}), flush=True)
    # K3: the MPT self-attention layer (16 heads of Dh 128, slot 40 of 64) and the gated xattn layer
    h, dh, s = 16, 128, 64
    wqkv, wout = rn(3 * d, d, scale=d**-0.5), rn(d, d, scale=d**-0.5)
    kc, vc = rn(B, h, s, dh), rn(B, h, s, dh)
    mask = torch.ones(B, s, dtype=torch.bool, device=dev)
    mask[:, 41:] = False
    self_kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True,
                   slot=torch.tensor([40], dtype=torch.int32, device=dev),
                   slopes=torch.from_numpy(alibi_slopes(h)).to(dev))
    (q8, s8), (o8, so8) = quantize_weight(wqkv, 8), quantize_weight(wout, 8)
    wq, wo = rn(512, d, scale=d**-0.5), rn(d, 512, scale=512**-0.5)
    km, vm = rn(B, 8, s, 64), rn(B, 8, s, 64)
    k3 = {"self_S64_slot40": lambda: attn_block_decode(x, ln, None, wqkv, wout, kc, vc, mask, **self_kw)[0],
          "self_S64_slot40_int8": lambda: attn_block_decode(x, ln, None, q8, o8, kc, vc, mask, wq_scale=s8,
                                                            wout_scale=so8, **self_kw)[0],
          "xattn_S64_gate": lambda: attn_block_decode(x, ln, ln_b, wq, wo, km, vm, mask, heads=8, head_dim=64,
                                                      scale=0.125, gate=gate)}
    for case, fn in k3.items():
        outputs[f"k3_{case}"] = fn().cpu()
        print(json.dumps({"profile": "k3_bf16", "tree": tree, "case": case, "ms": device_ms(fn)}), flush=True)
    torch.save(outputs, build.BUILD_DIR / f"k2_outputs_{tree}.pt")   # to hold two trees' outputs bit for bit
    print(card_line(), flush=True)
    return 0


# variants of the ring tile, each edits of csrc/side_tile.cuh: its parts skipped, so what is left
# is timed alone
SIDE_VARIANTS = {
    "no_prologue": (("  prepare_rows<T, kI8>(a, m0, row_bytes, xs, sact);\n", ""),),
    "no_products": (("    chunk_products<kI8>(d, ", "    if (false) chunk_products<kI8>(d, "),),
    "no_loads": (("    if (s < total) load(s);\n", ""), ("    if (it + ahead < total) load(it + ahead);\n", "")),
    "no_epilogue": (("      ring_epilogue<T, kI8>(a, d, m0, n0, c_end, sact);\n", ""),),
}


def build_side_variants(names) -> dict:
    """csrc/dense_stream.cu and csrc/decode_layer.cu built with each named
    SIDE_VARIANTS edit, one `nvcc` each, all started together, under
    _build/side_<variant>/: variant -> {source: the loaded library}."""
    import ctypes
    import shutil
    import subprocess

    from open_flamingo_tpu_torch.ops import build

    procs = {}
    for variant in names:
        out = build.BUILD_DIR / f"side_{variant}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        header = out / "side_tile.cuh"
        text = header.read_text()
        for old, new in SIDE_VARIANTS[variant]:
            if old not in text:
                raise RuntimeError(f"side: variant {variant}: {old!r} is not in csrc/side_tile.cuh")
            text = text.replace(old, new)
        header.write_text(text)
        for name in ("dense_stream", "decode_layer"):
            procs[variant, name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (variant, name), proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"side: nvcc failed for {variant} {name}:\n{text}")
        libs.setdefault(variant, {})[name] = ctypes.CDLL(str(build.BUILD_DIR / f"side_{variant}" / f"{name}.so"))
    return libs


def side_times(argv) -> int:
    import os

    from chip_smoke import B, card_line, device_ms
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes, quantize_kv
    from open_flamingo_tpu_torch.ops import build, decode_layer, dense_stream
    from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import fused_mlp
    from open_flamingo_tpu_torch.quantize import pack_int4, quantize_weight

    variants = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), [])
    save = next((a for a in argv if a.endswith(".pt")), None)
    tree = os.path.basename(os.getcwd())
    libs = {"": None, **build_side_variants(variants)}
    dev, dt = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    def stored(w, bits):
        q, s = quantize_weight(w.float(), bits)
        return (q if bits == 8 else pack_int4(q)), s

    # the absorbed ViT-L/14's slots (D 1,024, I 4,096; S_pad 264) and OF-3B's carriers (MPT-1B: D 2,048, I 8,192;
    # self-attention 16 heads of Dh 128 at slot 40 of 64; the gated block 8 heads of Dh 64 over 64 latents)
    d, inter, s_pad, dm, k2 = 1024, 4096, 264, 2048, 8192
    w_qkv, w_fc2 = rn(d, d, scale=d**-0.5), rn(d, inter, scale=inter**-0.5)
    (q_qkv, s_qkv), (q_fc2, s_fc2) = quantize_weight(w_qkv.float(), 8), quantize_weight(w_fc2.float(), 8)
    s_ln, bias = (1 + rn(d, scale=0.1), rn(d, scale=0.1)), rn(d, scale=0.1)
    ln, ln_b = 1 + rn(dm, scale=0.1), rn(dm, scale=0.1)
    gate = torch.tensor([0.5], device=dev, dtype=dt)
    w1f, w2f = rn(k2, dm, scale=dm**-0.5), rn(dm, k2, scale=k2**-0.5)
    mlp_w = {"": (w1f, w2f, {})}
    for bits in (8, 4):
        (q1, s1), (q2, s2) = stored(w1f, bits), stored(w2f, bits)
        mlp_w[f"_int{bits}"] = (q1, q2, dict(w1_scale=s1, w2_scale=s2))
    wqkv, wout = rn(3 * dm, dm, scale=dm**-0.5), rn(dm, dm, scale=dm**-0.5)
    wq_x, wo_x = rn(512, dm, scale=dm**-0.5), rn(dm, 512, scale=512**-0.5)
    self_w = {"": (wqkv, wout, {})}
    x_w = {"": (wq_x, wo_x, {})}
    (q3, s3), (o3, so3) = stored(wqkv, 4), stored(wout, 4)
    self_w["_int4"] = (q3, o3, dict(wq_scale=s3, wout_scale=so3))
    (qx, sx), (ox, sox) = stored(wq_x, 4), stored(wo_x, 4)
    x_w["_int4"] = (qx, ox, dict(wq_scale=sx, wout_scale=sox))
    self8 = (*stored(wqkv, 8), *stored(wout, 8))
    self8 = (self8[0], self8[2], self8[1], self8[3])      # wq, wout, their scales

    carriers, cases = {}, {}
    for bd, sfx in ((B, ""), (64, "_B64")):
        m = bd * s_pad
        x = rn(bd, dm)
        xw, h_in, res = rn(m, d, scale=2.0), rn(m, d), rn(m, 2 * d)
        tiles = {"side_qkv": dict(side_x=xw, side_w=w_qkv, side_ln=s_ln, side_b=bias),
                 "side_fc2": dict(side_x=h_in, side_w=w_fc2[:, d:2 * d], side_act="quick_gelu", side_b=bias,
                                  side_residual=res[:, :d]),
                 "side8_qkv": dict(side_x=xw, side_w=q_qkv, side_w_scale=s_qkv, side_ln=s_ln, side_b=bias),
                 "side8_fc2": dict(side_x=h_in, side_w=q_fc2[:, d:2 * d], side_w_scale=s_fc2, side_act="quick_gelu",
                                   side_b=bias, side_residual=res[:, :d])}
        for wtag, (w1, w2, kw) in mlp_w.items():
            carriers[f"mpt_mlp{wtag}{sfx}"] = (lambda w1=w1, w2=w2, kw=kw, x=x, **skw:
                                               fused_mlp(x, w1, w2, ln_scale=ln, residual=x, **kw, **skw))
        carriers[f"xattn_ff{sfx}"] = (lambda x=x, **skw: fused_mlp(x, w1f, w2f, ln_scale=ln, ln_bias=ln_b, residual=x,
                                                                   gate=gate, **skw))
        km, vm = rn(bd, 8, 64, 64), rn(bd, 8, 64, 64)
        kc, vc = rn(bd, 16, 64, 128), rn(bd, 16, 64, 128)
        mask = torch.ones(bd, 64, dtype=torch.bool, device=dev)
        mask[:, 41:] = False
        self_kw = dict(heads=16, head_dim=128, scale=128**-0.5, fused_qkv=True,
                       slot=torch.tensor([40], dtype=torch.int32, device=dev),
                       slopes=torch.from_numpy(alibi_slopes(16)).to(dev), clip=6.0)
        for wtag, (wq, wo, kw) in self_w.items():
            carriers[f"self_S64_slot40{wtag}{sfx}"] = (
                lambda wq=wq, wo=wo, kw=kw, x=x, kc=kc, vc=vc, mask=mask, **skw:
                attn_block_decode(x, ln, None, wq, wo, kc, vc, mask, **self_kw, **kw, **skw))
        (k8, ks8), (v8, vs8) = quantize_kv(kc.float()), quantize_kv(vc.float())
        carriers[f"self_S64_slot40_int8_kv8{sfx}"] = (
            lambda x=x, k8=k8, v8=v8, ks8=ks8, vs8=vs8, mask=mask, **skw:
            attn_block_decode(x, ln, None, self8[0], self8[1], k8, v8, mask, **self_kw, wq_scale=self8[2],
                              wout_scale=self8[3], k_scale=ks8, v_scale=vs8, **skw))
        for wtag, (wq, wo, kw) in x_w.items():
            carriers[f"xattn_S64_gate{wtag}{sfx}"] = (
                lambda wq=wq, wo=wo, kw=kw, x=x, km=km, vm=vm, mask=mask, **skw:
                attn_block_decode(x, ln, ln_b, wq, wo, km, vm, mask, heads=8, head_dim=64, scale=0.125, gate=gate,
                                  **kw, **skw))
        # chip_smoke.py's ABSORB_TIMED / W8A8_TIMED side-tile cases at these carriers
        names = ([("mpt_mlp", "side_qkv"), ("mpt_mlp", "side_fc2"), ("mpt_mlp_int8", "side_qkv"),
                  ("mpt_mlp_int4", "side_qkv"), ("mpt_mlp_int4", "side_fc2"), ("mpt_mlp", "side8_qkv"),
                  ("mpt_mlp_int8", "side8_qkv"), ("mpt_mlp_int4", "side8_qkv"), ("mpt_mlp_int4", "side8_fc2"),
                  ("self_S64_slot40", "side"), ("self_S64_slot40", "side8_qkv"),
                  ("self_S64_slot40_int4", "side8_qkv"), ("self_S64_slot40_int8_kv8", "side8_qkv"),
                  ("xattn_S64_gate", "side"), ("xattn_S64_gate_int4", "side8_qkv"), ("xattn_ff", "side_qkv")]
                 if bd == B else
                 [("mpt_mlp_int4", "side8_qkv"), ("mpt_mlp_int4", "side8_fc2"), ("self_S64_slot40_int4", "side8_qkv"),
                  ("xattn_S64_gate_int4", "side8_qkv")])
        for carrier, tile in names:
            skw = tiles["side_qkv" if tile == "side" else tile]
            cname = f"{carrier}{sfx}"
            name = f"{carrier}{sfx}_{tile}" if sfx else f"{carrier}_{tile}"
            fn = lambda c=carriers[cname], skw=skw: c(**skw)
            cases[name] = ("fused_mlp" if carrier.startswith(("mpt_mlp", "xattn_ff")) else "attn_block_decode", fn,
                           cname)
    used = sorted({c for _, _, c in cases.values()})
    for variant, lib in libs.items():
        if lib is not None:   # the wrappers load the variant's libraries in place of the tree's own
            build._libs.update(lib)
            dense_stream._lib = decode_layer._lib = None
        label = f"{tree}_{variant}" if variant else tree
        outputs = {}
        with torch.no_grad():
            for name, (kernel, fn, cname) in cases.items():
                outs = fn()
                outputs[name] = [o.cpu() for o in (outs if isinstance(outs, tuple) else (outs,))]
                print(json.dumps({"profile": "side_bf16", "tree": label, "kernel": kernel, "case": name,
                                  "carrier": cname, "ms": device_ms(fn)}), flush=True)
            for cname in used:
                outs = carriers[cname]()
                outputs[f"carrier:{cname}"] = [o.cpu() for o in (outs if isinstance(outs, tuple) else (outs,))]
                print(json.dumps({"profile": "side_bf16", "tree": label, "case": f"carrier:{cname}",
                                  "ms": device_ms(carriers[cname])}), flush=True)
        if save and not variant:   # the variants skip part of the tile
            torch.save(outputs, save)
    print(card_line(), flush=True)
    return 0


def side_compare(paths) -> int:
    """Two or more trees' saved `side` outputs against the first: the W8A8
    tiles (side8 cases) and every carrier output (K3's cache writes too) bit
    for bit, the bf16 tiles' largest difference. Exits 1 if a bit-for-bit
    output differs."""
    base = torch.load(paths[0])
    failed = False
    for path in paths[1:]:
        other = torch.load(path)
        row = {"profile": "side_compare", "base": paths[0], "other": path, "cases": {}}
        for name, outs in base.items():
            got = other[name]
            exact = "side8" in name or name.startswith("carrier:")
            same = [torch.equal(a, b) for a, b in zip(outs[:-1] if not name.startswith("carrier:") else outs,
                                                       got[:-1] if not name.startswith("carrier:") else got)]
            tile_diff = None if name.startswith("carrier:") else (outs[-1].float() - got[-1].float()).abs().max().item()
            tile_same = None if name.startswith("carrier:") else torch.equal(outs[-1], got[-1])
            row["cases"][name] = {"carrier_outputs_equal": all(same), "tile_equal": tile_same,
                                  "tile_max_abs_diff": tile_diff}
            failed |= not all(same) or (exact and tile_same is False)
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


def absorb_times() -> int:
    from chip_smoke import (B, NEW_TOKENS, T_PROMPT, attn_carriers, build_model, card_line, make_inputs,
                            model_config, next_pixels, w8a8_prefill)
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate, prefill
    from open_flamingo_tpu_torch.models.absorb_vit import SideHook, make_plan, patch_embed_flat
    from open_flamingo_tpu_torch.models.flamingo import count_media
    from open_flamingo_tpu_torch.quantize import quantize_prefill_weights

    dev = torch.device("cuda", 0)
    cfg = model_config("OF-3B")
    model = build_model(cfg, dev, torch.bfloat16)
    vision_x, ids, mask = make_inputs(cfg, dev)
    next_px = next_pixels(cfg, dev)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    plan = make_plan(cfg, next_px.shape[:3], NEW_TOKENS)
    kinds = (("K2 / K3 + side tiles", ("side_kernel",)), ("K2/K1 row GEMV", ("gemv",)),
             ("K8 flat_vit_attention", ("vit_attn_bf16<64, true>",)), ("K3 attend", ("attend_kernel",)),
             ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "splitK")), ("copy", ("copy", "Memcpy", "Memset")),
             ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))

    def step_profile(label, lat, ids, mask, next_px, plan):
        """One decode step carrying ViT layer 0 against the same step plain,
        device time by kind of one traced step each."""
        logits, cache = prefill(model, lat, ids, mask, T_PROMPT + NEW_TOKENS)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        n_media = count_media(ids, cfg.media_token_id)
        ones = torch.ones(ids.shape[0], 1, dtype=torch.long, device=dev)
        xw = patch_embed_flat(model.vision_encoder, next_px.reshape(plan.bv, *next_px.shape[3:]), plan)

        def step(side):
            hook = SideHook(model.vision_encoder.blocks[:plan.per_step], xw, plan) if side else None
            model.decode_step(lat, tok, ones, cache, n_media, side=hook)
            if hook is not None:
                hook.result()

        row = {"profile": label, "batch": ids.shape[0], "plan": {
            "per_step": plan.per_step, "macro": plan.macro, "slots_per_layer": plan.slots_per_layer,
            "m_pad": plan.m_pad, "attn_carriers": plan.attn_carriers}}
        for side in (False, True):
            step(side)
            torch.cuda.synchronize()
            row["absorbing" if side else "plain"] = device_time_by_kind(lambda: step(side), kinds)
        print(json.dumps(row), flush=True)

    with torch.no_grad():
        lat = model.embed_vision(vision_x)
        step_profile("absorb_step_bf16", lat, ids, mask, next_px, plan)

        def serial():
            flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
            model.embed_vision(next_px)

        def side_tiles():
            flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)

        stream = torch.cuda.Stream()

        def second_stream():
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                model.embed_vision(next_px)
            flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
            torch.cuda.current_stream().wait_stream(stream)

        forms = {"serial": serial, "side_tiles": side_tiles, "second_stream": second_stream}
        times = {name: [] for name in forms}
        for name in ("serial", "side_tiles", "second_stream"):
            forms[name]()
        for name in ("serial", "side_tiles", "second_stream", "second_stream", "side_tiles", "serial"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forms[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        print(json.dumps({"profile": "absorb_forms_bf16", "batch": B, "next_batch": B, "new_tokens": NEW_TOKENS,
                          "runs_s": times, "mean_s": {k: sum(v) / len(v) for k, v in times.items()}}), flush=True)
        # one traced call of each form: device time by kind (on two streams the events may overlap)
        traced = {name: device_time_by_kind(fn, kinds) for name, fn in forms.items()}
        print(json.dumps({"profile": "absorb_forms_traced_bf16",
                          **{name: {k: v for k, v in t.items() if k != "top"} for name, t in traced.items()}}),
              flush=True)

        # the pipe at B 64: int4 decode, the ViT's int8 side-car, W8A8 prefill, latents given
        quantize_prefill_weights(model, 4)
        b = 64
        vision_x, ids, mask = make_inputs(cfg, dev, b)
        next_px = next_pixels(cfg, dev, b)
        with w8a8_prefill():
            lat = model.embed_vision(vision_x)
            for carriers in (False, True):
                with attn_carriers(carriers):
                    plan = make_plan(cfg, next_px.shape[:3], NEW_TOKENS)
                    label = "pipe_int4_w8a8" + ("_attn" if carriers else "")
                    step_profile(f"{label}_step", lat, ids, mask, next_px, plan)

                    def pipe():
                        flamingo_generate(model, None, ids, mask, gcfg, media_latents=lat, next_pixels=next_px,
                                          device=dev)

                    def serial():
                        flamingo_generate(model, None, ids, mask, gcfg, media_latents=lat, device=dev)
                        model.embed_vision(next_px)

                    pipe()
                    serial()
                    traced = {"pipe": device_time_by_kind(pipe, kinds), "serial": device_time_by_kind(serial, kinds)}
                    print(json.dumps({"profile": f"{label}_call", "batch": b, "new_tokens": NEW_TOKENS,
                                      **{name: {k: v for k, v in t.items() if k != "top"}
                                         for name, t in traced.items()}}), flush=True)
    print(card_line(), flush=True)
    return 0


def gemv_symbols(rows) -> dict:
    """The row GEMV kernels among a trace's device events (name, seconds,
    count) by symbol, template arguments kept, the anonymous namespaces and
    the parameter list dropped: [device seconds, launches] each, so a run
    shows which body and which instances ran."""
    out = {}
    for name, t, n in rows:
        if "gemv" in name:
            key = name.replace("(anonymous namespace)::", "").split("(")[0]
            out[key] = [out.get(key, [0.0, 0])[0] + t, out.get(key, [0.0, 0])[1] + n]
    return out


def device_time_by_kind(run, kinds) -> dict:
    """Trace one call of `run`: device seconds by kind of kernel (the first
    kind whose keys match a kernel's name), the busy total and the event
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("the trace holds no device events")
    by_kind = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for name, t, _ in rows:
        by_kind[next((kind for kind, keys in kinds if any(key in name for key in keys)), "other")] += t
    rows.sort(key=lambda r: -r[1])
    return {"device_busy_s": sum(r[1] for r in rows), "device_s_by_kind": by_kind,
            "device_events": sum(r[2] for r in rows), "gemv_symbols": gemv_symbols(rows),
            "top": [{"name": k[:80], "device_s": t, "count": n} for k, t, n in rows[:8]]}


# K4/K5 body variants: name -> edits of csrc/prefill_attention.cu, each (text, its replacement)
K45_VARIANTS = {
    "fill2_causal": (("constexpr int kFill<CausalPadAlibi> = 1;", "constexpr int kFill<CausalPadAlibi> = 2;"),),
    "stages3": (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
    "tile32": (("constexpr int kTileKeys = 64;", "constexpr int kTileKeys = 32;"),),
    "no_compute": (("if (k0 < hi_w && k0 + kTileKeys > lo_w) {", "if (false) {"),),
}
# K4b/K5b body variants, edits of csrc/attention_backward.cu: the compute of
# both launches skipped (staging, the metadata, launch and stores alone), two
# blocks per SM for the causal dq, one for the dkv launch, a three-stage ring
K45B_VARIANTS = {
    "no_compute": (("if (k0 < hi_w && k0 + kTile > lo_w) {", "if (false) {"),
                   ("if (!__any_sync(0xffffffffu, lo_s[sl][cq] < kw1 && hi_s[sl][cq] > kw0)) continue;", "continue;")),
    "fill2_causal": (("constexpr int kFill<CausalPadAlibi> = 1;", "constexpr int kFill<CausalPadAlibi> = 2;"),),
    "fill1_dkv": (("constexpr int kFillDkv = 2;", "constexpr int kFillDkv = 1;"),),
    "stages3": (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
}


def build_variants(source: str, variants: dict, tag: str, target: str = None, trees: dict = None) -> dict:
    """csrc/<source>.cu as it is and as each variant (edits of the source, or
    of the csrc file `target`), and as each of `trees` builds it (name -> a
    csrc directory of another checkout, its own headers beside it), one
    `nvcc` each, all started together, under _build/<tag>_<name>/: name ->
    the loaded library. Each build's seconds are printed."""
    import ctypes
    import shutil
    import subprocess

    from open_flamingo_tpu_torch.ops import build

    target = target or f"{source}.cu"
    original = (build.CSRC / target).read_text()
    for name, edits in variants.items():   # every edit checked before any nvcc starts
        for old, _ in edits:
            if old not in original:
                raise RuntimeError(f"{tag}: variant {name}: {old!r} is not in {target}")
    procs = {}
    builds = {name: (build.CSRC, edits) for name, edits in {"as_is": (), **variants}.items()}
    builds.update({name: (Path(csrc), ()) for name, csrc in (trees or {}).items()})
    for name, (csrc, edits) in builds.items():
        out = build.BUILD_DIR / f"{tag}_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for path in [csrc / f"{source}.cu", *csrc.glob("*.cuh")]:
            shutil.copy(path, out)
        if edits:
            text = original
            for old, new in edits:
                text = text.replace(old, new)
            (out / target).write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(out / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       time.perf_counter())
    libs = {}
    for name, (proc, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed for {name}:\n{text}")
        print(json.dumps({"profile": f"{tag}_build", "build": name, "source": source,
                          "seconds": time.perf_counter() - t0}), flush=True)
        libs[name] = ctypes.CDLL(str(build.BUILD_DIR / f"{tag}_{name}" / "lib.so"))
    return libs


def times_in_turns(libs: dict, cases, profile: str) -> None:
    """Each case (kernel, case, outputs, {part: call(lib)}, and optionally a
    dict of fields printed with it), every variant in turns, each twice:
    device ms of each part's launch (CUDA-graph replay) and the largest
    difference of the outputs from the source as it is."""
    from chip_smoke import device_ms

    for kernel, case, outs, calls, *extra in cases:
        row = {"profile": profile, "kernel": kernel, "case": case, **(extra[0] if extra else {})}
        for turn in (list(libs), list(libs)[::-1]):
            for name in turn:
                for call in calls.values():
                    if call(libs[name]) != 0:
                        raise RuntimeError(f"{profile}: {name} {case}: launch failed")
                torch.cuda.synchronize()
                if name == "as_is":
                    want = [out.clone() for out in outs]
                for part, call in calls.items():
                    row.setdefault(f"{name}_{part}_ms" if part else f"{name}_ms", []).append(
                        device_ms(lambda: call(libs[name])))
                if not name.startswith("no_compute"):
                    row[f"{name}_max_abs_diff"] = max((o.float() - w.float()).abs().max().item()
                                                      for o, w in zip(outs, want))
        print(json.dumps(row), flush=True)


# variants of the weight-streaming row GEMV, each edits of csrc/rows_stream.cuh: its parts skipped, so
# what is left is timed alone
STREAM_VARIANTS = {
    "empty": (("  StreamRing<W, kGated, kMaxNt> ring(", "  if (b > 0) return;\n  StreamRing<W, kGated, kMaxNt> ring("),),
    "no_prologue": (("    if (ln_s != nullptr) stream_stats<kMaxNt == 1 ? 8 : 4, kCg>(x, eps, norm, b, k, mean, inv);\n", ""),
                    ("        if (ln_s != nullptr) stream_stats<kMaxNt == 1 ? 8 : 4, kCg>(x + (size_t)r0 * k, eps, norm, "
                     "rows, k, mean, inv);\n", ""),
                    ("      stream_stage_h<kGated ? 1 : 2, kCg>(x + (size_t)r0 * k, ln_s, ln_b, mean, inv, rows, k, nts, "
                     "hs * kSc,\n                                          (he - hs) * kSc, hf);\n", "")),
    "no_products": (("        if (live) {\n          const unsigned char* stage = my_ring",
                     "        if (false) {\n          const unsigned char* stage = my_ring"),),
    "no_loads": (("    if (p_item < walk) {\n      const int it", "    if (false) {\n      const int it"),),
    "no_split": (("    if (ks > 1) {  // this slice's partials", "    if (false) {  // this slice's partials"),),
}
STREAM_CASES = ("neox_qkv_bias", "llama_q_rms_int4", "head_V50434_int8", "mpt_mlp", "mpt_mlp_int4", "llama_swiglu_int4",
                "mpt_mlp_int4_B64", "llama_xattn_ff_K2_16384")


def stream_times(argv) -> int:
    """K1/K2's weight-streaming body as it is and as STREAM_VARIANTS at
    STREAM_CASES (k12_cases' shapes), each variant in turns, twice."""
    from chip_smoke import card_line, device_ms
    from open_flamingo_tpu_torch.ops import dense_stream

    names = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), list(STREAM_VARIANTS))
    libs = build_variants("dense_stream", {n: STREAM_VARIANTS[n] for n in names}, "stream", "rows_stream.cuh")
    libs = {name: dense_stream.bind(lib) for name, lib in libs.items()}
    dev = torch.device("cuda", 0)
    for kernel, case, fn, nbytes, flops, lib in k12_cases(dev):
        if case not in STREAM_CASES:
            continue
        row = {"profile": "stream_variants", "kernel": kernel, "case": case}
        for turn in (list(libs), list(libs)[::-1]):
            for name in turn:
                dense_stream._lib = libs[name]
                row.setdefault(f"{name}_ms", []).append(device_ms(fn))
        dense_stream._lib = None
        print(json.dumps(row), flush=True)
    print(card_line(), flush=True)
    return 0


def k36_cases(dev):
    """K3 and K6 at the shapes of PERF.md's kernel table (bf16 activations):
    K3's OF-3B self-attention (D 2,048, 16 heads of Dh 128, slot 40 of a
    64-slot cache, ALiBi, rows 0 and 1 left-padded) and gated block (8 heads
    of Dh 64 over 64 latents, LN bias, gate, row 3 before any image) at B 8
    and 64, each with bf16, int8 and int4 weights and int8 weights over the
    int8 cache; K6 at B 8 (slot 40 of 64) at OF-4B (D 2,560, 32 heads of Dh
    80, bias), LLaMA-7B (D 4,096, 32 of 128) and OPT-1.3B (D 2,048, 32 of
    64, bias and residual), the same four weight forms; K3 carrying K2b
    tiles (K2b-attn): a bf16 (2,112 x 1,024) x (1,024 x 1,024) q/k/v tile on
    the bf16 self and gated blocks at B 8, the pipe's W8A8 tile (16,896 rows)
    on the int4 blocks at B 64. Yields (kernel, case, call, bytes, flops,
    library call): the library call is F.linear for each product over the
    bf16 weights (and the tile's product: F.linear, or torch._int_mm on
    rows quantized untimed with the two scale multiplies)."""
    import torch.nn.functional as F

    from chip_smoke import left_padded_mask
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes, quantize_kv
    from open_flamingo_tpu_torch.models.layers import layer_norm
    from open_flamingo_tpu_torch.ops import w8a8
    from open_flamingo_tpu_torch.ops.decode_layer import attend_out_decode, attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import side_activations
    from open_flamingo_tpu_torch.quantize import pack_int4, quantize_weight

    dt, es = torch.bfloat16, 2
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    def stored(w, kind):      # (the weight as streamed, its scale, its bytes)
        if kind == "bf16":
            return w, None, w.numel() * es
        q, sc = quantize_weight(w.float(), 8 if kind == "int8" else 4)
        q = q if kind == "int8" else pack_int4(q)
        return q, sc, q.numel() + 4 * sc.numel()

    forms = (("", "bf16", False), ("_int8", "int8", False), ("_int4", "int4", False), ("_int8_kv8", "int8", True))
    d, s = 2048, 64
    ln, ln_b = 1 + rn(d, scale=0.1), rn(d, scale=0.1)
    gate = torch.tensor([0.5], device=dev, dtype=dt)
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    # K2b-attn's tiles: ViT-L/14's q/k/v slot (D 1,024, S_pad 264 rows an image), bf16 and W8A8
    vd, s_pad = 1024, 264
    w_side, s_ln, s_b = rn(vd, vd, scale=vd**-0.5), (1 + rn(vd, scale=0.1), rn(vd, scale=0.1)), rn(vd, scale=0.1)
    q_side, sc_side = quantize_weight(w_side.float(), 8)
    # K3 self-attention and gated block: (name, heads, Dh, fused)
    for name, h, dh, fused in (("self_S64_slot40", 16, 128, True), ("xattn_S64_gate", 8, 64, False)):
        inner = h * dh
        wq_f, wo_f = rn((3 if fused else 1) * inner, d, scale=d**-0.5), rn(d, inner, scale=inner**-0.5)
        weights = {kind: (stored(wq_f, kind), stored(wo_f, kind)) for kind in ("bf16", "int8", "int4")}
        for b, bsfx in ((8, ""), (64, "_B64")):
            x, a_in = rn(b, d), rn(b, inner)
            hn = layer_norm(x, ln, None if fused else ln_b)
            k0, v0 = rn(b, h, s, dh), rn(b, h, s, dh)
            (k8, ks8), (v8, vs8) = quantize_kv(k0.float()), quantize_kv(v0.float())
            if fused:
                mask = left_padded_mask(b, s, [4, 7], dev)
                mask[:, 41:] = False
                kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True, slopes=slopes16,
                          slot=torch.tensor([40], dtype=torch.int32, device=dev))
            else:
                mask = torch.ones(b, s, dtype=torch.bool, device=dev)
                mask[3] = False
                kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, gate=gate)
            n_valid = int(mask.sum())
            rows = n_valid + (b if fused else 0)         # cache rows read (and the slot's written)
            lib = lambda hn=hn, a_in=a_in, wq_f=wq_f, wo_f=wo_f: (F.linear(hn, wq_f), F.linear(a_in, wo_f))
            for sfx, kind, kv8 in forms:
                (wq, sq, byq), (wo, so, byo) = weights[kind]
                caches = (k8, v8, ks8, vs8) if kv8 else (k0, v0, None, None)
                lnb = None if fused else ln_b
                call = (lambda x=x, lnb=lnb, wq=wq, wo=wo, c=caches, mask=mask, kw=kw, sq=sq, so=so, **side:
                        attn_block_decode(x, ln, lnb, wq, wo, c[0], c[1], mask, wq_scale=sq, wout_scale=so,
                                          k_scale=c[2], v_scale=c[3], **kw, **side))
                nbytes = (byq + byo + (2 * b * d + d * (1 + (not fused)) + (not fused)) * es
                          + 2 * rows * h * (dh * (1 if kv8 else es) + 4 * kv8) + b * s + 4 * fused)
                flops = 2 * b * d * ((3 if fused else 1) * inner + inner) + 4 * h * dh * n_valid
                yield "attn_block_decode", f"{name}{sfx}{bsfx}", call, nbytes, flops, lib
                # the carriers: a bf16 tile on the bf16 block at B 8, the W8A8 tile on the int4 block at B 64
                if (b, kind, kv8) in ((8, "bf16", False), (64, "int4", False)):
                    m = b * s_pad
                    side_x = rn(m, vd, scale=2.0)
                    hs = side_activations(side_x, s_ln, 1e-5)
                    if b == 8:
                        side = dict(side_x=side_x, side_w=w_side, side_ln=s_ln, side_b=s_b)
                        tile_bytes = (2 * m * vd + 3 * vd + vd * vd) * es
                        hs_b = hs.to(dt)
                        tile_lib = lambda hs_b=hs_b: F.linear(hs_b, w_side)
                        tag = "side"
                    else:
                        side = dict(side_x=side_x, side_w=q_side, side_w_scale=sc_side, side_ln=s_ln, side_b=s_b)
                        tile_bytes = (2 * m * vd + 3 * vd) * es + vd * vd + 4 * vd
                        q_pre, s_pre = w8a8.quantize_activations(hs)
                        tile_lib = lambda q_pre=q_pre, s_pre=s_pre: (
                            torch._int_mm(q_pre, q_side.t()).float() * s_pre * sc_side)
                        tag = "side8_qkv"
                    tile_ops = 2 * m * vd * vd // (1 if b == 8 else 2)   # bf16-equivalent: int8 at twice the rate
                    yield ("attn_block_decode", f"{name}{sfx}{bsfx}_{tag}",
                           lambda call=call, side=side: call(**side), nbytes + tile_bytes, flops + tile_ops,
                           lambda lib=lib, tile_lib=tile_lib: (lib(), tile_lib()))
        del weights, wq_f, wo_f
    # K6: (name, D, heads, Dh, bias, residual)
    for name, dm, h, dh, with_bias, with_res in (("neox_S64_slot40", 2560, 32, 80, True, False),
                                                  ("llama_S64_slot40", 4096, 32, 128, False, False),
                                                  ("opt_S64_slot40", 2048, 32, 64, True, True)):
        b, inner = 8, h * dh
        wo_f = rn(dm, inner, scale=inner**-0.5)
        bias, res = (rn(dm, scale=0.1) if with_bias else None), (rn(b, dm) if with_res else None)
        q, kn, vn, a_in = rn(b, h, dh), rn(b, h, dh), rn(b, h, dh), rn(b, inner)
        k0, v0 = rn(b, h, s, dh), rn(b, h, s, dh)
        (k8, ks8), (v8, vs8) = quantize_kv(k0.float()), quantize_kv(v0.float())
        mask = left_padded_mask(b, s, [4, 7], dev)
        mask[:, 41:] = False
        n_valid = int(mask.sum())
        slot = torch.tensor([40], dtype=torch.int32, device=dev)
        lib = lambda a_in=a_in, wo_f=wo_f, bias=bias: F.linear(a_in, wo_f, bias)
        for sfx, kind, kv8 in forms:
            wo, so, byo = stored(wo_f, kind)
            c = (k8, v8, ks8, vs8) if kv8 else (k0, v0, None, None)
            call = (lambda q=q, c=c, mask=mask, wo=wo, so=so, kn=kn, vn=vn, bias=bias, res=res, slot=slot, dh=dh:
                    attend_out_decode(q, c[0], c[1], mask, wo, scale=dh**-0.5, k_new=kn, v_new=vn, slot=slot,
                                      wout_scale=so, bias=bias, residual=res, k_scale=c[2], v_scale=c[3]))
            nbytes = (byo + (b * inner + b * dm + 2 * b * inner + dm * with_bias + b * dm * with_res) * es
                      + 2 * n_valid * h * (dh * (1 if kv8 else es) + 4 * kv8) + b * s + 4)
            yield "attend_out_decode", f"{name}{sfx}", call, nbytes, 2 * b * dm * inner + 4 * h * dh * n_valid, lib
        del wo_f


class ParentDecodeLayer:
    """Another checkout's csrc/decode_layer.cu library from before its K3 and
    K6 projections took weight-streaming plans (the tensor-core row GEMV of
    rows_gemv.cuh) behind this tree's C interface: the wrappers' plan
    arguments are dropped on the way in. A checkout with the plans runs
    behind the interface as it is."""

    def __init__(self, lib):
        import ctypes

        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        side = [p, p, ll, p, p, p, f, i, p, p, ll, p, i, i, i, i]
        lib.attn_block_decode_fwd.argtypes = [p] * 18 + [i] * 9 + [f, f, f, i, p]
        lib.attend_out_decode_fwd.argtypes = [p] * 17 + [i] * 7 + [f, i, p]
        lib.attn_block_decode_side_fwd.argtypes = [p] * 18 + [i] * 9 + [f, f, f, i] + side + [p]
        self.lib = lib

    # this tree's K3 entries: 31 arguments, the 7 of the plans, then the rest; K6's: 26, then 5 of the plan
    def attn_block_decode_fwd(self, *a):
        return self.lib.attn_block_decode_fwd(*a[:31], *a[38:])

    def attn_block_decode_side_fwd(self, *a):
        return self.lib.attn_block_decode_side_fwd(*a[:31], *a[38:])

    def attend_out_decode_fwd(self, *a):
        return self.lib.attend_out_decode_fwd(*a[:26], *a[31:])


def k36_times(argv) -> int:
    """K3 and K6 at k36_cases' shapes through their wrappers, on this tree's
    csrc/decode_layer.cu and, with --parent=<csrc directory>, on another
    checkout's (ParentDecodeLayer), and with --variants=a,b on builds whose
    csrc/rows_stream.cuh has STREAM_VARIANTS' edits (a part of the body
    skipped: what it costs), all built here at once (build_variants) and
    timed in turns in this process (times_in_turns: change, parent, parent,
    change); each case with its bound, its library call's time and the
    largest difference of y from this tree's."""
    from chip_smoke import bound, card_line, device_ms
    from open_flamingo_tpu_torch.ops import decode_layer

    parent = next((a.split("=", 1)[1] for a in argv if a.startswith("--parent=")), None)
    names = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), [])
    built = build_variants("decode_layer", {n: STREAM_VARIANTS[n] for n in names}, "k36", "rows_stream.cuh",
                           trees={"parent": parent} if parent else None)
    # a parent whose C entries take no plans behind the adapter, a later one as it is
    old_parent = parent and "int slice1" not in (Path(parent) / "decode_layer.cu").read_text()
    libs = {name: ParentDecodeLayer(lib) if name == "parent" and old_parent else decode_layer.bind(lib)
            for name, lib in built.items()}
    dev = torch.device("cuda", 0)

    def cases():
        for kernel, case, fn, nbytes, flops, lib in k36_cases(dev):
            y = fn()
            buf = torch.empty_like(y[0] if isinstance(y, tuple) else y)

            def call(lib_, fn=fn, buf=buf):
                decode_layer._lib = lib_
                y = fn()
                if not torch.cuda.is_current_stream_capturing():   # the timed graph holds the launches alone
                    buf.copy_(y[0] if isinstance(y, tuple) else y)
                return 0
            b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
            yield kernel, case, [buf], {"": call}, {"bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(lib)}

    with torch.no_grad():
        times_in_turns(libs, cases(), "k36_bf16")
    decode_layer._lib = None
    print(card_line(), flush=True)
    return 0


class ParentDecodeAttention:
    """Another checkout's csrc/decode_attention.cu library from before K7
    took a split plan (one block per (b, h)) behind this tree's C
    interface: the plan's three arguments are dropped on the way in."""

    def __init__(self, lib):
        import ctypes

        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, i, p]
        lib.decode_attention_fwd.restype = i
        self.lib = lib

    def decode_attention_fwd(self, *a):
        return self.lib.decode_attention_fwd(*a[:15], a[-1])


# K7 split-plan variants: the constants of ops.decode_attention.decode_plan changed (the same library)
K7_PLAN_VARIANTS = {"splits4": {"DECODE_MAX_SPLITS": 4}, "ring64k": {"DECODE_RING_BYTES": 64 * 1024}}
# K7 source variants, edits of csrc/decode_attention.cu: the scores and P.V skipped (loads, waits, merges and
# stores alone); the tiles never loaded (the compute over whatever shared memory holds); blocks of 16 warps;
# tiles of 128 or 32 keys (with the plan in K7_SRC_PLANS); softmax in base e; the waits without their watchdog
K7_SRC_VARIANTS = {
    "warps16": (("constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),),
    "no_compute": (("      if (c < nv && gw + i * kGpw < kKpw) {\n        float kf[VE];",
                    "      if (false) {\n        float kf[VE];"),
                   ("      sc[i] = live ? dot", "      sc[i] = false ? dot")),
    "no_loads": (("  a.bulk = a.ld == d &&", "  a.bulk = 0 && a.ld == d &&"),
                 ("      for (int i = tid; i < tile_elems; i += kThreads) {", "      for (int i = tid; i < 0; i += kThreads) {")),
    "tile128": (("constexpr int kTile = 64;", "constexpr int kTile = 128;"),),
    "exp_e": (("constexpr float kLog2e = 1.4426950408889634f;", "constexpr float kLog2e = 1.0f;"),
              ("{ return exp2f(x); }", "{ return expf(x); }")),
    "tile32": (("constexpr int kTile = 64;", "constexpr int kTile = 32;"),),
    "no_watchdog": (("  if (clock64() - start > (1ll << 34)) __trap();", ""),),
}
# the plan a source variant's library runs under (its tile and ring), where it is not decode_plan's own
K7_SRC_PLANS = {"tile32": {"DECODE_TILE": 32, "DECODE_MIN_TILES": 4},
                "tile128": {"DECODE_TILE": 128, "DECODE_MIN_TILES": 1, "DECODE_RING_BYTES": 64 * 1024}}


class PlanVariant:
    """This tree's K7 library launched with the plan decode_plan gives
    under other constants."""

    def __init__(self, lib, consts):
        self.lib, self.consts = lib, consts

    def decode_attention_fwd(self, *a):
        from open_flamingo_tpu_torch.ops import decode_attention as k7

        saved = {name: getattr(k7, name) for name in self.consts}
        try:
            for name, value in self.consts.items():
                setattr(k7, name, value)
            k7.decode_plan.cache_clear()
            plan = k7.decode_plan(a[10], a[11], torch.bfloat16 if a[14] == 1 else torch.float32)
        finally:
            for name, value in saved.items():
                setattr(k7, name, value)
            k7.decode_plan.cache_clear()
        return self.lib.decode_attention_fwd(*a[:15], *plan, a[-1])


def k7_cases(dev):
    """chip_smoke.py's bf16 K7 cases at the unfused decode's shapes (OF-3B's
    xattn S64 and self slot 40, LLaMA-7B's and OPT-1.3B's self-attention)
    and at LLaMA-7B's S 2,048: (kernel, case, call, cost, library call)."""
    from chip_smoke import TIMED_CASES, k7_long_cases, of3b_k7_cases, self_attention_cases
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes

    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    for name, case, fn, _, _, cost, lib, _ in itertools.chain(
            of3b_k7_cases(rn, 2, dev, slopes16),
            self_attention_cases(rn, 2, dev, 32, 128, "prefill_llama", "llama_self_Dh128", "llama_self_S64_slot40"),
            self_attention_cases(rn, 2, dev, 32, 64, "prefill_opt", "opt_self_Dh64", "opt_self_S64_slot40"),
            k7_long_cases(dt, gen, dev)):
        if name.startswith("decode_attention") and case in TIMED_CASES:
            yield name, case, fn, cost, lib


def k7_times(argv) -> int:
    """K7 at k7_cases through its wrappers on this tree's
    csrc/decode_attention.cu, on another checkout's (--parent=<csrc
    directory>, ParentDecodeAttention), on K7_SRC_VARIANTS' builds and
    under K7_PLAN_VARIANTS (--variants=), built at once and timed in turns
    in this process."""
    from chip_smoke import bound, card_line, device_ms
    from open_flamingo_tpu_torch.ops import decode_attention as k7

    parent = next((a.split("=", 1)[1] for a in argv if a.startswith("--parent=")), None)
    names = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), [])
    built = build_variants("decode_attention", {n: K7_SRC_VARIANTS[n] for n in names if n in K7_SRC_VARIANTS}, "k7",
                           trees={"parent": parent} if parent else None)
    libs = {name: ParentDecodeAttention(lib) if name == "parent" else
            PlanVariant(k7.bind(lib), K7_SRC_PLANS[name]) if name in K7_SRC_PLANS else k7.bind(lib)
            for name, lib in built.items()}
    libs.update({name: PlanVariant(libs["as_is"], K7_PLAN_VARIANTS[name]) for name in names if name in K7_PLAN_VARIANTS})
    dev = torch.device("cuda", 0)

    def cases():
        for kernel, case, fn, cost, lib in k7_cases(dev):
            k7._lib = libs["as_is"]
            buf = torch.empty_like(fn())

            def call(lib_, fn=fn, buf=buf):
                k7._lib = lib_
                y = fn()
                if not torch.cuda.is_current_stream_capturing():   # the timed graph holds the launches alone
                    buf.copy_(y)
                return 0
            b_ms, b_by = bound(*cost, torch.bfloat16)
            yield kernel, case, [buf], {"": call}, {"bound_ms": b_ms, "bound_by": b_by,
                                                    "sdpa_ms": None if lib is None else device_ms(lib)}

    with torch.no_grad():
        times_in_turns(libs, cases(), "k7_bf16")
    k7._lib = None
    print(card_line(), flush=True)
    return 0


# K11 source variants, edits of csrc/fused_layer.cu (bf16): the layer stopped after phase 1, 2, 3 or 4 (each with
# the barrier after it and the next phase's first stages issued), so what each phase adds is the difference of
# two; each phase's first stages issued after its barrier, not before; the barriers after phases 1, 3 and 4
# doubled, with and without the stages in flight (what a barrier costs)
_K11_STOP = "  rows::cp_wait<0>();\n  return;\n"
_K11_NO_PREFETCH = ("constexpr bool kPrefetch = true;", "constexpr bool kPrefetch = false;")
_K11_TWO_BARRIERS = ("  grid.sync();\n  if (deferred<W, kMaxNt>(a.plan[", "  grid.sync();\n  grid.sync();\n"
                     "  if (deferred<W, kMaxNt>(a.plan[")
# the phase trace: each block's %globaltimer at the phases' bounds (`k11_marks_read` reads them); the phases
# inlined into the kernel, not functions of their own
_K11_MARK = ("__device__ unsigned long long k11_marks[1024 * 16];\n"
             "__device__ __forceinline__ void mark(int i) {\n"
             "  unsigned long long t;\n"
             "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
             "  if (threadIdx.x == 0) k11_marks[blockIdx.x * 16 + i] = t;\n}\n")
K11_TRACE = (("using bf16 = __nv_bfloat16;\n", "using bf16 = __nv_bfloat16;\n" + _K11_MARK),
             ("  stream_phase<1, W, kAct, kGated, kMaxNt>(a);\n  grid.sync();\n",
              "  mark(0);\n  stream_phase<1, W, kAct, kGated, kMaxNt>(a);\n  mark(1);\n  grid.sync();\n  mark(2);\n"),
             ("  attend_phase(a, rows::Geometry<kMaxNt, false>::kRingBytes);\n  grid.sync();\n",
              "  mark(3);\n  attend_phase(a, rows::Geometry<kMaxNt, false>::kRingBytes);\n  mark(4);\n  grid.sync();\n"
              "  mark(5);\n"),
             ("  stream_phase<3, W, kAct, kGated, kMaxNt>(a);\n  grid.sync();\n",
              "  stream_phase<3, W, kAct, kGated, kMaxNt>(a);\n  mark(6);\n  grid.sync();\n  mark(7);\n"),
             ("  stream_phase<4, W, kAct, kGated, kMaxNt>(a);\n  grid.sync();\n",
              "  stream_phase<4, W, kAct, kGated, kMaxNt>(a);\n  mark(8);\n  grid.sync();\n  mark(9);\n"),
             ("  stream_phase<5, W, kAct, kGated, kMaxNt>(a);\n", "  stream_phase<5, W, kAct, kGated, kMaxNt>(a);\n  mark(10);\n"),
             ("}  // namespace\n", "}  // namespace\n\nextern \"C\" int k11_marks_read(void* dst) {  // and clear them\n"
              "  void* p = nullptr;\n  cudaError_t e = cudaGetSymbolAddress(&p, k11_marks);\n"
              "  if (e == cudaSuccess) e = cudaMemcpy(dst, p, sizeof(k11_marks), cudaMemcpyDeviceToHost);\n"
              "  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(k11_marks));\n  return (int)e;\n}\n"))
K11_MARKS = ("start", "projection", "barrier 1", "reduce 1", "attend", "barrier 2", "out-projection", "barrier 3",
             "up", "barrier 4", "down")
_K11_INLINE = (("__device__ __noinline__ void attend_phase(", "__device__ __forceinline__ void attend_phase("),
               ("__device__ __noinline__ void stream_phase(", "__device__ __forceinline__ void stream_phase("))
K11_VARIANTS = {
    "trace": K11_TRACE,
    "inline": _K11_INLINE,
    "stop1": (("  // 2. the attend;", _K11_STOP + "  // 2. the attend;"),),
    "stop2": (("  // 3. the out-projection", _K11_STOP + "  // 3. the out-projection"),),
    "stop3": (("  // 4. the hidden activation", _K11_STOP + "  // 4. the hidden activation"),),
    "stop4": (("  // 5. y = x2 + tanh(gate2) * down", _K11_STOP + "  // 5. y = x2 + tanh(gate2) * down"),),
    "no_prefetch": (_K11_NO_PREFETCH,),
    "two_barriers": (_K11_TWO_BARRIERS,),
    "no_prefetch_two_barriers": (_K11_NO_PREFETCH, _K11_TWO_BARRIERS),
}
K11_BATCHES = (1, 8, 13, 72)


class ParentFusedLayer:
    """Another checkout's csrc/fused_layer.cu library from before K11's
    phases 1 and 3 took K3's plans (its tensor-core body; K2's phases on
    their plans, at most 64 rows in bf16) behind this tree's C interface:
    the plans of phases 1 and 3 are dropped on the way in."""

    def __init__(self, lib):
        import ctypes

        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_layer_decode_fwd.argtypes = [p] * 29 + [i] * 10 + [f, f, f] + [i] * 4 + [p, p, i] + [i, p]
        lib.fused_layer_decode_fwd.restype = i
        self.lib = lib

    # this tree's entry: 42 arguments, the 4 of phases 1 and 3's plans, then the rest as the parent's
    def fused_layer_decode_fwd(self, *a):
        return self.lib.fused_layer_decode_fwd(*a[:42], *a[46:])


def k11_cases(dev):
    """K11 at chip_smoke.py's LAYER_TIMED layers (OF-3B's MPT-1B layer and
    gated xattn block, MPT-7B's layer; chip_smoke's layer_kernel_cases
    operands) with bf16, int8 and int4 weights, each at B 1, 8, 13 and 72:
    (case, B, the K11 call, the K3 + K2 route's call, bytes, flops)."""
    from chip_smoke import left_padded_mask, qweight
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
    from open_flamingo_tpu_torch.ops.decode_layer import attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import fused_mlp
    from open_flamingo_tpu_torch.ops.fused_layer import fused_layer_decode

    dt, es, s, slot = torch.bfloat16, 2, 64, 40
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    for case, dm, h, dh, k2, mpt in (("mpt_layer_S64_slot40", 2048, 16, 128, 8192, True),
                                     ("xattn_layer_S64", 2048, 8, 64, 8192, False),
                                     ("mpt7b_layer_S64_slot40", 4096, 32, 128, 16384, True)):
        inner = h * dh
        wf = dict(wq=rn((3 if mpt else 1) * inner, dm, scale=dm**-0.5), wout=rn(dm, inner, scale=inner**-0.5),
                  w1=rn(k2, dm, scale=dm**-0.5), w2=rn(dm, k2, scale=k2**-0.5))
        ln1, ln2 = 1 + rn(dm, scale=0.1), 1 + rn(dm, scale=0.1)
        ln1_b, ln2_b = (None, None) if mpt else (rn(dm, scale=0.1), rn(dm, scale=0.1))
        for bits in (None, 8, 4):
            if bits is None:
                ws, scales, wbytes = wf, {}, sum(w.numel() for w in wf.values()) * es
            else:
                stored = {name: qweight(w, bits) for name, w in wf.items()}
                ws = {name: q for name, (q, _, _) in stored.items()}
                scales = {f"{name}_scale": sc for name, (_, sc, _) in stored.items()}
                wbytes = sum(n for _, _, n in stored.values())
            for b in K11_BATCHES:
                x = rn(b, dm)
                kc, vc = rn(b, h, s, dh), rn(b, h, s, dh)
                kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=mpt, **scales)
                if mpt:
                    mask = left_padded_mask(b, s, [4, 7][:b], dev)
                    mask[:, slot + 1:] = False
                    kw.update(slot=torch.tensor([slot], dtype=torch.int32, device=dev),
                              slopes=torch.from_numpy(alibi_slopes(h)).to(dev))
                else:
                    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
                    mask[3 % b] = False
                    kw.update(gate=torch.tensor([0.5], device=dev, dtype=dt),
                              gate2=torch.tensor([-0.3], device=dev, dtype=dt))
                attn_kw = {k: v for k, v in kw.items() if k not in ("gate2", "w1_scale", "w2_scale")}
                mlp_kw = dict(ln_scale=ln2, ln_bias=ln2_b, gate=kw.get("gate2"), w1_scale=scales.get("w1_scale"),
                              w2_scale=scales.get("w2_scale"))

                def k11(x=x, ws=ws, kw=kw, kc=kc, vc=vc, mask=mask):
                    out = fused_layer_decode(x, ln1, ln1_b, ws["wq"], ws["wout"], kc, vc, mask, ws["w1"], ws["w2"],
                                             ln2, ln2_b, **kw)
                    return out[0] if mpt else out

                def two_launch(x=x, ws=ws, attn_kw=attn_kw, mlp_kw=mlp_kw, kc=kc, vc=vc, mask=mask):
                    x2 = attn_block_decode(x, ln1, ln1_b, ws["wq"], ws["wout"], kc, vc, mask, **attn_kw)
                    x2 = x2[0] if mpt else x2
                    return fused_mlp(x2, ws["w1"], ws["w2"], residual=x2, **mlp_kw)

                n_valid = mask.sum().item()
                vecs = (2 + 2 * (not mpt)) * dm + 2 * (not mpt)
                nbytes = wbytes + (2 * b * dm + vecs + 2 * n_valid * inner + 2 * mpt * b * inner) * es + b * s
                flops = 2 * b * ((3 if mpt else 1) * inner * dm + dm * inner + 2 * k2 * dm) + 4 * inner * n_valid
                sfx = {None: "", 8: "_int8", 4: "_int4"}[bits]
                yield f"{case}{sfx}_B{b}", b, k11, two_launch, nbytes, flops


def k11_times(argv) -> int:
    """K11 at k11_cases through its wrapper on this tree's
    csrc/fused_layer.cu, on another checkout's (--parent=<csrc directory>,
    ParentFusedLayer; at B <= 64, the most it takes in bf16) and on
    K11_VARIANTS' builds (--variants=), all built here at once and timed in
    turns in this process (times_in_turns: change, parent, variants, then
    back); each case with its bound and the K3 + K2 route's time on the same
    inputs (`k3_k2_ms`)."""
    import ctypes

    from chip_smoke import bound, card_line, device_ms
    from open_flamingo_tpu_torch.ops import fused_layer

    parent = next((a.split("=", 1)[1] for a in argv if a.startswith("--parent=")), None)
    names = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), [])
    built = build_variants("fused_layer", {n: K11_VARIANTS[n] for n in names}, "k11",
                           trees={"parent": parent} if parent else None)
    fused_layer._lib = None
    fused_layer._kernel()     # this tree's argument types, then each library behind them
    argtypes = fused_layer._lib.fused_layer_decode_fwd.argtypes
    libs = {}
    for name, lib in built.items():
        if name == "parent":
            libs[name] = ParentFusedLayer(lib)
        else:
            lib.fused_layer_decode_fwd.argtypes = argtypes
            lib.fused_layer_decode_fwd.restype = ctypes.c_int
            libs[name] = lib
    for name in built:
        if name.startswith("trace"):
            built[name].k11_marks_read.argtypes = [ctypes.c_void_p]
            built[name].k11_marks_read.restype = ctypes.c_int
    dev = torch.device("cuda", 0)

    def phase_trace(fn, name):
        """One call on a trace build: per phase bound, when the first and the
        last block passed it, us from the first block's start."""
        import numpy as np

        fused_layer._lib = libs[name]
        marks = np.zeros((1024, 16), np.uint64)
        for call in (False, True):   # clear what earlier calls left, then one call's marks
            if call:
                fn()
            torch.cuda.synchronize()
            if built[name].k11_marks_read(ctypes.c_void_p(marks.ctypes.data)) != 0:
                raise RuntimeError("k11: the phase marks could not be read")
        t = marks[marks[:, 0] > 0, :len(K11_MARKS)].astype(np.float64)
        t = t[:, [i for i in range(len(K11_MARKS)) if t[:, i].min() > 0]]
        names = [n for i, n in enumerate(K11_MARKS) if marks[marks[:, 0] > 0, i].min() > 0]
        rel = (t - t[:, :1].min()) / 1e3
        return {"blocks": int(t.shape[0]), "last_block_us": dict(zip(names, rel.max(0).round(3).tolist())),
                "first_block_us": dict(zip(names, rel.min(0).round(3).tolist()))}

    def cases(batches):
        for case, b, fn, two_launch, nbytes, flops in k11_cases(dev):
            if b not in batches:
                continue
            extra = {name: phase_trace(fn, name) for name in libs if name.startswith("trace")}
            fused_layer._lib = libs["as_is"]
            buf = torch.empty_like(fn())

            def call(lib_, fn=fn, buf=buf):
                fused_layer._lib = lib_
                y = fn()
                if not torch.cuda.is_current_stream_capturing():   # the timed graph holds the launches alone
                    buf.copy_(y)
                return 0
            b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
            yield "fused_layer_decode", case, [buf], {"": call}, {"bound_ms": b_ms, "bound_by": b_by,
                                                                  "k3_k2_ms": device_ms(two_launch), **extra}

    with torch.no_grad():
        times_in_turns(libs, cases({b for b in K11_BATCHES if b <= 64}), "k11_bf16")
        libs.pop("parent", None)   # the parent refuses more than 64 rows in bf16
        times_in_turns(libs, cases({b for b in K11_BATCHES if b > 64}), "k11_bf16")
    fused_layer._lib = None
    print(card_line(), flush=True)
    return 0


def k45_times() -> int:
    import ctypes

    from chip_smoke import B, T_M, card_line, left_padded_mask
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes

    libs = build_variants("prefill_attention", K45_VARIANTS, "k45")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.flash_attention_fwd.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, i, p]
        lib.masked_xattn_fwd.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, i, p]

    dev, dt = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dt)
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    cases = []
    # K4: MPT self-attention (16 heads of Dh 128, ALiBi), causal from q_offset 0
    for case, b, tq, s, pads in (("prefill_S64", B, 32, 64, [4, 7]), ("train_laion_T32", B, 32, 32, []),
                                 ("train_mmc4_T256", 4, T_M, T_M, []), ("ragged_S257", 2, 257, 257, [0, 257])):
        bh, d = b * 16, 128
        q, k, v = rn(bh, tq, d), rn(bh, s, d), rn(bh, s, d)
        valid = left_padded_mask(b, s, pads, dev)
        valid[:, tq:] = False
        pad = valid.repeat_interleave(16, 0).view(torch.uint8)
        sl, out = slopes16.repeat(b)[:, None].contiguous(), torch.empty_like(q)
        cases.append(("flash_attention", case, [out], {"": lambda lib, q=q, k=k, v=v, pad=pad, sl=sl, out=out, bh=bh,
                                                        tq=tq, s=s:
                      lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), sl.data_ptr(),
                                              out.data_ptr(), None, bh, tq, s, 128, 0, 1, 128**-0.5, 1, stream())}))
    # K5: gated xattn (8 heads of Dh 64, 64 latents an image)
    for case, b, tq, media in (("prefill_T1", B, 32, [0]), ("train_mmc4_T256", 4, T_M, [3 + 42 * j for j in range(6)])):
        bh, d, s = b * 8, 64, 64 * len(media)
        q, k, v = rn(bh, tq, d), rn(bh, s, d), rn(bh, s, d)
        tt = media_text_time(b, tq, media, dev)
        out = torch.empty_like(q)
        cases.append(("masked_xattn", case, [out], {"": lambda lib, q=q, k=k, v=v, tt=tt, out=out, bh=bh, tq=tq, s=s:
                      lib.masked_xattn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(), out.data_ptr(),
                                           None, bh, tq, s, 64, 64, 64**-0.5, 1, stream())}))
    times_in_turns(libs, cases, "k45_variants_bf16")
    print(card_line(), flush=True)
    return 0


def media_text_time(b, tq, media, dev):
    """(B * 8, Tq) int32: a new image at each of the positions `media`, every
    row the same, each batch row's 8 heads."""
    loc = torch.zeros(b, tq, dtype=torch.int32, device=dev)
    loc[:, media] = 1
    return torch.cumsum(loc, 1).to(torch.int32).repeat_interleave(8, 0).contiguous()


def k45b_times() -> int:
    """K4b/K5b's bf16 body against variants of csrc/attention_backward.cu at
    the train step's shapes: the dq and the dkv launch timed apart, from the
    forward kernel's out and lse."""
    import ctypes

    from chip_smoke import B_L, B_M, N_IMG, T_L, T_M, card_line
    from open_flamingo_tpu_torch.models.decoders.common import alibi_slopes
    from open_flamingo_tpu_torch.ops.flash_attention import flash_attention_forward
    from open_flamingo_tpu_torch.ops.masked_xattn import masked_xattn_forward

    libs = build_variants("attention_backward", K45B_VARIANTS, "k45b")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        for part in ("dq", "dkv"):
            getattr(lib, f"flash_attention_bwd_{part}").argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
            getattr(lib, f"masked_xattn_bwd_{part}").argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, p]

    dev, dt = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dt)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptr = lambda ts: [t.data_ptr() for t in ts]     # the operands live on as the calls' default arguments
    cases = []
    # K4b: MPT self-attention (16 heads of Dh 128, ALiBi), causal, no padding
    for case, b, t in (("laion_T32", B_L, T_L), ("mmc4_T256", B_M, T_M)):
        bh, d = b * 16, 128
        q, k, v, do = rn(bh, t, d), rn(bh, t, d), rn(bh, t, d), rn(bh, t, d)
        pad = torch.ones(bh, t, dtype=torch.uint8, device=dev)
        sl = torch.from_numpy(alibi_slopes(16)).to(dev).repeat(b)[:, None].contiguous()
        out, lse = flash_attention_forward(q, k, v, pad, sl, 0, True, d**-0.5, with_lse=True)
        delta, dq, dk, dv = torch.empty_like(lse), torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        args = (bh, t, t, d, 0, 1, d**-0.5, 1)
        cases.append(("flash_attention_backward", case, [dq, dk, dv], {
            "dq": lambda lib, a=(q, k, v, pad, sl, out, do, lse, delta, dq), args=args:
                lib.flash_attention_bwd_dq(*ptr(a), *args, stream()),
            "dkv": lambda lib, a=(q, k, v, pad, sl, do, lse, delta, dk, dv), args=args:
                lib.flash_attention_bwd_dkv(*ptr(a), *args, stream())}))
    # K5b: gated xattn (8 heads of Dh 64, 64 latents an image)
    for case, b, tq, media in (("laion_T32", B_L, T_L, [0]), ("mmc4_T256", B_M, T_M, [3 + 42 * j for j in range(N_IMG)])):
        bh, d, s = b * 8, 64, 64 * len(media)
        q, k, v, do = rn(bh, tq, d), rn(bh, s, d), rn(bh, s, d), rn(bh, tq, d)
        tt = media_text_time(b, tq, media, dev)
        out, lse = masked_xattn_forward(q, k, v, tt, 64, d**-0.5, with_lse=True)
        delta, dq, dk, dv = torch.empty_like(lse), torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        args = (bh, tq, s, d, 64, d**-0.5, 1)
        cases.append(("masked_xattn_backward", case, [dq, dk, dv], {
            "dq": lambda lib, a=(q, k, v, tt, out, do, lse, delta, dq), args=args:
                lib.masked_xattn_bwd_dq(*ptr(a), *args, stream()),
            "dkv": lambda lib, a=(q, k, v, tt, do, lse, delta, dk, dv), args=args:
                lib.masked_xattn_bwd_dkv(*ptr(a), *args, stream())}))
    times_in_turns(libs, cases, "k45b_variants_bf16")
    print(card_line(), flush=True)
    return 0


def vit_times() -> int:
    import contextlib
    import os

    from chip_smoke import B, VIT_L_14, bound, card_line, device_ms, vit_kernel_cases, vit_model, vit_plain_route

    dev, dt = torch.device("cuda", 0), torch.bfloat16
    tree = os.path.basename(os.getcwd())
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, case, fn, _, _, cost, _, _ in vit_kernel_cases(dt, gen, dev):
        if case in ("vitl14_B8", "vitl14_B32"):
            b_ms, b_by = bound(*cost, dt)
            print(json.dumps({"profile": "vit_kernel_bf16", "tree": tree, "kernel": name, "case": case,
                              "ms": device_ms(fn), "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    vit = vit_model(dev, dt)
    px = VIT_L_14.image_size
    kinds = (("K9 vit_attention", ("vit_attn",)), ("K10 layer_norm", ("layer_norm_kernel",)),
             ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "splitK")), ("softmax", ("softmax",)),
             ("copy", ("copy", "Memcpy", "Memset")), ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
    with torch.no_grad():
        for b in (B, 32):
            pixels = torch.randn(b, px, px, 3, generator=gen, device=dev)
            times = {"kernels": [], "plain": []}
            for route in ("kernels", "plain", "plain", "kernels"):
                with vit_plain_route() if route == "plain" else contextlib.nullcontext():
                    times[route].append(device_ms(lambda: vit(pixels), reps=2, rounds=5))
            row = {"profile": "vit_forward_bf16", "tree": tree, "batch": b, "runs_ms": times}
            if b == B:
                for route in ("kernels", "plain"):
                    with vit_plain_route() if route == "plain" else contextlib.nullcontext():
                        row[f"trace_{route}"] = device_time_by_kind(lambda: vit(pixels), kinds)
            print(json.dumps(row), flush=True)
    print(card_line(), flush=True)
    return 0


# K9/K8 bf16 variants, edits of csrc/vit_attention.cu: the softmax skipped (P zeros: loads, products and
# stores), the products skipped (loads, softmax over zeros and stores), both (loads and stores alone)
_VIT_SOFTMAX = ("      if (t * kQRows + wi * 16 < p.s_q) {", "      if (false) {")
_VIT_PRODUCTS = tuple((f"wgmma_rs_bf16<{n}>(", f"if (false) wgmma_rs_bf16<{n}>(") for n in ("64, 0", "16, 0", "D, 1"))
VIT_VARIANTS = {"no_softmax": (_VIT_SOFTMAX,), "no_products": _VIT_PRODUCTS, "loads_stores": (_VIT_SOFTMAX, *_VIT_PRODUCTS)}


def vit_ab_times(argv) -> int:
    """K9 and K8 (bf16) through their wrappers on this tree's
    csrc/vit_attention.cu and on another checkout's (--parent=<csrc
    directory>), built at once and timed in turns in this process; then
    the ViT-L/14 forward on each, device time by kind."""
    import contextlib
    import itertools

    from chip_smoke import (B, VIT_L_14, absorb_kernel_cases, bound, card_line, device_ms, vit_kernel_cases,
                            vit_model, vit_plain_route)
    from open_flamingo_tpu_torch.ops import vit_attention as vit_op

    parent = next(a.split("=", 1)[1] for a in argv if a.startswith("--parent="))
    names = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--variants=")), [])
    built = build_variants("vit_attention", {n: VIT_VARIANTS[n] for n in names}, "vit", trees={"parent": parent})
    libs = {name: vit_op.bind(lib) for name, lib in built.items()}
    dev, dt = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = {"vitl14_B8", "vitl14_B32", "S17", "of3b_next_B8", "of3b_next_B32", "of3b_next_B64"}

    def cases():
        for name, case, fn, _, _, cost, lib, _ in itertools.chain(vit_kernel_cases(dt, gen, dev),
                                                                  absorb_kernel_cases(dt, gen, dev)):
            if name == "fused_mlp":          # absorb_kernel_cases' K2b cases follow its K8 cases
                break
            if case not in timed or name not in ("vit_attention", "flat_vit_attention"):
                continue
            buf = torch.empty_like(fn())

            def call(lib_, fn=fn, buf=buf):
                vit_op._lib = lib_
                y = fn()
                if not torch.cuda.is_current_stream_capturing():   # the timed graph holds the launches alone
                    buf.copy_(y)
                return 0
            b_ms, b_by = bound(*cost, dt)
            yield name, case, [buf], {"": call}, {"bound_ms": b_ms, "bound_by": b_by, "sdpa_ms": device_ms(lib)}

    with torch.no_grad():
        times_in_turns(libs, cases(), "vit_bf16")
        vit = vit_model(dev, dt)
        px = VIT_L_14.image_size
        kinds = (("K9 vit_attention", ("vit_attn",)), ("K10 layer_norm", ("layer_norm_kernel",)),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "splitK")), ("softmax", ("softmax",)),
                 ("copy", ("copy", "Memcpy", "Memset")), ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
        for b in (B, 32):
            pixels = torch.randn(b, px, px, 3, generator=gen, device=dev)
            row = {"profile": "vit_forward_ab_bf16", "batch": b}
            for route in ("as_is", "parent", "plain", "plain", "parent", "as_is"):   # the variants' forwards are not run
                vit_op._lib = libs.get(route)
                with vit_plain_route() if route == "plain" else contextlib.nullcontext():
                    row.setdefault(f"{route}_ms", []).append(device_ms(lambda: vit(pixels), reps=2, rounds=5))
            for name in ("as_is", "parent"):
                vit_op._lib = libs[name]
                row[f"trace_{name}"] = device_time_by_kind(lambda: vit(pixels), kinds)
            print(json.dumps(row), flush=True)
    vit_op._lib = None
    print(card_line(), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["side_compare"]:     # saved outputs only: no card needed
        return side_compare(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["gemv"]:
        return gemv_times()
    if sys.argv[1:] == ["vit"]:
        return vit_times()
    if sys.argv[1:2] == ["vit"]:
        return vit_ab_times(sys.argv[2:])
    if sys.argv[1:] == ["k2"]:
        return k2_times()
    if sys.argv[1:] == ["k45"]:
        return k45_times()
    if sys.argv[1:2] == ["k36"]:
        return k36_times(sys.argv[2:])
    if sys.argv[1:2] == ["k7"]:
        return k7_times(sys.argv[2:])
    if sys.argv[1:2] == ["k11"]:
        return k11_times(sys.argv[2:])
    if sys.argv[1:] == ["k45b"]:
        return k45b_times()
    if sys.argv[1:] == ["absorb"]:
        return absorb_times()
    if sys.argv[1:2] == ["side"]:
        return side_times(sys.argv[2:])
    if sys.argv[1:2] == ["stream"]:
        return stream_times(sys.argv[2:])
    if sys.argv[1:2] == ["wall"]:
        return wall_times(sys.argv[2:])
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (B, LAYER_FORMS, NEW_TOKENS, T_PROMPT, TRAIN_PAD, build_model, card_line,
                            kernel_functions, make_inputs, model_config, train_batches)
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate, prefill
    from open_flamingo_tpu_torch.models.flamingo import count_media
    from open_flamingo_tpu_torch.ops import dense_stream, fused_layer
    from open_flamingo_tpu_torch.quantize import quantize_decode_weights
    from open_flamingo_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer, split_params
    from open_flamingo_tpu_torch.train.train_loop import TrainLoopConfig, TrainState, make_train_step

    mode = sys.argv[1] if len(sys.argv) > 1 else "fused"
    models = {"of4b": "OF-4B", "llama": "LLaMA-7B", "opt": "OPT-1.3B"}
    if mode not in ("fused", "unfused", "train", "int8", "int4", *LAYER_FORMS, *models):
        print(f"chip_profile: unknown mode {mode!r}", file=sys.stderr)
        return 2
    dense_stream.DISABLE_FUSED = mode == "unfused"
    if mode in LAYER_FORMS:
        hook, value = LAYER_FORMS[mode]
        setattr(fused_layer, hook, value)
    dev = torch.device("cuda", 0)
    cfg = model_config(models.get(mode, "OF-3B"))
    model = build_model(cfg, dev, torch.bfloat16)
    if mode in ("int8", "int4"):
        quantize_decode_weights(model, 8 if mode == "int8" else 4)
    if mode == "train":
        trainable, _ = split_params(model)
        tx = make_optimizer(OptimizerConfig(warmup_steps=0), media_token_id=cfg.media_token_id,
                            eoc_token_id=cfg.eoc_token_id)
        step = make_train_step(model, tx, TrainLoopConfig(pad_token_id=TRAIN_PAD))
        state = [TrainState.create(trainable, tx)]
        bl, bm = train_batches(cfg, dev)
        shape = {"tokens_per_step": bl["input_ids"].numel() + bm["input_ids"].numel(),
                 "images_per_step": bl["vision_x"].shape[:2].numel() + bm["vision_x"].shape[:2].numel()}

        def run():
            state[0], _ = step(state[0], bl, bm)
    else:
        vision_x, ids, mask = make_inputs(cfg, dev)
        gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0, int8_kv=mode == "int8")
        shape = {"batch": B, "new_tokens": NEW_TOKENS, "int8_kv": gcfg.int8_kv}

        def run():
            flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
    run()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_untraced = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # key_averages() holds both the aten ops and the device events they
    # launch, each op row carrying its kernels' time again: sum the device
    # events (kernels, copies, memsets) alone
    avgs = prof.key_averages()
    rows = [
        (e.key, e.self_device_time_total / 1e6, e.count)
        for e in avgs
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(r[1] for r in rows)
    op_rows_s = sum(e.self_device_time_total for e in avgs if e.device_type == DeviceType.CPU) / 1e6
    if busy <= 0:
        raise RuntimeError("the trace holds no device events")
    rows.sort(key=lambda r: -r[1])
    # device symbols of the hand-written kernels: the row GEMV (gemv_kernel
    # on CUDA cores) serves fp32 K1, K2, K3 and K6, gemv_stream_kernel (past
    # 8 rows with a split K also gemv_stream_reduce_kernel) their bf16
    # projections, gemv_stream_side_kernel the bf16 K2 and K3 carriers
    # (gemv_symbols lists each instance that ran); K3's softmax
    # is attend_kernel, K6's attend_out_kernel; K4 and K5 share attention_fwd_mma in bf16 (tensor
    # cores) and attention_fwd_kernel in fp32, K4b and K5b the two backward
    # kernels (attention_bwd_dq_mma / _dkv_mma in bf16, attention_bwd_dq_kernel
    # / _dkv_kernel in fp32). The quantized variants are template cases of the same
    # symbols: the row GEMV over int8 weights names `signed char` among its
    # template arguments, over packed int4 `Int4` (split out below)
    ported = {kern: sum(r[1] for r in rows if kern in r[0])
              for kern in ("gemv", "attend_kernel", "attend_out_kernel", "attention_fwd_mma", "attention_fwd_kernel",
                           "decode_split_kernel", "attention_bwd_dq", "attention_bwd_dkv", "fused_layer_kernel")}
    gemv_by_weight = {"float": 0.0, "int8": 0.0, "int4": 0.0}
    for name, t, _ in rows:
        m = re.search(r"gemv\w*<(.*?)>\(", name)     # the template arguments
        if m:
            args = m.group(1)
            gemv_by_weight["int4" if "Int4" in args else "int8" if "signed char" in args else "float"] += t
    launches = {name: fn.launches for name, fn in kernel_functions().items()}
    # device time by kind of kernel, first match wins
    kinds = (("ported", ported), ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "splitK")),
             ("optimizer_foreach", ("multi_tensor_apply",)), ("copy", ("copy", "Memcpy", "Memset")),
             ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
    by_kind = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for name, t, _ in rows:
        kind = next((kind for kind, keys in kinds if any(key in name for key in keys)), "other")
        by_kind[kind] += t
    step = None
    if mode in ("fused", *LAYER_FORMS):    # one decode step alone: its device events and busy time
        with torch.no_grad():
            lat = model.embed_vision(vision_x)
            logits, cache = prefill(model, lat, ids, mask, T_PROMPT + NEW_TOKENS)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            n_media = count_media(ids, cfg.media_token_id)
            ones = torch.ones(B, 1, dtype=torch.long, device=dev)
            model.decode_step(lat, tok, ones, cache, n_media)
            torch.cuda.synchronize()
            step = device_time_by_kind(lambda: model.decode_step(lat, tok, ones, cache, n_media),
                                       (("K11 fused_layer_kernel", ("fused_layer_kernel",)), ("row GEMV", ("gemv",)),
                                        ("K3 attend", ("attend_kernel",)), ("copy", ("copy", "Memcpy", "Memset")),
                                        ("elementwise", ("elementwise",))))
    print(json.dumps({
        "profile": "train_step_bf16" if mode == "train" else "generate_bf16", "mode": mode, "model": cfg.lm.family,
        "decode_step": step,
        **shape,
        "wrapper_launches_since_start": launches,
        "wall_s_untraced": wall_untraced, "wall_s_traced": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall, "device_idle_share_untraced": 1.0 - busy / wall_untraced,
        "aten_op_rows_device_s": op_rows_s,
        "ported_kernel_device_s": ported, "gemv_share_of_busy": ported["gemv"] / busy,
        "gemv_device_s_by_weight": gemv_by_weight, "gemv_symbols": gemv_symbols(rows), "device_s_by_kind": by_kind,
        "device_events": sum(r[2] for r in rows),
        "top": [{"name": k[:80], "device_s": s, "count": n} for k, s, n in rows[:12]],
    }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
