#!/usr/bin/env python3
"""Drive the PyTorch port (open_flamingo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines:
  1. build    compile every kernel under open_flamingo_tpu_torch/csrc with
              nvcc (sm_90a), one process per source, all at once; count the
              HMMA instructions of each K4/K5 and K4b/K5b kernel in their
              libraries' SASS (`cuobjdump --dump-sass`): each of the 12
              instances of a tensor-core kernel has some, the FMA bodies
              none; K1/K2's and K3/K6's weight-streaming instances all
              have some, and no bf16 instance of the old row-GEMV bodies
              is left in dense_stream or decode_layer; K9/K8's six bf16
              instances issue HGMMA, UTMALDG and UTMASTG, and no HMMA is
              left in vit_attention; each of K7's 11 split-kernel
              instances issues the bulk copy (UBLKCP); each of K11's 18
              bf16 instances HMMA (every phase on the weight-streaming
              body), its 9 fp32 ones none;
  2. kernels  each kernel of the generate path against its plain PyTorch
              version on the same card tensors, in fp32 and bf16, at
              OF-3B's shapes (B = 8) and edge cases: K1 fused_dense (final
              LN + tied vocab head, ragged vocabulary tail), K2 fused_mlp
              (MPT MLP, xattn FF with ff_gate), K3 attn_block_decode (self
              with the in-place slot write at slots 40 and 63, gated xattn
              with a row before any image), K4 flash_attention (prefill
              S64, after a 16-token prefix, ragged S 257), K5 masked_xattn
              (one and two images), K7 decode_attention and _update (and,
              after the other cases, K7 at LLaMA-7B's S 2,048, B 1 and 8,
              both entry points, each call reading the next of several cache
              copies, out of the L2; NaN in every masked K/V row, the
              output finite and the bits of the output over zeroed rows:
              `k7_long_cases`). Times
              the kernel (CUDA-graph replay), one eager call, the plain
              version, and the library call named beside it; K4 and K5 in
              bf16 also on the CUDA-core FMA body their tensor-core body
              replaced (`flash_attention_fma`, `masked_xattn_fma`), held to
              the plain version and timed beside it. Then the
              training path's backward kernels K4b flash_attention_backward
              and K5b masked_xattn_backward at the OF-3B train step's shapes
              (LAION 8x32, MMC4 4x256 with 6 images) and edge cases (left
              padding with q_offset, ragged S = 257 with an all-masked
              sequence, xattn rows before any image): the forward's lse,
              dq/dk/dv against the plain versions in fp32 and bf16, exact
              zeros where the mask says; in bf16 the same for the CUDA-core
              FMA body the tensor-core backward replaced
              (`flash_attention_backward_fma`, `masked_xattn_backward_fma`).
              Times the backward (dq + dkv, delta fused into dq; CUDA-graph
              replay), its FMA body (`fma_ms`), the plain version, and the
              backward (and forward) of scaled_dot_product_attention with
              the same mask. OF-4B's shapes (RedPajama-INCITE-3B: D = 2560,
              32 heads of Dh = 80, biases, no ALiBi, untied head): K6
              attend_out_decode (slot write, attend, out-projection, bias)
              at its path shape and edge cases (slot 0 and 63, the whole
              epilogue, GQA, q only with ALiBi and a row with no valid key;
              in bf16 every K6 case in two parts, `heads_check`: the head
              outputs the kernel wrote against the plain attend, y against
              the plain tail over them), K1 QKV + bias and the untied head,
              K2 with b1/b2 and the xattn FF, K3 q only, K4 and K7 at
              Dh = 80 without ALiBi.
              LLaMA-7B's and OPT-1.3B's shapes (llama_opt_kernel_cases): K1
              with the RMSNorm prologue (q in bf16, int8, int4; the untied
              head over 32,003 rows) and OPT's LN + bias q; K2's SwiGLU
              form in bf16, int8 and int4 and at a ragged hidden size,
              OPT's relu MLP, the gelu_new and quick_gelu epilogues; K6 at
              LLaMA-7B's shape and grouped-query (Llama-3-8B: 32 heads over
              8 KV heads, Dh 128) over the bf16 and the int8 cache at slots
              0 and 63. The ViT's kernels (vit_kernel_cases): K9
              vit_attention at ViT-L/14 B 8 and 32 (BH 128 / 512, S 257,
              Dh 64, read through the (B, S, H, Dh) views the block passes;
              SDPA beside it) and at a ragged S 17; K10 layer_norm on
              (B, 257, 1024) with scale and bias, and without bias
              (F.layer_norm beside it); both autograd Functions against
              plain autograd in fp32. The absorbed ViT's kernels
              (absorb_kernel_cases): K8 flat_vit_attention on the next
              batch's flat (B', 264, 1024) workspace, s_real 257, at B' 8
              and 32 and the pipe's B' 64 (SDPA with the key mask beside
              it); K2b, each kind of (2112, 1024) x (1024, 1024) side tile
              on OF-3B's MPT MLP and xattn FF launches with bf16, int8 and
              int4 weights, the
              carrier's own output bit for bit that of the launch without a
              tile, timed with and without it (the exposed cost). K11
              fused_layer_decode (layer_kernel_cases): OF-3B's MPT-1B and
              gated xattn layers (B 1, 8, 13, 72) and MPT-7B's layer with
              bf16, int8 and int4 weights against reference_fused_layer,
              repeated on fresh caches (same bits each time), in fp32 bit
              for bit against the K3 + K2 kernel route, in bf16 its written
              caches and its x2 rounded bit for bit K3's, timed beside that
              route.
              The W8A8 side tile (K2b int8) and K3 as a carrier (K2b-attn,
              w8a8_kernel_cases) at every slot kind on K2 and K3 launches,
              B' 8 and the pipe's B 64: carriers bit for bit, the tile's
              int8 activations read back (each equal to the plain
              version's, or one step apart at a rounding boundary) and the
              tile held to the allowance the plain version's boundary
              activations give;
     vit      ViT-L/14 alone (random weights): fp32 patch tokens with K9/K10
              against plain_path() (VIT_RTOL) and their launches (24, 48);
              bf16 device time of one forward at B 8 and 32 with the kernels
              and under DISABLE (vision_ms_kernels, vision_ms_plain);
  3. generate full-width OF-3B (ViT-L/14 + MPT-1B, 24 xattn blocks), then
              full-width OF-4B (ViT-L/14 + RedPajama-INCITE-3B, 16 xattn
              blocks, its decoder biases drawn at random), LLaMA-7B
              (ViT-L/14 + LLaMA-7B, OpenFlamingo-9B's first release: 8 xattn
              blocks, RMSNorm, SwiGLU, untied head) and OPT-1.3B (24 xattn
              blocks, learned positions, relu, tied head, biases drawn at
              random; `SLICE_CONFIGS`), each with random
              weights from a seed: greedy flamingo_generate of 32
              tokens for 8 prompts of 32 tokens, one image each, two rows
              left-padded. fp32: each route encodes the images itself (the
              latents of kernels and plain_path() within VIT_RTOL) and
              computes its logits from its own latents; (a) the fused decode route (OF-3B K1-K3;
              OF-4B K1, K6, K2 per layer; LLaMA-7B and OPT-1.3B three K1,
              K6, K2 per layer; K3 + K2 per xattn block) with
              its kernels against the same route under `plain_path()`,
              (b) against the unfused route (`DISABLE_FUSED`,
              K7): identical tokens, and on one token stream the logits of
              prefill and of every decode step within tolerance. bf16,
              timed: (c) the fused route, (d) the unfused route, each with
              every kernel's launch counter reset just before and checked
              just after against the counts the route must give
              (`route_launches`: K9 24 and K10 48 per call, the vision
              encoded once), and one fused decode step under the sync
              debug mode "error" that launches no ViT kernel; OF-3B's fused
              route once more with the ViT on its plain route (vision_s,
              TTFT without K9/K10). OF-3B also with K11 in both its forms
              (layer_form: `fused_layer.DISABLE = False`, every MPT and gated
              block one launch; `XATTN_ONLY`, the gated blocks alone): fp32
              tokens and step logits against the default fused route and
              plain_path(), bf16 timed with exact launch counts and one
              sync-free step each, and the three forms timed in turns on
              the host clock. OF-3B is built through the port's entry
              point, create_model_and_transforms (its config
              model_config("OF-3B")'s, its weights init_random's bit for
              bit), and runs beam search (3 beams, length_penalty 0, eos
              the greedy stream's most frequent token) and sampling
              (temperature 0.7, top-k 50, top-p 0.9, one generator seed):
              fp32 kernels against plain_path() (beams also against the
              unfused route): tokens equal, and every step's log-probs (the
              other route forced onto the kernels' beams and tokens) or
              logits within LOGITS_TOL; where a near tie tips a choice, the
              first parted step must be a tie within the error shown
              (`beam_agree`, `sample_agree`). bf16 both timed on the fused
              route (B 8 prompts, 24 decode rows for the beams) with exact
              launch counts (paths `beam_generate_fused`,
              `sample_generate_fused`), and the beam step's cache gather
              timed alone. Each model is freed before the next.
     absorb   full-width OF-3B generate with the next batch's 8 images
              (flamingo_generate(next_pixels=)): the next batch's ViT-L/14
              as 288 K2b side tiles on the first 24 decode forwards' K2
              launches, K8 between its projections. fp32: tokens identical
              across the kernels, plain_path() and the call without
              next_pixels; next_latents within VIT_RTOL of embed_vision and
              of plain_path()'s; K8 24 and K2b 288 launches. bf16: the
              absorbed workspace against plain_path()'s (ABSORB_BF16_RTOL),
              one absorbing step under the sync debug mode "error", B 8 and
              32 and int4 B 8 timed against generate + a serial
              embed_vision with exact launch counts per variant. Then (a)
              fp32 with ATTN_CARRIERS (plan 24 / 12 / 3, K3 and K2 144
              tiles each, tokens and latents as above), (b) fp32 with the
              int8 side-car (288 W8A8 tiles, latents within
              W8A8_ABSORB_RTOL of plain_path()'s, 1e-6-0.1 from the
              unquantized embed_vision), (c) `phase_pipe`: the JAX
              package's b64_i4_pipe at full width, bf16 OF-3B B 64, int4 +
              W8A8 prefill + W8A8 tiles, latents fed forward and each
              call's within 0.1 of the serial W8A8 embed_vision's, the
              median of 5 calls in turns against the serial form, with and
              without ATTN_CARRIERS, exact launches, a sync-free absorbing
              step.
     serving  the continuous-batching ServingEngine on full-width OF-3B
              built by create_model_and_transforms. fp32: 12 requests
              (prompts of 8-32 tokens, one image, max_new from {8, 16,
              32}) submitted staggered to 8 rows (window 32, chunk 8,
              pipeline depth 2, 96 slots), admitted at several global slots
              across an epoch reset: each request's tokens those of
              flamingo_generate at B 1, and the engine under plain_path()
              and on the unfused route (K7) giving the kernels' tokens, a
              stream parting only at a near tie (`tokens_agree`). bf16: the
              churn workload (64 requests, prompts of 8-32 tokens
              left-padded to 32, max_new from {8, 16, 32, 64}, all queued;
              8 rows, 512 slots, window 64, chunk 8) at pipeline depth 0
              and 4 against static batches of 8: useful tokens/s, the
              latency percentiles, epochs, and launches exactly steps x
              (K1 1, K2 48, K3 48) + waves x (K4 24, K5 24, K9 24, K10 48)
              from the engine's counted decode steps and admission waves;
              one chunk under the sync debug mode "error"; absorb_vision
              (its plan engaged, pool hits, K8 and the "+side" tiles
              counted, tokens bit for bit those of the engine without tiles
              handed the same latents); int8 weights with int8_kv (the
              attn_block_decode[int8+kv8] variant) against
              flamingo_generate(int8_kv=True).
  speculative speculative_generate on OF-3B with an int4 copy of the
              same weights as the draft, B 1 and 8, D 4 and 7, 64 new
              tokens: fp32 tokens those of flamingo_generate, a self-draft's
              iterations exactly ceil(63 / (D + 1)); bf16 timed against
              flamingo_generate with exact launches (the draft's int4 K1-K3,
              K4 / K5 for D 7's verify window of 8).
     quantized  (the variants were checked in phase 2: `quant_kernel_cases`,
              int8 / packed int4 weights with per-channel scales and the
              int8 caches, K3's y over the int8 cache against the plain
              version over the caches the kernel wrote, the slot's written
              int8 row within one step of the plain version's at a rounding
              boundary in at most 0.1% of its entries.) OF-3B with int8, int4 and int8 + int8 K/V and
              media caches, OF-4B with int8 + int8 caches (and int4, timed:
              the path that runs K1 and K6 with int4), LLaMA-7B as OF-3B
              (the path that runs K2's SwiGLU with int weights). fp32 on
              dequantize_roundtrip weights: the side-car against no side-car
              and kernels against plain_path(), identical tokens and logits
              within tolerance (over the int8 cache step by step from shared
              states: paired_step_logits). bf16 timed with exact launch
              counts per variant, the drift against the unquantized call
              (OF-3B and LLaMA-7B gated: int8 mean KL < 1e-3, int4 < 0.1),
              one int8-cache step under the sync debug mode "error";
              W8A8 prefill's drift (OF-3B and LLaMA-7B, `w8a8_drift` and
              W8A8_GATES: int8 + W8A8 KL < 1e-2, OF-3B int4 + W8A8 < 0.1),
              LLaMA-7B's untied head (32,003 rows) among the int8 products.
  4. train    the full-width OF-3B training step (`make_train_step`) on
              random weights, LAION 8x32 with one image and MMC4 4x256 with
              six (uint8 pixels, <|endofchunk|> then <image> mid-row, right
              padding). fp32: one step's loss and every trainable gradient,
              kernels against the same step under `plain_path()`. bf16: one
              warm-up step, then three timed steps, each with every launch
              counter reset just before and checked just after (K4 and K5
              forwards 48, K4b and K5b 48, K9 48 and K10 96 for the two ViT
              forwards, K1-K3 and K7 0), finite losses,
              and the embedding rows other than <image>/<|endofchunk|>
              unchanged.
Then the `kernels` summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
before the last line. Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from open_flamingo_tpu_torch.configs import VIT_L_14, DecoderConfig, FlamingoConfig, flamingo_config
from open_flamingo_tpu_torch.factory import create_model_and_transforms
from open_flamingo_tpu_torch.generation import (
    NEG_INF, GenerationConfig, _filter_logits, _gather_beams, _process_logits, _repeat_beams, flamingo_generate,
    greedy_absorb, gumbel_noise, prefill)
from open_flamingo_tpu_torch.models import absorb_vit
from open_flamingo_tpu_torch.models.absorb_vit import SideHook, make_plan, patch_embed_flat
from open_flamingo_tpu_torch.models.decoders.common import KVCache, alibi_slopes, quantize_kv
from open_flamingo_tpu_torch.models.flamingo import count_media, init_random
from open_flamingo_tpu_torch.models.layers import layer_norm
from open_flamingo_tpu_torch.models.vit import VisionTransformer
from open_flamingo_tpu_torch.ops import build, dense_stream, w8a8
from open_flamingo_tpu_torch.ops import fused_layer as fl_op
from open_flamingo_tpu_torch.ops import layer_norm as ln_op
from open_flamingo_tpu_torch.ops import vit_attention as vit_op
from open_flamingo_tpu_torch.ops.attention import plain_path
from open_flamingo_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_update, reference_decode_attention)
from open_flamingo_tpu_torch.ops.decode_layer import (
    attend_out_decode, attn_block_decode, reference_attend, reference_attend_out, reference_attn_block,
    reference_out_tail)
from open_flamingo_tpu_torch.ops.dense_stream import (
    fused_dense, fused_mlp, normalize, reference_dense, reference_mlp, reference_side_tile, side_activations)
from open_flamingo_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_fma, flash_attention_fma,
    flash_attention_forward, reference_attention, reference_attention_backward)
from open_flamingo_tpu_torch.ops.fused_layer import fused_layer_decode, reference_fused_layer
from open_flamingo_tpu_torch.ops.masked_xattn import (
    masked_xattn, masked_xattn_backward, masked_xattn_backward_fma, masked_xattn_fma, masked_xattn_forward,
    reference_masked_xattn, reference_masked_xattn_backward)
from open_flamingo_tpu_torch.ops.vit_attention import (
    flat_vit_attention, reference_flat_vit_attention, reference_heads, vit_attention, vit_attention_heads)
from open_flamingo_tpu_torch.quantize import (
    dequantize_roundtrip, drop_decode_weights, pack_int4, quantize_decode_weights, quantize_prefill_weights,
    quantize_weight, w8a8_weight)
from open_flamingo_tpu_torch.serving import ServingEngine
from open_flamingo_tpu_torch.speculative import speculative_generate
from open_flamingo_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer, split_params
from open_flamingo_tpu_torch.train.train_loop import TrainLoopConfig, TrainState, batch_losses, make_train_step

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense; fp32 outside tensor cores
# fp32: kernel and plain sum in different orders (~1e-6 apart at these
# widths). bf16: both round an fp32 result to bf16, one ulp apart at most
# (2^-7 relative), plus the summation order.
TOL = {torch.float32: dict(atol=5e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# the backward's sums run over whole query and key axes (up to 257 terms of
# magnitude ~1-10 in fp32): rtol as well; bf16 as TOL
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)   # fp32 in both versions, from the same inputs
# K6: fp32 within 1e-5 (one fp32 sum over H*Dh = 2560 products of ~1e-3
# apart in order only). bf16 in two parts (`heads_check`): the head outputs
# the kernel wrote against the plain attend within TOL, then y within one
# ulp of the plain tail over THOSE head outputs: both tails round an fp32
# value that agrees to ~1e-6 (the floor 2^-6 sizes the ulp of results near
# 0). Against the plain attend's own head outputs y may not hold one ulp:
# where the residual cancels the out-projection, a head output rounded to
# bf16 on the other side of a boundary moves y by more.
CASE_TOL = {"attend_out_decode": {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: "ulp"}}
BF16_ULP_FLOOR = 2.0**-6
LOGITS_TOL = 2e-3   # fp32 logits through 24 decoder + 24 xattn layers, every step
# bf16 absorbed workspace (the next batch's ViT output), kernels vs plain_path(): max |diff| within 5e-2
# of the largest entry. Both round every side tile to bf16 at the same points (each fc2 slice's partial
# sum too: 4 roundings per layer where the plain ViT has 1); K2b and K8 sum in another order, so entries
# land one bf16 ulp (2^-8 relative) apart and 24 residual layers carry those flips. A wrong slot, mask,
# scale or stride moves entries by the order of the largest one.
ABSORB_BF16_RTOL = 5e-2
# fp32 absorbed next latents with the W8A8 side tiles, kernels vs plain_path(): max |diff| within 1e-2 of the
# largest entry. Kernel and plain version round the same int32 sums at the same points, so they part only where
# an activation's quotient lies within ~1e-5 of a rounding boundary and lands one int8 step apart (the LayerNorm
# statistics and quick_gelu taken in another order); each such step moves one tile output by ~1e-3 of its row's
# scale, and 24 residual layers carry a few of them. A wrong scale, slice or stride moves entries by the order
# of the largest one; the int8 grid itself moves them by up to 0.1 (the JAX gate).
W8A8_ABSORB_RTOL = 1e-2
# a W8A8 activation's quotient act(LN?(x)) / s_act within this of a .5 may round one int8 step the other way in
# the kernel (its fp32 LayerNorm statistics and activation ~1e-6 relative apart: ~1e-4 of a step at |q| 127);
# any other activation must come out equal, and none more than one step apart
W8A8_NEAR = 1e-3
# fp32 ViT output and latents, kernels (K9, K10) vs plain_path(): max |diff| within
# 1e-4 of the largest entry. Each block's K9/K10 sum in another order than the
# plain version (~1e-6 relative), and 24 residual blocks (and the perceiver
# after them) carry and grow that; 1e-4 leaves ~30x room above it, and a
# wrong mask, scale or rounding moves entries by 1e-2 or more.
VIT_RTOL = 1e-4
B, T_PROMPT, NEW_TOKENS, SEED = 8, 32, 32, 0
L2_BYTES = 50e6    # H100 SXM
K7_LONG_S = 2048   # LLaMA-7B's longest cache (max_position_embeddings)
# the main-path shape of each kernel, timed and reported, and the path whose
# launches its entry reports; other cases are edge cases or other paths' shapes
MAIN_CASES = {"fused_dense": ("head_V50434", "generate_fused"), "fused_mlp": ("mpt_mlp", "generate_fused"),
              "attn_block_decode": ("self_S64_slot40", "generate_fused"),
              "flash_attention": ("prefill_S64", "generate_fused"), "masked_xattn": ("prefill_T1", "generate_fused"),
              "decode_attention": ("xattn_S64", "generate_unfused"),
              "decode_attention_update": ("self_S64_slot40", "generate_unfused"),
              "flash_attention_backward": ("mmc4_T256", "train_step"),
              "masked_xattn_backward": ("mmc4_T256", "train_step"),
              "attend_out_decode": ("neox_S64_slot40", "of4b_generate_fused"),
              "vit_attention": ("vitl14_B8", "generate_fused"), "layer_norm": ("vitl14_B8", "generate_fused"),
              "flat_vit_attention": ("of3b_next_B8", "absorb_bf16"),
              "fused_layer_decode": ("mpt_layer_S64_slot40", "generate_fused_layer")}
# OF-4B's shapes of the kernels its path shares with OF-3B's
NEOX_TIMED = {"neox_qkv_bias", "neox_head_untied_V50434", "neox_mlp_bias", "neox_xattn_S64_gate",
              "prefill_Dh80_noalibi", "neox_self_Dh80", "neox_self_S64_slot40"}
# the quantized variants' path shapes (quant_kernel_cases)
QUANT_TIMED = {"head_V50434_int8", "head_V50434_int8_B64", "mpt_mlp_int4_B64", "neox_head_untied_V50434_int8",
               "neox_qkv_bias_int8", "neox_qkv_bias_int4",
               "mpt_mlp_int8", "mpt_mlp_int4", "xattn_ff_int8", "xattn_ff_int4", "neox_mlp_bias_int8",
               "self_S64_slot40_int8", "self_S64_slot40_int4", "self_S64_slot40_int8_kv8", "self_S64_slot40_int4_kv8",
               "xattn_S64_gate_int8_kv8", "xattn_S64_gate_int4_kv8", "neox_xattn_S64_gate_int8_kv8",
               "self_S64_slot40_int4_B64", "xattn_S64_gate_int4_B64",
               "neox_S64_slot40_int8_kv8", "neox_S64_slot40_int4", "neox_S64_slot40_int8", "neox_S64_slot40_int4_kv8"}
# LLaMA-7B's and OPT-1.3B's shapes and the variants this slice added (llama_opt_kernel_cases)
LLAMA_OPT_TIMED = {"llama_q_rms", "llama_q_rms_int8", "llama_q_rms_int4", "llama_head_rms_V32003",
                   "llama_head_rms_V32003_int8", "opt_q_ln_bias", "llama_swiglu", "llama_swiglu_int8",
                   "llama_swiglu_int4", "swiglu_ragged_K2_11000", "opt_mlp_relu_bias", "mlp_gelu_new", "mlp_quick_gelu",
                   "llama_S64_slot40", "llama3_gqa4_S64_slot0", "llama3_gqa4_S64_slot63", "llama3_gqa4_S64_slot0_kv8",
                   "llama3_gqa4_S64_slot63_kv8", "llama_xattn_ff_K2_16384", "opt_S64_slot40",
                   "prefill_opt_Dh64_noalibi", "prefill_llama_Dh128_noalibi", "opt_self_Dh64", "opt_self_S64_slot40",
                   "llama_self_Dh128", "llama_self_S64_slot40"}
# the ViT's (vit_kernel_cases)
VIT_TIMED = {"vitl14_B8", "vitl14_B32", "S17", "vitl14_B8_nobias"}
# the absorbed ViT's (absorb_kernel_cases): K8 at the next batch's B' 8 and 32 and the pipe's B' 64, K2b on
# OF-3B's carriers
ABSORB_TIMED = {"of3b_next_B32", "of3b_next_B64", "mpt_mlp_side_qkv", "mpt_mlp_side_fc2", "mpt_mlp_int8_side_qkv",
                "mpt_mlp_int4_side_qkv", "mpt_mlp_int4_side_fc2", "xattn_ff_side_qkv"}
# the W8A8 side tile and K3 as a carrier (w8a8_kernel_cases), at the pipe's carriers
W8A8_TIMED = {"mpt_mlp_side8_qkv", "mpt_mlp_int8_side8_qkv", "mpt_mlp_int4_side8_qkv", "mpt_mlp_int4_side8_fc2",
              "self_S64_slot40_side8_qkv", "self_S64_slot40_int4_side8_qkv", "self_S64_slot40_int8_kv8_side8_qkv",
              "self_S64_slot40_side", "xattn_S64_gate_int4_side8_qkv", "xattn_S64_gate_side",
              "mpt_mlp_int4_B64_side8_qkv", "mpt_mlp_int4_B64_side8_fc2", "self_S64_slot40_int4_B64_side8_qkv",
              "xattn_S64_gate_int4_B64_side8_qkv"}
# K11's (layer_kernel_cases): OF-3B's xattn layer, MPT-7B's layer, the int weights
LAYER_TIMED = {f"{case}{sfx}" for case in ("mpt_layer_S64_slot40", "xattn_layer_S64", "mpt7b_layer_S64_slot40")
               for sfx in ("", "_int8", "_int4")}
# K4's and K5's other generate shapes: a prompt after a 16-token prefix, the ViT-length ragged S, two images
PREFILL_TIMED = {"q_offset16", "ragged_S257", "prefill_T2"}
# K7 at LLaMA-7B's longest cache (k7_long_cases), B 1 and 8, both entry points
K7_LONG_TIMED = {"llama_self_S2048_B1", "llama_self_S2048_B8", "llama_S2048_slot2047_B1", "llama_S2048_slot2047_B8"}
TIMED_CASES = ({case for case, _ in MAIN_CASES.values()} | {"xattn_ff", "xattn_S64_gate"} | NEOX_TIMED | QUANT_TIMED
               | LLAMA_OPT_TIMED | VIT_TIMED | ABSORB_TIMED | W8A8_TIMED | LAYER_TIMED | PREFILL_TIMED
               | K7_LONG_TIMED)
BWD_TIMED = {"laion_T32", "mmc4_T256"}
# the OF-3B train step at the JAX package's bench shape (bench.py:494)
B_L, T_L, B_M, T_M, N_IMG, TRAIN_PAD = 8, 32, 4, 256, 6, 1
TRAIN_STEPS = 3
LOSS_TOL = 1e-4     # fp32 train-step loss, kernels vs plain_path (a mean of ~1,100 log-softmaxes)
GRAD_RTOL = 1e-3    # fp32 gradients: per tensor, max |kernels - plain| / max |plain|, through 48 blocks


# LLaMA-7B, the LM of OpenFlamingo-9B's first release (ViT-L/14, xattn before
# every 4th layer), and OPT-1.3B (facebook/opt-1.3b, xattn every layer, the
# ratio OF-3B uses for its 1B LM), at their published widths: the fields the
# JAX package's convert/hf_lm.py sets from each model's config. The
# vocabulary holds the added <|endofchunk|> and <image> (and LLaMA's <PAD>).
LLAMA_7B = DecoderConfig(
    family="llama", vocab_size=32003, hidden_size=4096, num_layers=32, num_heads=32, intermediate_size=11008,
    max_position_embeddings=2048, layer_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
    tie_word_embeddings=False, hidden_act="silu",
)
OPT_1_3B = DecoderConfig(
    family="opt", vocab_size=50272, hidden_size=2048, num_layers=24, num_heads=32, intermediate_size=8192,
    max_position_embeddings=2048, layer_norm_eps=1e-5, attention_bias=True, tie_word_embeddings=True,
)
SLICE_CONFIGS = {"LLaMA-7B": (LLAMA_7B, 32001, 32000, 4), "OPT-1.3B": (OPT_1_3B, 50266, 50265, 1)}


def model_config(name: str) -> FlamingoConfig:
    """A released configuration (configs.flamingo_config) or one of
    SLICE_CONFIGS: (decoder, <image> id, <|endofchunk|> id, xattn interval)."""
    if name not in SLICE_CONFIGS:
        return flamingo_config(name)
    lm, media, eoc, every = SLICE_CONFIGS[name]
    return FlamingoConfig(vision=VIT_L_14, lm=lm, media_token_id=media, eoc_token_id=eoc, cross_attn_every_n=every)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, rounds: int = 10, stream=None) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph (on
    `stream`, or the graph's own side stream) and replayed `rounds` times
    between CUDA events, so the host's launch cost is left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def call_ms(fn, iters: int = 50) -> float:
    """Time of one eager call, host launch cost included."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def opcode(ins: str) -> str:
    """A SASS instruction's opcode, its predicate and modifiers dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split(" ")[0].split(".")[0]


@functools.lru_cache(maxsize=None)
def sass_kernels(path) -> dict:
    """The SASS instructions of each kernel of a built library
    (`cuobjdump --dump-sass`), by demangled name with the anonymous
    namespace and the casts of template arguments dropped. Read once a
    library: the returned dict is shared, not to be changed."""
    cuobjdump, filt = (shutil.which(t) or f"/usr/local/cuda/bin/{t}" for t in ("cuobjdump", "cu++filt"))
    text = subprocess.run([cuobjdump, "--dump-sass", str(path)], check=True, capture_output=True, text=True,
                          timeout=300).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            kernels[name] = []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if ins:
                kernels[name].append(ins.group(1))
    names = list(kernels)
    if not os.path.exists(filt):        # mangled names, then
        return kernels
    plain = subprocess.run([filt], input="\n".join(names), check=True, capture_output=True, text=True,
                           timeout=60).stdout.splitlines()
    return {re.sub(r"\((?:int|bool)\)|\(anonymous namespace\)::|<unnamed>::", "", p): kernels[n]
            for n, p in zip(names, plain)}


# the libraries whose launches carry side tiles; the carrier instances with the
# fp32 tile (x fp32, no W8A8: gemv_side_kernel<float, W, false>)
# (and their carrier instances with a ring tile: K2's and K3's, each 6
# weight-streaming carriers and 3 fp32 W8A8 ones)
SIDE_LIBS = {"dense_stream": 9, "decode_layer": 9}
# the weight-streaming instances of each library's row GEMVs (their HMMA
# counted): K1/K2's 2 x 30 and 6 carriers; K3/K6's projections (bf16, int8,
# int4 weights, B <= 8 and any B, fp32 q/k/v and bf16 out: 12) and 6 carriers
STREAM_LIBS = {"dense_stream": 66, "decode_layer": 18}
FP32_TILE = re.compile(r"gemv_side_kernel<float, [^<>]*, (false|0)>")
OLD_BODY_F32 = re.compile(r"gemv_(side_)?kernel<float,")
PREDICATED_HMMA = re.compile(r"(@!?U?P\w+\s+)?HMMA")   # the body's products run under the n-tile's predicate
# the libraries whose bf16 bodies run on tensor cores, and those kernels
HMMA_KERNELS = {"prefill_attention": ("attention_fwd_mma",),
                "attention_backward": ("attention_bwd_dq_mma", "attention_bwd_dkv_mma")}
# K9/K8's bf16 instances (Dh 16, 32, 64; K9 and K8's kFlat) and what each must issue: wgmma and TMA loads and stores
VIT_BF16 = ("vit_attn_bf16", 6, ("HGMMA", "UTMALDG", "UTMASTG"))
# K7's split kernel: its instances (fp32 with G 1-32 lanes a key, bf16 with 1-16) each issue the 1-D bulk copy
# (cp.async.bulk)
K7_SPLIT = ("decode_split_kernel", 11, "UBLKCP")
# K11's instances: bf16 (3 weight types x 3 forms, each for B <= 8 and past 8 rows), every row-GEMV phase on
# the weight-streaming body's mma.sync; fp32 (3 x 3) on CUDA cores alone
K11_BF16 = ("fused_layer_kernel<__nv_bfloat16", 18, 9)


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = build.build(build.sources())
    regs = [ln.strip() for text in reports.values() for ln in text.splitlines() if "registers" in ln]
    seconds = round(time.perf_counter() - t0, 3)
    # every library's SASS is dumped at once (one cuobjdump each), then checked below
    with ThreadPoolExecutor(len(build.sources())) as pool:
        list(pool.map(sass_kernels, [build.target(lib) for lib in build.sources()]))
    # K4/K5 and K4b/K5b: each tensor-core instance (6 padded Dh x 2 masks per
    # kernel) must issue HMMA, each FMA-body instance none
    hmma = {}
    for lib, tc_kernels in HMMA_KERNELS.items():
        hmma[lib] = {name.split("(")[0]: sum(ins.startswith("HMMA") for ins in code)
                     for name, code in sass_kernels(build.target(lib)).items()}
        for kernel in tc_kernels:
            counts = [n for name, n in hmma[lib].items() if kernel in name]
            require(len(counts) == 12 and min(counts) > 0, f"{lib}: {kernel} instances {counts}, 12 with HMMA expected")
        fma = {name: n for name, n in hmma[lib].items() if not any(kernel in name for kernel in tc_kernels)}
        require(fma and not any(fma.values()), f"{lib}: FMA-body instances with HMMA: {fma}")
    # K2b / K2b int8: each carrier instance with a ring tile (bf16, or W8A8 in
    # either dtype) must issue wgmma (HGMMA bf16, IGMMA int8); the fp32 tile none
    gmma = {}
    for lib, want in SIDE_LIBS.items():
        gmma[lib] = {name.split("(")[0]: sum(ins.startswith(("HGMMA", "IGMMA")) for ins in code)
                     for name, code in sass_kernels(build.target(lib)).items() if "side_kernel" in name}
        ring = {name: n for name, n in gmma[lib].items() if not FP32_TILE.search(name)}
        require(len(ring) == want and min(ring.values()) > 0,
                f"{lib}: side-kernel instances {gmma[lib]}, {want} with wgmma expected")
        require(not any(n for name, n in gmma[lib].items() if name not in ring), f"{lib}: the fp32 tile issues wgmma")
    # K1/K2 and K3/K6: every bf16 launch runs the weight-streaming body (HMMA
    # in each of its instances, B <= 8 and any B, and its carriers); the old
    # bodies only in fp32 (beside K3's and K6's attend kernels)
    for lib, want in STREAM_LIBS.items():
        rows_ = {name.split("(")[0]: sum(bool(PREDICATED_HMMA.match(ins)) for ins in code)
                 for name, code in sass_kernels(build.target(lib)).items() if "attend" not in name}
        stream = {name: n for name, n in rows_.items() if "gemv_stream" in name and "reduce" not in name}
        require(len(stream) == want and min(stream.values()) > 0, f"{lib}: weight-streaming instances {stream}")
        old = [name for name in rows_ if "stream" not in name and ("_mma_" in name or not OLD_BODY_F32.search(name))]
        require(not old, f"{lib}: bf16 instances of the old row GEMV bodies: {old}")
    # K11: each bf16 instance runs its phases on the weight-streaming body (HMMA), the fp32 ones none
    kernel, want, want_f32 = K11_BF16
    k11 = {name.split("(")[0]: sum(bool(PREDICATED_HMMA.match(ins)) for ins in code)
           for name, code in sass_kernels(build.target("fused_layer")).items() if "fused_layer_kernel<" in name}
    k11_bf16 = {name: n for name, n in k11.items() if kernel in name}
    k11_f32 = {name: n for name, n in k11.items() if name not in k11_bf16}
    require(len(k11_bf16) == want and min(k11_bf16.values()) > 0 and len(k11_f32) == want_f32
            and not any(k11_f32.values()), f"fused_layer: instances {k11}, {want} bf16 with HMMA and {want_f32} "
            "fp32 without expected")
    # K9/K8: each bf16 instance of the persistent kernel issues wgmma, TMA loads and TMA stores; no kernel of the
    # library keeps the old mma.sync body
    kernel, want, ops = VIT_BF16
    vit = {name.split("(")[0]: {op: sum(ins.startswith(op) for ins in code) for op in ("HMMA", *ops)}
           for name, code in sass_kernels(build.target("vit_attention")).items()}
    bf16 = {name: n for name, n in vit.items() if kernel in name}
    require(len(bf16) == want and all(n[op] > 0 for n in bf16.values() for op in ops),
            f"vit_attention: bf16 instances {bf16}, {want} with {ops} expected")
    require(not any(n["HMMA"] for n in vit.values()), f"vit_attention: mma.sync left in {vit}")
    # K7: every instance of the split kernel stages its tiles by bulk copies; no other kernel in the library
    kernel, want, op = K7_SPLIT
    k7 = {name.split("(")[0]: [opcode(ins) for ins in code]
          for name, code in sass_kernels(build.target("decode_attention")).items()}
    k7_ops = {name: code.count(op) for name, code in k7.items()}
    require(len(k7) == want and all(kernel in name and n > 0 for name, n in k7_ops.items()),
            f"decode_attention: instances {k7_ops}, {want} of {kernel} with {op} expected")
    log({"phase": "build", "seconds": seconds, "sources": build.sources(), "ptxas": regs,
         "decode_attention_sass": {op: k7_ops, "opcodes": sorted(set(next(iter(k7.values()), [])))},
         **{f"{lib}_hmma": counts for lib, counts in hmma.items()},
         **{f"{lib}_side_gmma": counts for lib, counts in gmma.items()}, "vit_attention_sass": vit,
         "fused_layer_hmma": k11})


# ---------------------------------------------------------------- phase 2


def left_padded_mask(b, t, pads, device):
    """(b, t) bool validity with row r left-padded by pads[r] tokens."""
    m = torch.ones(b, t, dtype=torch.bool, device=device)
    for r, n in enumerate(pads):
        m[r, :n] = False
    return m


def compare(name, case, dtype, got, want, exact=None, tol=None):
    """`exact(got)`: the case's rows that must come out exactly (rows with
    no valid key: zeros, or x itself after K3's residual). `tol`: TOL's
    form, "ulp", or (allowance tensor, relative part) of a W8A8 tile."""
    tol = tol or TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if isinstance(tol, tuple):
        allow, rel = tol
        ok = bool((diff <= allow + rel * want.float().abs() + 1e-6).all())
        tol = {"w8a8_allowance_max": allow.max().item(), "rtol": rel}
    elif tol == "ulp":        # one bf16 ulp (8 significant bits) of the plain result
        mag = want.float().abs().clamp(min=BF16_ULP_FLOOR)
        ok = bool((diff <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())
    else:
        ok = torch.allclose(got.float(), want.float(), **tol)
    exact0 = True if exact is None else bool(exact(got))
    log({"phase": "kernels", "kernel": name, "case": case, "dtype": str(dtype).split(".")[-1],
         "max_abs_err": err, "tol": tol, "all_masked_rows_exact_zero": exact0})
    require(ok, f"{name}/{case}/{dtype}: max abs err {err}")
    require(exact0, f"{name}/{case}/{dtype}: all-masked rows not exactly zero")
    return err


def llama_opt_kernel_cases(dtype, gen, dev):
    """LLaMA-7B's and OPT-1.3B's shapes (B = 8): K1 with the RMSNorm prologue
    (q at D 4096 in x's dtype, int8 and int4; the untied head over 32,003
    rows, and its int8 copy) and OPT's LayerNorm + bias q (D 2048); K2's
    SwiGLU at LLaMA-7B's shape (x's dtype, int8, int4) and at a ragged hidden
    size (11,000: a ragged column tile, and K % 32 != 0 in launch 2), OPT's
    relu MLP with b1/b2, the gelu_new and quick_gelu epilogues, LLaMA-7B's
    xattn FF (hidden 16,384: launch 2's K split across blocks); K6 at
    LLaMA-7B's self-attention shape, grouped-query at Llama-3-8B's (32 heads
    over 8 KV heads, Dh 128) over the model-dtype and the int8 cache at slots
    0 and 63, and at OPT-1.3B's (Dh 64, out_proj bias); K4 prefill and K7 at
    LLaMA-7B's and OPT-1.3B's self-attention. Yields as kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    sfx = {None: "", 8: "_int8", 4: "_int4"}

    def stored(w, bits):    # (weight as the kernel streams it, scale, its bytes)
        return (w, None, w.numel() * es) if bits is None else qweight(w, bits)

    # K1: RMSNorm + q (and the untied head) at LLaMA-7B, eps 1e-6; LN + bias q at OPT-1.3B
    d, v = 4096, 32003
    x, ln = rn(B, d), 1 + rn(d, scale=0.1)
    hr = normalize(x, ln, None, 1e-6, "rms")
    for case, n, bits_list in (("llama_q_rms", d, (None, 8, 4)), ("llama_head_rms_V32003", v, (None, 8))):
        w = rn(n, d, scale=d**-0.5)
        for bits in bits_list:
            q, sc, wbytes = stored(w, bits)
            kw = dict(w_scale=sc, ln_scale=ln, eps=1e-6, norm="rms")
            cost = (wbytes + (B * d + d + B * n) * es, 2 * B * n * d)
            yield ("fused_dense", case + sfx[bits], lambda q=q, kw=kw: fused_dense(x, q, **kw),
                   lambda q=q, kw=kw: reference_dense(x, q, **kw), None, cost, lambda w=w: F.linear(hr, w),
                   "F.linear(RMSNorm(x), W) over the weight in x's dtype: the product alone")
    d2 = 2048
    x2, ln2, ln2_b = rn(B, d2), 1 + rn(d2, scale=0.1), rn(d2, scale=0.1)
    hn2 = layer_norm(x2, ln2, ln2_b)
    wq, bq = rn(d2, d2, scale=d2**-0.5), rn(d2, scale=0.1)
    cost = ((d2 * d2 + B * d2 + 3 * d2 + B * d2) * es, 2 * B * d2 * d2)
    yield ("fused_dense", "opt_q_ln_bias", lambda: fused_dense(x2, wq, bias=bq, ln_scale=ln2, ln_bias=ln2_b),
           lambda: reference_dense(x2, wq, bias=bq, ln_scale=ln2, ln_bias=ln2_b), None, cost,
           lambda: F.linear(hn2, wq, bq), "F.linear(LN(x), W, b): the product and bias alone")

    # K2 SwiGLU at LLaMA-7B: gate_proj, up_proj (11008, 4096) and down_proj
    # (4096, 11008) with the residual; a ragged hidden size in x's dtype
    for case, k2, bits_list in (("llama_swiglu", 11008, (None, 8, 4)), ("swiglu_ragged_K2_11000", 11000, (None,))):
        wg, wu, wd = rn(k2, d, scale=d**-0.5), rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
        lib = lambda wg=wg, wu=wu, wd=wd: F.linear(F.silu(F.linear(hr, wg)) * F.linear(hr, wu), wd)
        for bits in bits_list:
            (qg, sg, byg), (qu, su, byu), (qd, sd, byd) = stored(wg, bits), stored(wu, bits), stored(wd, bits)
            kw = dict(w1_gate=qu, w1_scale=sg, w1_gate_scale=su, w2_scale=sd, ln_scale=ln, eps=1e-6, norm="rms",
                      act="silu", residual=x)
            cost = (byg + byu + byd + (2 * B * d + d) * es, 6 * B * d * k2)
            yield ("fused_mlp", case + sfx[bits], lambda qg=qg, qd=qd, kw=kw: fused_mlp(x, qg, qd, **kw),
                   lambda qg=qg, qd=qd, kw=kw: reference_mlp(x, qg, qd, **kw), None, cost, lib,
                   "F.linear x3 with silu and the product between, over the weights in x's dtype")

    # K2 at OPT-1.3B: LN + bias, fc1 + b1, relu, fc2 + b2, residual; the
    # gelu_new and quick_gelu epilogues at the same shape without biases
    k2 = 8192
    w1, w2, b1, b2 = rn(k2, d2, scale=d2**-0.5), rn(d2, k2, scale=k2**-0.5), rn(k2, scale=0.1), rn(d2, scale=0.1)
    for case, act, biases in (("opt_mlp_relu_bias", "relu", True), ("mlp_gelu_new", "gelu_new", False),
                              ("mlp_quick_gelu", "quick_gelu", False)):
        kw = dict(ln_scale=ln2, ln_bias=ln2_b, act=act, residual=x2, b1=b1 if biases else None,
                  b2=b2 if biases else None)
        cost = ((2 * d2 * k2 + 2 * B * d2 + 2 * d2 + (k2 + d2) * biases) * es, 4 * B * d2 * k2)
        yield ("fused_mlp", case, lambda kw=kw: fused_mlp(x2, w1, w2, **kw),
               lambda kw=kw: reference_mlp(x2, w1, w2, **kw), None, cost, lambda kw=kw: F.linear(F.linear(hn2, w1, kw["b1"]), w2, kw["b2"]),
               "F.linear twice: the two products (and biases) alone")

    # K2 at LLaMA-7B's xattn FF (D 4096 -> 16,384 -> 4096, LN + bias, GELU,
    # ff_gate, residual): launch 2's K = 16,384 on the weight-streaming body,
    # its K split across blocks
    k2 = 16384
    ln_b = rn(d, scale=0.1)
    hn = layer_norm(x, ln, ln_b)
    w1, w2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
    gate = torch.tensor([0.5], device=dev, dtype=dtype)
    kw = dict(ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate)
    cost = ((2 * d * k2 + 2 * B * d + 2 * d + 1) * es, 4 * B * d * k2)
    yield ("fused_mlp", "llama_xattn_ff_K2_16384", lambda: fused_mlp(x, w1, w2, **kw),
           lambda: reference_mlp(x, w1, w2, **kw), None, cost, lambda: F.linear(F.linear(hn, w1), w2),
           "F.linear twice: the two products alone")

    # K6: LLaMA-7B's self-attention tail (MHA, no bias, residual), then
    # grouped-query at Llama-3-8B's shape, model-dtype and int8 cache; then
    # OPT-1.3B's (D 2048, 32 heads of Dh 64, out_proj bias, residual)
    s = 64
    for case, dm, h, dh, slot, n_rep, kv8, biased in (
        ("llama_S64_slot40", d, 32, 128, 40, 1, False, False), ("llama3_gqa4_S64_slot0", d, 32, 128, 0, 4, False, False),
        ("llama3_gqa4_S64_slot63", d, 32, 128, 63, 4, False, False),
        ("llama3_gqa4_S64_slot0_kv8", d, 32, 128, 0, 4, True, False),
        ("llama3_gqa4_S64_slot63_kv8", d, 32, 128, 63, 4, True, False), ("opt_S64_slot40", d2, 32, 64, 40, 1, False, True),
    ):
        if case in ("llama_S64_slot40", "opt_S64_slot40"):     # each model's out-projection
            wout, res = rn(dm, h * dh, scale=(h * dh) ** -0.5), rn(B, dm)
            bout = rn(dm, scale=0.1) if biased else None
            a_in = rn(B, h * dh)
        h_kv = h // n_rep
        q = rn(B, h, dh)
        if kv8:
            (k0, ks0), (v0, vs0) = (quantize_kv(torch.randn(B, h_kv, s, dh, generator=gen, device=dev))
                                    for _ in range(2))
        else:
            k0, v0, ks0, vs0 = rn(B, h_kv, s, dh), rn(B, h_kv, s, dh), None, None
        caches = [c.clone() if c is not None else None for c in (k0, v0, ks0, vs0)]
        mask = left_padded_mask(B, s, [4, 7], dev)
        mask[:, slot + 1:] = False
        mask[:, slot] = True
        kw = dict(scale=dh**-0.5, k_new=rn(B, h_kv, dh), v_new=rn(B, h_kv, dh), residual=res, bias=bout,
                  slot=torch.tensor([slot], dtype=torch.int32, device=dev))
        fn, plain = k6_fns(q, caches, (k0, v0, ks0, vs0), mask, wout, kw)
        n_valid = mask.sum().item()
        ces = 1 if kv8 else es
        cost = ((dm * h * dh + B * h * dh + 2 * B * dm + 2 * B * h_kv * dh + dm * biased) * es
                + 2 * n_valid * h_kv * (dh * ces + 4 * kv8) + B * s + 4, 2 * B * dm * h * dh + 4 * h * dh * n_valid)
        yield ("attend_out_decode", case, fn, plain, None, cost,
               lambda a_in=a_in, wout=wout, bout=bout: F.linear(a_in, wout, bout),
               "F.linear(a, Wout, b): the out-projection alone" if biased else
               "F.linear(a, Wout): the out-projection alone")
        if kv8:
            pc = [t.clone() for t in (k0, v0, ks0, vs0)]
            reference_attend_out(q, pc[0], pc[1], mask, wout, k_scale=pc[2], v_scale=pc[3], **kw)
            int8_slot_check("attend_out_decode", case, dtype, caches, pc, (k0, v0, ks0, vs0), slot)
        else:
            # the slot row holds the new K/V exactly and nothing else moved
            others = torch.arange(s, device=dev) != slot
            require(torch.equal(caches[0][:, :, slot], kw["k_new"]) and torch.equal(caches[1][:, :, slot], kw["v_new"]),
                    f"attend_out_decode/{case}: slot row not the new K/V")
            require(torch.equal(caches[0][:, :, others], k0[:, :, others])
                    and torch.equal(caches[1][:, :, others], v0[:, :, others]),
                    f"attend_out_decode/{case}: slots other than the new token's changed")

    # K4 prefill and K7 (the unfused route) at LLaMA-7B's (32 heads of Dh 128)
    # and OPT-1.3B's (32 of Dh 64) self-attention, neither with ALiBi
    yield from self_attention_cases(rn, es, dev, 32, 128, "prefill_llama_Dh128_noalibi", "llama_self_Dh128",
                                    "llama_self_S64_slot40")
    yield from self_attention_cases(rn, es, dev, 32, 64, "prefill_opt_Dh64_noalibi", "opt_self_Dh64",
                                    "opt_self_S64_slot40")


def launched_variant(fn, call):
    """Run `call` and return the variant of `fn`'s kernel that it launched,
    as the wrapper's per-variant counter names it (`dense_stream.variant`;
    "float" for a kernel that keeps no variants)."""
    before = dict(getattr(fn, "variants", {}))
    out = call()
    grew = [key for key, n in getattr(fn, "variants", {}).items() if n != before.get(key, 0)]
    return out, grew[0] if grew else "float"


def zeros_at(rows):
    return lambda got: (got[rows] == 0).all().item()


def with_fma(fn, fma):
    """K4's or K5's call `fn` with `fn.fma`, the same call on the forward's
    CUDA-core FMA body: the kernel the bf16 tensor-core body replaced, timed
    and held to the plain version beside it."""
    fn.fma = fma
    return fn


def kernel_cases(dtype, gen, dev):
    """Yields (name, case, kernel_fn, plain_fn, exact, cost, library_fn,
    what the library call times)."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    d, k2, v = 2048, 8192, 50434                        # MPT-1B width, MLP hidden, OF-3B vocabulary

    # K1: final LayerNorm (no bias) fused into the tied head; the (V, D)
    # table read in place, V = 24 * 2048 + 1282
    x, w, ln = rn(B, d), rn(v, d, scale=d**-0.5), 1 + rn(d, scale=0.1)
    hn = layer_norm(x, ln, None)
    cost = ((v * d + B * d + d + B * v) * es, 2 * B * v * d)
    yield ("fused_dense", "head_V50434", lambda: fused_dense(x, w, ln_scale=ln),
           lambda: reference_dense(x, w, ln_scale=ln), None, cost, lambda: F.linear(hn, w),
           "F.linear(LN(x), W): the product alone")

    # K2: MPT MLP (LN without bias, residual) and xattn FF (LN bias, ff_gate)
    w1, w2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
    ln_b, gate = rn(d, scale=0.1), torch.tensor([0.5], device=dev, dtype=dtype)
    cost = ((2 * d * k2 + 2 * B * d + d) * es, 4 * B * d * k2)
    lib = lambda: F.linear(F.linear(hn, w1), w2)
    yield ("fused_mlp", "mpt_mlp", lambda: fused_mlp(x, w1, w2, ln_scale=ln, residual=x),
           lambda: reference_mlp(x, w1, w2, ln_scale=ln, residual=x), None, cost, lib,
           "F.linear twice: the two products alone")
    cost = ((2 * d * k2 + 2 * B * d + 2 * d + 1) * es, 4 * B * d * k2)
    yield ("fused_mlp", "xattn_ff", lambda: fused_mlp(x, w1, w2, ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate),
           lambda: reference_mlp(x, w1, w2, ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate), None, cost, lib,
           "F.linear twice: the two products alone")

    # K3 self: LN, Wqkv (3D, D), slot write in place, ALiBi, Wout, residual
    # (H = 16, Dh = 128, a 64-slot cache); slot 63 with clip_qkv as an edge
    h, dh, s = 16, 128, 64
    wqkv, wout = rn(3 * d, d, scale=d**-0.5), rn(d, d, scale=d**-0.5)
    for case, slot, clip in (("self_S64_slot40", 40, None), ("self_S64_slot63", 63, 1.0)):
        k0, v0 = rn(B, h, s, dh), rn(B, h, s, dh)
        kc, vc = k0.clone(), v0.clone()
        mask = left_padded_mask(B, s, [4, 7], dev)
        mask[:, slot + 1:] = False
        kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True, clip=clip, slopes=slopes16,
                  slot=torch.tensor([slot], dtype=torch.int32, device=dev))
        fn = lambda kc=kc, vc=vc, mask=mask, kw=kw: attn_block_decode(x, ln, None, wqkv, wout, kc, vc, mask, **kw)[0]
        plain = lambda k0=k0, v0=v0, mask=mask, kw=kw: reference_attn_block(
            x, ln, None, wqkv, wout, k0.clone(), v0.clone(), mask, **kw)[0]
        n_valid = mask.sum().item()
        cost = ((4 * d * d + 2 * B * d + d + 2 * (n_valid + B) * h * dh) * es + B * s + 4,
                8 * B * d * d + 4 * h * dh * n_valid)
        a_in = rn(B, d)
        lib = lambda: (F.linear(hn, wqkv), F.linear(a_in, wout))
        yield ("attn_block_decode", case, fn, plain, None, cost, lib, "F.linear for Wqkv and Wout: the products alone")
        # the cache's slot row was written (rounded) and nothing else moved
        kp, vp = k0.clone(), v0.clone()
        reference_attn_block(x, ln, None, wqkv, wout, kp, vp, mask, **kw)
        require(torch.allclose(kc.float(), kp.float(), **TOL[dtype]) and torch.allclose(vc.float(), vp.float(), **TOL[dtype]),
                f"attn_block_decode/{case}: slot row differs from the plain version's")
        others = torch.arange(s, device=dev) != slot
        require(torch.equal(kc[:, :, others], k0[:, :, others]) and torch.equal(vc[:, :, others], v0[:, :, others]),
                f"attn_block_decode/{case}: slots other than the new token's changed")

    # K3 xattn: q only over the cached media K/V (H = 8, Dh = 64, 64
    # latents), attn gate; row 3 has no preceding image: attention exactly
    # 0, so y == x there
    h, dh, s = 8, 64, 64
    wq, wo = rn(h * dh, d, scale=d**-0.5), rn(d, h * dh, scale=(h * dh) ** -0.5)
    km, vm = rn(B, h, s, dh), rn(B, h, s, dh)
    mask = torch.ones(B, s, dtype=torch.bool, device=dev)
    mask[3] = False
    kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, gate=gate)
    n_valid = mask.sum().item()
    cost = ((2 * h * dh * d + 2 * B * d + 2 * d + 1 + 2 * n_valid * h * dh) * es + B * s,
            4 * B * d * h * dh + 4 * h * dh * n_valid)
    a_in = rn(B, h * dh)
    yield ("attn_block_decode", "xattn_S64_gate",
           lambda: attn_block_decode(x, ln, ln_b, wq, wo, km, vm, mask, **kw),
           lambda: reference_attn_block(x, ln, ln_b, wq, wo, km, vm, mask, **kw),
           lambda got: torch.equal(got[3], x[3]), cost,
           lambda: (F.linear(hn, wq), F.linear(a_in, wo)), "F.linear for Wq and Wout: the products alone")

    # K4: self-attention prefill into the cache (H=16, Dh=128)
    for case, b, tq, s, q_off, pads in [
        ("prefill_S64", B, T_PROMPT, 64, 0, [4, 7]),
        ("q_offset16", B, T_PROMPT, 64, 16, [4, 7]),
        ("ragged_S257", 2, 257, 257, 0, [0, 257]),     # row 1: every key masked
    ]:
        h, d = 16, 128
        q, k, v = rn(b * h, tq, d), rn(b * h, s, d), rn(b * h, s, d)
        valid = left_padded_mask(b, s, pads, dev)
        valid[:, q_off + tq:] = False                   # unwritten cache slots
        pad = valid.repeat_interleave(h, 0)
        sl = slopes16.repeat(b)[:, None]
        qpos = q_off + torch.arange(tq, device=dev)[:, None]
        allowed = pad[:, None, :] & (torch.arange(s, device=dev)[None, :] <= qpos)[None]
        zero_rows = ~allowed.any(-1)
        fn = with_fma(lambda q=q, k=k, v=v, pad=pad, sl=sl, q_off=q_off: flash_attention(
                          q, k, v, pad, sl, q_off, True, d**-0.5),
                      lambda q=q, k=k, v=v, pad=pad, sl=sl, q_off=q_off: flash_attention_fma(
                          q, k, v, pad, sl, q_off, True, d**-0.5))
        plain = lambda q=q, k=k, v=v, pad=pad, sl=sl, q_off=q_off: reference_attention(q, k, v, pad, sl, q_off, True, d**-0.5)
        # K/V rows that the causal and pad masks let some query reach
        keys = allowed.any(1).sum().item()
        cost = ((2 * b * h * tq * d + 2 * keys * d) * es + b * h * s + 4 * b * h, 4 * d * allowed.sum().item())
        bias = torch.where(allowed, sl[:, :, None] * (torch.arange(s, device=dev) - (s - 1)).float(), float("-inf"))
        q4, k4, v4 = (x.view(b, h, -1, d) for x in (q, k, v))
        bias4 = bias.view(b, h, tq, s).to(dtype)
        lib = lambda q4=q4, k4=k4, v4=v4, bias4=bias4: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias4, scale=d**-0.5)
        yield "flash_attention", case, fn, plain, zeros_at(zero_rows), cost, lib, "scaled_dot_product_attention"

    # K5: gated xattn prefill (H=8, Dh=64, 64 latents per image)
    for case, t_img, media_at in [("prefill_T1", 1, [0]), ("prefill_T2", 2, [0, 16])]:
        h, d, n_lat, tq = 8, 64, 64, T_PROMPT
        s = t_img * n_lat
        q, k, v = rn(B * h, tq, d), rn(B * h, s, d), rn(B * h, s, d)
        loc = torch.zeros(B, tq, dtype=torch.int32, device=dev)
        for p in media_at:
            loc[:, p] = 1
        loc[0], loc[1] = 0, 0                            # left-padded rows: media after the pads
        for r, n in ((0, 4), (1, 7)):
            for p in media_at:
                loc[r, min(tq - 1, p + n)] = 1
        tt = torch.cumsum(loc, 1).to(torch.int32).repeat_interleave(h, 0)
        media_time = torch.arange(s, device=dev) // n_lat + 1
        allowed = tt[:, :, None] == media_time[None, None, :]
        zero_rows = ~allowed.any(-1)
        fn = with_fma(lambda q=q, k=k, v=v, tt=tt: masked_xattn(q, k, v, tt, n_lat, d**-0.5),
                      lambda q=q, k=k, v=v, tt=tt: masked_xattn_fma(q, k, v, tt, n_lat, d**-0.5))
        plain = lambda q=q, k=k, v=v, tt=tt: reference_masked_xattn(q, k, v, tt, n_lat, d**-0.5)
        keys = allowed.any(1).sum().item()
        cost = ((2 * B * h * tq * d + 2 * keys * d) * es + 4 * B * h * tq, 4 * d * allowed.sum().item())
        q4, k4, v4 = (x.view(B, h, -1, d) for x in (q, k, v))
        m4 = allowed.view(B, h, tq, s)
        lib = lambda q4=q4, k4=k4, v4=v4, m4=m4: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=d**-0.5)
        yield "masked_xattn", case, fn, plain, zeros_at(zero_rows), cost, lib, "scaled_dot_product_attention"

    yield from of3b_k7_cases(rn, es, dev, slopes16)


def of3b_k7_cases(rn, es, dev, slopes16):
    """K7 at OF-3B's unfused decode: the gated xattn over the cached media
    K/V (H 8, Dh 64, S 64, a row before any image) and the self-attention
    step writing slot 40 (H 16, Dh 128, ALiBi). Yields as kernel_cases."""
    # K7: xattn decode over the cached media K/V (H=8, Dh=64, S=64)
    h, d, s = 8, 64, 64
    q, k, v = rn(B, h, d), rn(B, h, s, d), rn(B, h, s, d)
    mask = torch.ones(B, s, dtype=torch.bool, device=dev)
    mask[3] = False                                      # text before any image
    zero_rows = torch.zeros(B, dtype=torch.bool, device=dev)
    zero_rows[3] = True
    fn = lambda: decode_attention(q, k, v, mask, scale=d**-0.5)
    plain = lambda: reference_decode_attention(q, k, v, mask, d**-0.5)
    n_valid = mask.sum().item()
    cost = ((2 * B * h * d + 2 * n_valid * h * d) * es + B * s, 4 * d * h * n_valid)
    q4, k4, v4, m4 = q[:, :, None], k, v, mask[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=d**-0.5)
    yield "decode_attention", "xattn_S64", fn, plain, zeros_at(zero_rows), cost, lib, "scaled_dot_product_attention"

    # K7 update: self-attention decode step writing slot 40 (H=16, Dh=128)
    h, d, s, slot = 16, 128, 64, 40
    q, kc, vc, kn, vn = rn(B, h, d), rn(B, h, s, d), rn(B, h, s, d), rn(B, h, d), rn(B, h, d)
    mask = left_padded_mask(B, s, [4, 7], dev)
    mask[:, slot + 1:] = False
    k0, v0 = kc.clone(), vc.clone()

    def plain_update():
        kp, vp = k0.clone(), v0.clone()
        kp[:, :, slot], vp[:, :, slot] = kn, vn
        return reference_decode_attention(q, kp, vp, mask, d**-0.5, slopes16)

    fn = lambda: decode_attention_update(q, kc, vc, kn, vn, mask, slot, scale=d**-0.5, slopes=slopes16)[0]
    n_valid = mask.sum().item()
    cost = ((2 * B * h * d + 2 * n_valid * h * d + 4 * B * h * d) * es + B * s, 4 * d * h * n_valid)
    yield "decode_attention_update", "self_S64_slot40", fn, plain_update, None, cost, None, None
    # the slot is written and nothing else moved
    require(torch.equal(kc[:, :, slot], kn) and torch.equal(vc[:, :, slot], vn), "update: slot not written")
    others = torch.arange(s, device=dev) != slot
    require(torch.equal(kc[:, :, others], k0[:, :, others]) and torch.equal(vc[:, :, others], v0[:, :, others]),
            "update: slots other than the new token's changed")


def neox_kernel_cases(dtype, gen, dev):
    """OF-4B's path (RedPajama-INCITE-3B: D = 2560, 32 heads of Dh = 80,
    biases, no ALiBi, untied head; xattn every second layer): K6
    attend_out_decode at its shapes and edge cases, and the shapes no
    OF-3B case gives K1-K4 and K7. Yields as kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    d, k2, v, h, dh, s = 2560, 10240, 50434, 32, 80, 64
    x, ln, ln_b = rn(B, d), 1 + rn(d, scale=0.1), rn(d, scale=0.1)
    hn = layer_norm(x, ln, ln_b)

    # K1: LN (with bias) + query_key_value + bias, N = 7680; the untied head
    wqkv, bqkv = rn(3 * d, d, scale=d**-0.5), rn(3 * d, scale=0.1)
    cost = ((3 * d * d + B * d + 2 * d + 3 * d + B * 3 * d) * es, 2 * B * 3 * d * d)
    yield ("fused_dense", "neox_qkv_bias", lambda: fused_dense(x, wqkv, bias=bqkv, ln_scale=ln, ln_bias=ln_b),
           lambda: reference_dense(x, wqkv, bias=bqkv, ln_scale=ln, ln_bias=ln_b), None, cost,
           lambda: F.linear(hn, wqkv, bqkv), "F.linear(LN(x), W, b): the product and bias alone")
    whead = rn(v, d, scale=d**-0.5)
    cost = ((v * d + B * d + 2 * d + B * v) * es, 2 * B * v * d)
    yield ("fused_dense", "neox_head_untied_V50434", lambda: fused_dense(x, whead, ln_scale=ln, ln_bias=ln_b),
           lambda: reference_dense(x, whead, ln_scale=ln, ln_bias=ln_b), None, cost, lambda: F.linear(hn, whead),
           "F.linear(LN(x), W): the product alone")

    # K2: the GPT-NeoX MLP with b1, b2 (sequential residual), and the xattn
    # FF at D = 2560 (LN bias, ff_gate, no biases)
    w1, w2, b1, b2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5), rn(k2, scale=0.1), rn(d, scale=0.1)
    cost = ((2 * d * k2 + 2 * B * d + 3 * d + k2) * es, 4 * B * d * k2)
    yield ("fused_mlp", "neox_mlp_bias",
           lambda: fused_mlp(x, w1, w2, b1=b1, b2=b2, ln_scale=ln, ln_bias=ln_b, residual=x),
           lambda: reference_mlp(x, w1, w2, b1=b1, b2=b2, ln_scale=ln, ln_bias=ln_b, residual=x), None, cost,
           lambda: F.linear(F.linear(hn, w1, b1), w2, b2), "F.linear twice with biases: the products alone")
    gate = torch.tensor([0.5], device=dev, dtype=dtype)
    cost = ((2 * d * k2 + 2 * B * d + 2 * d + 1) * es, 4 * B * d * k2)
    yield ("fused_mlp", "neox_xattn_ff", lambda: fused_mlp(x, w1, w2, ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate),
           lambda: reference_mlp(x, w1, w2, ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate), None, cost,
           lambda: F.linear(F.linear(hn, w1), w2), "F.linear twice: the two products alone")

    # K3 q only: gated xattn at D = 2560 (H = 8, Dh = 64, 64 latents), row 3
    # before any image: y == x there
    hx, dx = 8, 64
    wq, wo = rn(hx * dx, d, scale=d**-0.5), rn(d, hx * dx, scale=(hx * dx) ** -0.5)
    km, vm = rn(B, hx, s, dx), rn(B, hx, s, dx)
    mask = torch.ones(B, s, dtype=torch.bool, device=dev)
    mask[3] = False
    kw = dict(heads=hx, head_dim=dx, scale=dx**-0.5, gate=gate)
    n_valid = mask.sum().item()
    cost = ((2 * hx * dx * d + 2 * B * d + 2 * d + 1 + 2 * n_valid * hx * dx) * es + B * s,
            4 * B * d * hx * dx + 4 * hx * dx * n_valid)
    a_x = rn(B, hx * dx)
    yield ("attn_block_decode", "neox_xattn_S64_gate",
           lambda: attn_block_decode(x, ln, ln_b, wq, wo, km, vm, mask, **kw),
           lambda: reference_attn_block(x, ln, ln_b, wq, wo, km, vm, mask, **kw),
           lambda got: torch.equal(got[3], x[3]), cost,
           lambda: (F.linear(hn, wq), F.linear(a_x, wo)), "F.linear for Wq and Wout: the products alone")

    # K6: the self-attention tail of every layer (slot 40 after a 32-token
    # prompt with rows 0 and 1 left-padded; dense bias), then edge cases:
    # the slot at S - 1 with the whole epilogue, the slot at 0 alone, GQA
    # with two query heads per kv head, the q-only form with ALiBi and a row
    # with no valid key (exact zeros)
    wout, bout, res = rn(d, h * dh, scale=(h * dh) ** -0.5), rn(d, scale=0.1), rn(B, d)
    slopes32 = torch.from_numpy(alibi_slopes(h)).to(dev)
    a_in = rn(B, h * dh)
    for case, slot, n_rep, extra, masked_row in (
        ("neox_S64_slot40", 40, 1, dict(bias=bout), None),
        ("neox_S64_slot63_gate_residual", 63, 1, dict(bias=bout, gate=gate, residual=res), None),
        ("neox_S64_slot0", 0, 1, dict(bias=bout), None),
        ("neox_gqa2_S64_slot40", 40, 2, dict(bias=bout), None),
        ("neox_q_only_alibi_masked_row", None, 1, dict(slopes=slopes32), 3),
    ):
        h_kv = h // n_rep
        q, k0, v0 = rn(B, h, dh), rn(B, h_kv, s, dh), rn(B, h_kv, s, dh)
        kc, vc = k0.clone(), v0.clone()
        mask = left_padded_mask(B, s, [4, 7], dev)
        if slot is not None:
            mask[:, slot + 1:] = False
            if slot == 0:
                mask[:, 0] = True
            kn, vn = rn(B, h_kv, dh), rn(B, h_kv, dh)
            upd = dict(k_new=kn, v_new=vn, slot=torch.tensor([slot], dtype=torch.int32, device=dev))
        else:
            upd = {}
        if masked_row is not None:
            mask[masked_row] = False
        kw = dict(scale=dh**-0.5, **upd, **extra)
        fn, plain = k6_fns(q, (kc, vc, None, None), (k0, v0, None, None), mask, wout, kw, slot is not None)
        # Wout, the valid cache rows, q, the new K/V and out, bias/gate/
        # residual/slopes, mask and slot
        n_valid = mask.sum().item()
        elems = d * h * dh + 2 * n_valid * h_kv * dh + B * h * dh + B * d + 2 * B * h_kv * dh * (slot is not None)
        cost = (elems * es + sum(t.numel() * t.element_size() for t in extra.values()) + B * s
                + 4 * (slot is not None), 2 * B * d * h * dh + 4 * h * dh * n_valid)
        yield ("attend_out_decode", case, fn, plain, None if masked_row is None else zeros_at([masked_row]), cost,
               lambda: F.linear(a_in, wout, bout), "F.linear(a, Wout, b): the out-projection alone")
        if slot is not None:
            # the slot row holds the new K/V exactly and nothing else moved
            others = torch.arange(s, device=dev) != slot
            require(torch.equal(kc[:, :, slot], kn) and torch.equal(vc[:, :, slot], vn),
                    f"attend_out_decode/{case}: slot row not the new K/V")
            require(torch.equal(kc[:, :, others], k0[:, :, others]) and torch.equal(vc[:, :, others], v0[:, :, others]),
                    f"attend_out_decode/{case}: slots other than the new token's changed")

    yield from self_attention_cases(rn, es, dev, h, dh, "prefill_Dh80_noalibi", "neox_self_Dh80",
                                    "neox_self_S64_slot40")


def self_attention_cases(rn, es, dev, h, dh, prefill_case, self_case, update_case):
    """A decoder's self-attention without ALiBi (zero slopes, as
    ops/attention.py passes them) at H heads of Dh, B = 8: K4 prefill of the
    32-token prompt, and K7 over the 64-slot cache, with and without the
    update writing slot 40 (the unfused route). Yields as kernel_cases."""
    s = 64
    tq, hb = T_PROMPT, B * h
    q, k, v = rn(hb, tq, dh), rn(hb, s, dh), rn(hb, s, dh)
    valid = left_padded_mask(B, s, [4, 7], dev)
    valid[:, tq:] = False
    pad = valid.repeat_interleave(h, 0)
    sl = torch.zeros(hb, 1, dtype=torch.float32, device=dev)
    allowed = pad[:, None, :] & (torch.arange(s, device=dev)[None, :] <= torch.arange(tq, device=dev)[:, None])[None]
    keys = allowed.any(1).sum().item()
    cost = ((2 * hb * tq * dh + 2 * keys * dh) * es + hb * s + 4 * hb, 4 * dh * allowed.sum().item())
    q4, k4, v4, m4 = q.view(B, h, tq, dh), k.view(B, h, s, dh), v.view(B, h, s, dh), allowed.view(B, h, tq, s)
    fn = with_fma(lambda: flash_attention(q, k, v, pad, sl, 0, True, dh**-0.5),
                  lambda: flash_attention_fma(q, k, v, pad, sl, 0, True, dh**-0.5))
    yield ("flash_attention", prefill_case, fn,
           lambda: reference_attention(q, k, v, pad, sl, 0, True, dh**-0.5), zeros_at(~allowed.any(-1)), cost,
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=dh**-0.5),
           "scaled_dot_product_attention")

    slot = 40
    q, kc, vc, kn, vn = rn(B, h, dh), rn(B, h, s, dh), rn(B, h, s, dh), rn(B, h, dh), rn(B, h, dh)
    mask = left_padded_mask(B, s, [4, 7], dev)
    mask[:, slot + 1:] = False
    n_valid = mask.sum().item()
    cost = ((2 * B * h * dh + 2 * n_valid * h * dh) * es + B * s, 4 * dh * h * n_valid)
    q4, k4, v4, m4 = q[:, :, None], kc, vc, mask[:, None, None, :]
    yield ("decode_attention", self_case, lambda: decode_attention(q, kc, vc, mask, scale=dh**-0.5),
           lambda: reference_decode_attention(q, kc, vc, mask, dh**-0.5), None, cost,
           lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=dh**-0.5),
           "scaled_dot_product_attention")
    k0, v0 = kc.clone(), vc.clone()

    def plain_update():
        kp, vp = k0.clone(), v0.clone()
        kp[:, :, slot], vp[:, :, slot] = kn, vn
        return reference_decode_attention(q, kp, vp, mask, dh**-0.5)

    cost = ((2 * B * h * dh + 2 * n_valid * h * dh + 4 * B * h * dh) * es + B * s, 4 * dh * h * n_valid)
    yield ("decode_attention_update", update_case,
           lambda: decode_attention_update(q, kc, vc, kn, vn, mask, slot, scale=dh**-0.5)[0], plain_update, None,
           cost, None, None)
    require(torch.equal(kc[:, :, slot], kn) and torch.equal(vc[:, :, slot], vn), f"{update_case}: slot not written")


def k7_long_cases(dtype, gen, dev):
    """K7 at LLaMA-7B's longest cache (32 heads of Dh 128, S 2,048, left
    padding of 37 and 1,000 keys), B 1 and 8, both entry points (the update
    at the last slot). Each call reads the next of `l2_copies` identical
    cache copies (CUDA-graph replay included), so every call's K/V come from
    device memory, not the 50 MB L2. Then the NaN case: every masked K/V row
    (the padding, the slots past the new token, the unwritten slot itself
    for the update) holds NaN; the output must be finite and have the bits
    of the output over the same rows zeroed. Yields as kernel_cases."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    h, d, s, slot = 32, 128, K7_LONG_S, K7_LONG_S - 1
    for bsz in (1, 8):
        q, kn, vn, k0, v0 = rn(bsz, h, d), rn(bsz, h, d), rn(bsz, h, d), rn(bsz, h, s, d), rn(bsz, h, s, d)
        copies = [(k0.clone(), v0.clone()) for _ in range(l2_copies(2 * k0.numel() * es))]
        mask = left_padded_mask(bsz, s, [37, 1000][:bsz], dev)
        n_valid = mask.sum().item()
        m4 = mask[:, None, None, :]
        cost = ((2 * bsz * h * d + 2 * n_valid * h * d) * es + bsz * s, 4 * d * h * n_valid)
        yield ("decode_attention", f"llama_self_S2048_B{bsz}",
               rotating(copies, lambda kc, vc: decode_attention(q, kc, vc, mask, scale=d**-0.5)),
               rotating(copies, lambda kc, vc: reference_decode_attention(q, kc, vc, mask, d**-0.5)), None, cost,
               rotating(copies, lambda kc, vc: F.scaled_dot_product_attention(q[:, :, None], kc, vc, attn_mask=m4,
                                                                              scale=d**-0.5)),
               "scaled_dot_product_attention")

        def plain_update():
            kp, vp = k0.clone(), v0.clone()
            kp[:, :, slot], vp[:, :, slot] = kn, vn
            return reference_decode_attention(q, kp, vp, mask, d**-0.5)

        cost = ((2 * bsz * h * d + 2 * n_valid * h * d + 4 * bsz * h * d) * es + bsz * s, 4 * d * h * n_valid)
        yield ("decode_attention_update", f"llama_S2048_slot2047_B{bsz}",
               rotating(copies, lambda kc, vc: decode_attention_update(q, kc, vc, kn, vn, mask, slot,
                                                                       scale=d**-0.5)[0]),
               plain_update, None, cost, None, None)
        # the first copy (the compared call's) holds the new K/V at the slot and nothing else moved
        kc, vc = copies[0]
        others = torch.arange(s, device=dev) != slot
        require(torch.equal(kc[:, :, slot], kn) and torch.equal(vc[:, :, slot], vn), f"K7 S2048 B{bsz}: slot")
        require(torch.equal(kc[:, :, others], k0[:, :, others]) and torch.equal(vc[:, :, others], v0[:, :, others]),
                f"K7 S2048 B{bsz}: slots other than the new token's changed")

    bsz, slot = 2, 3 * s // 4
    q, kn, vn, k0, v0 = rn(bsz, h, d), rn(bsz, h, d), rn(bsz, h, d), rn(bsz, h, s, d), rn(bsz, h, s, d)
    mask = left_padded_mask(bsz, s, [37, 1000], dev)
    mask[:, slot + 1:] = False
    masked = ~mask[:, None, :, None]
    kz, vz = k0.masked_fill(masked, 0.0), v0.masked_fill(masked, 0.0)
    knan, vnan = k0.masked_fill(masked, float("nan")), v0.masked_fill(masked, float("nan"))
    n_valid = mask.sum().item()
    fn = lambda: decode_attention(q, knan, vnan, mask, scale=d**-0.5)
    cost = ((2 * bsz * h * d + 2 * n_valid * h * d) * es + bsz * s, 4 * d * h * n_valid)
    yield ("decode_attention", "llama_S2048_nan_masked_rows", fn,
           lambda: reference_decode_attention(q, kz, vz, mask, d**-0.5), None, cost, None, None)
    got = fn()
    require(bool(torch.isfinite(got).all()) and torch.equal(got, decode_attention(q, kz, vz, mask, scale=d**-0.5)),
            "decode_attention: NaN in masked K/V rows reached the output")
    knan[:, :, slot], vnan[:, :, slot] = float("nan"), float("nan")   # the slot not written yet

    def plain_update_nan():
        kp, vp = kz.clone(), vz.clone()
        kp[:, :, slot], vp[:, :, slot] = kn, vn
        return reference_decode_attention(q, kp, vp, mask, d**-0.5)

    fn = lambda: decode_attention_update(q, knan, vnan, kn, vn, mask, slot, scale=d**-0.5)[0]
    cost = ((2 * bsz * h * d + 2 * n_valid * h * d + 4 * bsz * h * d) * es + bsz * s, 4 * d * h * n_valid)
    yield "decode_attention_update", "llama_S2048_nan_masked_rows", fn, plain_update_nan, None, cost, None, None
    got = fn()
    want = decode_attention_update(q, kz.clone(), vz.clone(), kn, vn, mask, slot, scale=d**-0.5)[0]
    require(bool(torch.isfinite(got).all()) and torch.equal(got, want),
            "decode_attention_update: NaN in masked K/V rows reached the output")


def l2_copies(nbytes: int) -> int:
    """Copies of an input of `nbytes` to rotate over so that each call
    reads device memory: two more than fill twice the 50 MB L2, at least 2."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes) + 1)


def rotating(copies, call):
    """`call` on the next of `copies` (tuples of its arguments) each time."""
    turn = itertools.cycle(copies)
    return lambda: call(*next(turn))


def qweight(w, bits):
    """(stored weight, scale, their bytes): int8 (N, K), or int4 packed (N, K/2)."""
    q, sc = quantize_weight(w, bits)
    q = q if bits == 8 else pack_int4(q)
    return q, sc, q.numel() + 4 * sc.numel()


_ATTEND_KEYS = ("scale", "k_new", "v_new", "slot", "slopes")


def k6_fns(q, caches, originals, mask, wout, kw, update=True):
    """K6's call on `caches` (k, v, k_scale, v_scale; the slot written in
    place) and its plain version on copies of `originals`, each returning y.
    `fn.heads()` runs the call with its head outputs exposed (`attn_out`):
    (y, head outputs); `fn.plain_heads()` gives the plain attend's head
    outputs and the plain tail (head outputs -> y), for `heads_check`."""
    first = (lambda y: y[0]) if update else (lambda y: y)

    def call(**extra):
        return first(attend_out_decode(q, caches[0], caches[1], mask, wout, k_scale=caches[2], v_scale=caches[3],
                                       **kw, **extra))

    def copies():
        return [None if t is None else t.clone() for t in originals]

    def plain():
        c = copies()
        return first(reference_attend_out(q, c[0], c[1], mask, wout, k_scale=c[2], v_scale=c[3], **kw))

    def heads():
        out = torch.empty(q.shape[0], q.shape[1] * q.shape[2], dtype=q.dtype, device=q.device)
        return call(attn_out=out), out

    def plain_heads():
        c = copies()
        want = reference_attend(q, c[0], c[1], mask, wout, k_scale=c[2], v_scale=c[3],
                                **{key: val for key, val in kw.items() if key in _ATTEND_KEYS})
        tail_kw = {key: val for key, val in kw.items() if key not in _ATTEND_KEYS}
        return want, lambda got: reference_out_tail(got, wout, dtype=q.dtype, **tail_kw)

    fn = lambda: call()
    fn.heads, fn.plain_heads = heads, plain_heads
    return fn, plain


def heads_check(name, case, dtype, fn, exact) -> float:
    """K6 in bf16, held in two parts (CASE_TOL's note): the head outputs the
    kernel wrote against the plain attend's within TOL, then y against the
    plain tail over the kernel's head outputs within one ulp. Returns y's
    max abs error."""
    y, heads = fn.heads()
    torch.cuda.synchronize()
    want_heads, tail = fn.plain_heads()
    compare(f"{name}[heads]", case, dtype, heads, want_heads)
    return compare(name, case, dtype, y, tail(heads), exact, CASE_TOL[name][dtype])


def int8_slot_check(kernel, case, dtype, caches, plain_caches, originals, slot):
    """An int8 cache written at `slot` (K, V and their scales) against the
    plain version's: the slot's int8 entries equal but for one step at a
    rounding boundary (at most 0.1% of them), its scales within rtol (1e-5
    fp32; 1e-3 bf16, where the two versions' bf16 LayerNorm rows may round
    one element apart), every other slot unchanged."""
    s = caches[0].shape[2]
    others = torch.arange(s, device=caches[0].device) != slot
    diffs, scale_err = [], 0.0
    for got, want, orig in zip(caches, plain_caches, originals):
        if got.dtype == torch.int8:
            diffs.append((got[:, :, slot].int() - want[:, :, slot].int()).abs())
        else:
            scale_err = max(scale_err, ((got[:, :, slot] - want[:, :, slot]).abs() / want[:, :, slot]).max().item())
        require(torch.equal(got[:, :, others], orig[:, :, others]), f"{kernel}/{case}: slots other than the new token's changed")
    diff = torch.cat([d.flatten() for d in diffs])
    n_diff = int((diff > 0).sum())
    log({"phase": "kernels", "kernel": kernel, "case": case, "dtype": str(dtype).split(".")[-1],
         "int8_slot_entries_differing": n_diff, "of": diff.numel(), "max_step": int(diff.max()),
         "slot_scale_max_rel_err": scale_err})
    require(int(diff.max()) <= 1 and n_diff <= 1e-3 * diff.numel(), f"{kernel}/{case}: int8 slot row differs")
    require(scale_err <= (1e-5 if dtype == torch.float32 else 1e-3), f"{kernel}/{case}: slot scales differ")


def over_written_cache(x, ln, ln_b, wq, wout, caches, mask, kw):
    """Plain K3's y over an int8 cache as the kernel wrote it: the q-only
    form (Wqkv's q rows and their scales) over the kernel's caches
    (k, v, k_scale, v_scale), so both sides attend to the same new-token K/V
    row. A plain version that quantizes its own row may put an entry at a
    rounding boundary one int8 step the other way, which moves y by ~1e-3;
    the written row is held apart, against the plain version's
    (int8_slot_check)."""
    inner = kw["heads"] * kw["head_dim"]
    qkw = {key: val for key, val in kw.items() if key not in ("fused_qkv", "slot", "wq_scale")}
    return reference_attn_block(x, ln, ln_b, wq[:inner], wout, caches[0], caches[1], mask,
                                wq_scale=kw["wq_scale"][:inner], k_scale=caches[2], v_scale=caches[3], **qkw)


def quant_kernel_cases(dtype, gen, dev):
    """The quantized variants (int8 / packed int4 weights with per-channel
    scales, the int8 K/V and media caches) at the shapes of the quantized
    generate paths, and edge cases, then the B 64 pipe's K1 (the tied head
    in int8) and K2 (the MPT MLP in int4). K3's
    self-attention over the int8 cache is held in two parts: y against the
    plain version over the caches the kernel wrote (`over_written_cache`),
    the written slot row against the plain version's own
    (`int8_slot_check`). Yields as kernel_cases. No
    PyTorch call streams per-channel int weights with these epilogues: the
    library column times F.linear over the bf16 weight, the bare product at
    two or four times the bytes."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    def qkv8(*shape):      # an int8 cache and its (B, H, S) fp32 scales
        q, sc = quantize_kv(torch.randn(*shape, generator=gen, device=dev))
        return q, sc

    es = torch.tensor([], dtype=dtype).element_size()
    sfx = {8: "_int8", 4: "_int4"}
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    gate = torch.tensor([0.5], device=dev, dtype=dtype)

    # K1: the OF-3B tied head (int8 in every mode), OF-4B's untied head (int8)
    # and QKV + bias (int8 and int4)
    for case, d, v, ln_bias, bias, bits_list in (("head_V50434", 2048, 50434, False, False, (8,)),
                                                ("neox_head_untied_V50434", 2560, 50434, True, False, (8,)),
                                                ("neox_qkv_bias", 2560, 7680, True, True, (8, 4))):
        x, ln = rn(B, d), 1 + rn(d, scale=0.1)
        ln_b = rn(d, scale=0.1) if ln_bias else None
        b_ = rn(v, scale=0.1) if bias else None
        w = rn(v, d, scale=d**-0.5)
        hn = layer_norm(x, ln, ln_b)
        for bits in bits_list:
            q, sc, wbytes = qweight(w, bits)
            kw = dict(w_scale=sc, bias=b_, ln_scale=ln, ln_bias=ln_b)
            cost = (wbytes + (B * d + d * (1 + ln_bias) + v * bias + B * v) * es, 2 * B * v * d)
            yield ("fused_dense", case + sfx[bits], lambda x=x, q=q, kw=kw: fused_dense(x, q, **kw),
                   lambda x=x, q=q, kw=kw: reference_dense(x, q, **kw), None, cost,
                   lambda hn=hn, w=w, b_=b_: F.linear(hn, w, b_), "F.linear(LN(x), W) over the bf16 weight")

    # K2: OF-3B's MLP and xattn FF (int8, int4), OF-4B's MLP with biases (int8)
    for case, d, k2, xattn, biases, bits_list in (("mpt_mlp", 2048, 8192, False, False, (8, 4)),
                                                 ("xattn_ff", 2048, 8192, True, False, (8, 4)),
                                                 ("neox_mlp_bias", 2560, 10240, False, True, (8,))):
        x, ln = rn(B, d), 1 + rn(d, scale=0.1)
        ln_b = rn(d, scale=0.1) if (xattn or biases) else None
        w1, w2 = rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
        b1, b2 = (rn(k2, scale=0.1), rn(d, scale=0.1)) if biases else (None, None)
        hn = layer_norm(x, ln, ln_b)
        for bits in bits_list:
            (q1, s1, by1), (q2, s2, by2) = qweight(w1, bits), qweight(w2, bits)
            kw = dict(w1_scale=s1, w2_scale=s2, b1=b1, b2=b2, ln_scale=ln, ln_bias=ln_b, residual=x,
                      gate=gate if xattn else None)
            cost = (by1 + by2 + (2 * B * d + d * (1 + (ln_b is not None)) + (k2 + d) * biases + xattn) * es,
                    4 * B * d * k2)
            yield ("fused_mlp", case + sfx[bits], lambda x=x, q1=q1, q2=q2, kw=kw: fused_mlp(x, q1, q2, **kw),
                   lambda x=x, q1=q1, q2=q2, kw=kw: reference_mlp(x, q1, q2, **kw), None, cost,
                   lambda hn=hn, w1=w1, w2=w2, b1=b1, b2=b2: F.linear(F.linear(hn, w1, b1), w2, b2),
                   "F.linear twice over the bf16 weights")

    # K3 self (OF-3B: H 16, Dh 128, S 64, ALiBi): int8/int4 weights, with and
    # without the int8 cache, the slot at 40, 0 and 63 (clip_qkv there)
    d, h, dh, s = 2048, 16, 128, 64
    x, ln = rn(B, d), 1 + rn(d, scale=0.1)
    hn, a_in = layer_norm(x, ln, None), rn(B, d)
    wqkv, wout = rn(3 * d, d, scale=d**-0.5), rn(d, d, scale=d**-0.5)
    for bits in (8, 4):
        (qq, sq, byq), (qo, so, byo) = qweight(wqkv, bits), qweight(wout, bits)
        for kv8 in (False, True):
            for slot, clip in ((40, None), (0, None), (63, 1.0)):
                case = f"self_S64_slot{slot}" + sfx[bits] + ("_kv8" if kv8 else "")
                if kv8:
                    (k0, ks0), (v0, vs0) = qkv8(B, h, s, dh), qkv8(B, h, s, dh)
                else:
                    k0, v0, ks0, vs0 = rn(B, h, s, dh), rn(B, h, s, dh), None, None
                caches = [c.clone() if c is not None else None for c in (k0, v0, ks0, vs0)]
                mask = left_padded_mask(B, s, [4, 7], dev)
                mask[:, slot + 1:] = False
                if slot == 0:
                    mask[:, 0] = True
                kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True, clip=clip, slopes=slopes16,
                          slot=torch.tensor([slot], dtype=torch.int32, device=dev), wq_scale=sq, wout_scale=so)
                fn = lambda c=caches, mask=mask, kw=kw, qq=qq, qo=qo: attn_block_decode(
                    x, ln, None, qq, qo, c[0], c[1], mask, k_scale=c[2], v_scale=c[3], **kw)[0]

                def plain(o=(k0, v0, ks0, vs0), mask=mask, kw=kw, qq=qq, qo=qo):
                    c = [t.clone() if t is not None else None for t in o]
                    return reference_attn_block(x, ln, None, qq, qo, c[0], c[1], mask, k_scale=c[2], v_scale=c[3],
                                                **kw)[0]
                if kv8:    # y over the caches fn wrote: its slot row is held by int8_slot_check below
                    plain = lambda c=caches, mask=mask, kw=kw, qq=qq, qo=qo: over_written_cache(
                        x, ln, None, qq, qo, c, mask, kw)
                n_valid = mask.sum().item()
                ces = 1 if kv8 else es
                cost = (byq + byo + (2 * B * d + d) * es + 2 * (n_valid + B) * h * dh * ces
                        + 8 * (n_valid + B) * h * kv8 + B * s + 4, 8 * B * d * d + 4 * h * dh * n_valid)
                yield ("attn_block_decode", case, fn, plain, None, cost,
                       lambda: (F.linear(hn, wqkv), F.linear(a_in, wout)),
                       "F.linear for Wqkv and Wout over the bf16 weights")
                if kv8:    # the slot row written by fn's first call against the plain version's
                    pc = [t.clone() for t in (k0, v0, ks0, vs0)]
                    reference_attn_block(x, ln, None, qq, qo, pc[0], pc[1], mask, k_scale=pc[2], v_scale=pc[3], **kw)
                    int8_slot_check("attn_block_decode", case, dtype, caches, pc, (k0, v0, ks0, vs0), slot)

    # K3 q only over an int8 media cache (H 8, Dh 64, 64 latents), attn gate:
    # OF-3B (D 2048, int8 and int4 weights) and OF-4B (D 2560, int8); row 3
    # has no valid key, so y == x there
    hx, dx = 8, 64
    for case, d, bits in (("xattn_S64_gate", 2048, 8), ("xattn_S64_gate", 2048, 4), ("neox_xattn_S64_gate", 2560, 8)):
        x, ln, ln_b = rn(B, d), 1 + rn(d, scale=0.1), rn(d, scale=0.1)
        wq, wo = rn(hx * dx, d, scale=d**-0.5), rn(d, hx * dx, scale=(hx * dx) ** -0.5)
        (qq, sq, byq), (qo, so, byo) = qweight(wq, bits), qweight(wo, bits)
        (km, ks), (vm, vs) = qkv8(B, hx, s, dx), qkv8(B, hx, s, dx)
        mask = torch.ones(B, s, dtype=torch.bool, device=dev)
        mask[3] = False
        kw = dict(heads=hx, head_dim=dx, scale=dx**-0.5, gate=gate, wq_scale=sq, wout_scale=so, k_scale=ks,
                  v_scale=vs)
        n_valid = mask.sum().item()
        cost = (byq + byo + (2 * B * d + 2 * d + 1) * es + 2 * n_valid * hx * (dx + 4) + B * s,
                4 * B * d * hx * dx + 4 * hx * dx * n_valid)
        hn, a_x = layer_norm(x, ln, ln_b), rn(B, hx * dx)
        yield ("attn_block_decode", case + sfx[bits] + "_kv8",
               lambda x=x, ln=ln, ln_b=ln_b, qq=qq, qo=qo, km=km, vm=vm, mask=mask, kw=kw: attn_block_decode(
                   x, ln, ln_b, qq, qo, km, vm, mask, **kw),
               lambda x=x, ln=ln, ln_b=ln_b, qq=qq, qo=qo, km=km, vm=vm, mask=mask, kw=kw: reference_attn_block(
                   x, ln, ln_b, qq, qo, km, vm, mask, **kw),
               lambda got, x=x: torch.equal(got[3], x[3]), cost,
               lambda hn=hn, a_x=a_x, wq=wq, wo=wo: (F.linear(hn, wq), F.linear(a_x, wo)),
               "F.linear for Wq and Wout over the bf16 weights")

    # K6 (OF-4B: H 32, Dh 80, S 64, dense bias): int8 / int4 Wout, the int8
    # cache, GQA, the slot at 0 and 63, the q-only form with a key-less row
    d, h, dh = 2560, 32, 80
    wout, bout, res = rn(d, h * dh, scale=(h * dh) ** -0.5), rn(d, scale=0.1), rn(B, d)
    slopes32 = torch.from_numpy(alibi_slopes(h)).to(dev)
    a_in = rn(B, h * dh)
    for case, bits, kv8, slot, n_rep, extra, masked_row in (
        ("neox_S64_slot40", 8, True, 40, 1, dict(bias=bout), None),
        ("neox_S64_slot40", 4, False, 40, 1, dict(bias=bout), None),
        ("neox_S64_slot40", 8, False, 40, 1, dict(bias=bout), None),
        ("neox_S64_slot40", 4, True, 40, 1, dict(bias=bout), None),
        ("neox_S64_slot63_gate_residual", 8, True, 63, 1, dict(bias=bout, gate=gate, residual=res), None),
        ("neox_S64_slot0", 8, True, 0, 1, dict(bias=bout), None),
        ("neox_gqa2_S64_slot40", 8, True, 40, 2, dict(bias=bout), None),
        ("neox_q_only_alibi_masked_row", 8, True, None, 1, dict(slopes=slopes32), 3),
    ):
        h_kv = h // n_rep
        qo, so, byo = qweight(wout, bits)
        q = rn(B, h, dh)
        if kv8:
            (k0, ks0), (v0, vs0) = qkv8(B, h_kv, s, dh), qkv8(B, h_kv, s, dh)
        else:
            k0, v0, ks0, vs0 = rn(B, h_kv, s, dh), rn(B, h_kv, s, dh), None, None
        caches = [c.clone() if c is not None else None for c in (k0, v0, ks0, vs0)]
        mask = left_padded_mask(B, s, [4, 7], dev)
        upd = {}
        if slot is not None:
            mask[:, slot + 1:] = False
            mask[:, slot] = True
            upd = dict(k_new=rn(B, h_kv, dh), v_new=rn(B, h_kv, dh),
                       slot=torch.tensor([slot], dtype=torch.int32, device=dev))
        if masked_row is not None:
            mask[masked_row] = False
        kw = dict(scale=dh**-0.5, wout_scale=so, **upd, **extra)
        fn, plain = k6_fns(q, caches, (k0, v0, ks0, vs0), mask, qo, kw, slot is not None)
        n_valid = mask.sum().item()
        ces = 1 if kv8 else es
        upd_n = B * h_kv * (slot is not None)
        cost = (byo + (B * h * dh + B * d + 2 * upd_n * dh) * es + 2 * (n_valid * h_kv) * (dh * ces + 4 * kv8)
                + sum(t.numel() * t.element_size() for t in extra.values()) + B * s + 4 * (slot is not None),
                2 * B * d * h * dh + 4 * h * dh * n_valid)
        yield ("attend_out_decode", case + sfx[bits] + ("_kv8" if kv8 else ""), fn, plain,
               None if masked_row is None else zeros_at([masked_row]), cost,
               lambda: F.linear(a_in, wout, bout), "F.linear(a, Wout, b) over the bf16 weight")
        if kv8 and slot is not None:
            pc = [t.clone() for t in (k0, v0, ks0, vs0)]
            reference_attend_out(q, pc[0], pc[1], mask, qo, k_scale=pc[2], v_scale=pc[3], **kw)
            int8_slot_check("attend_out_decode", case, dtype, caches, pc, (k0, v0, ks0, vs0), slot)

    # the B 64 pipe's K1 and K2 (bench.py b64_i4_pipe): OF-3B's tied head in
    # int8, its MPT MLP in int4, all 64 rows in one pass of the weights
    b64, d, v, k2 = 64, 2048, 50434, 8192
    x, ln = rn(b64, d), 1 + rn(d, scale=0.1)
    hn = layer_norm(x, ln, None)
    w, w1, w2 = rn(v, d, scale=d**-0.5), rn(k2, d, scale=d**-0.5), rn(d, k2, scale=k2**-0.5)
    q, sc, wbytes = qweight(w, 8)
    cost = (wbytes + (b64 * d + d + b64 * v) * es, 2 * b64 * v * d)
    yield ("fused_dense", "head_V50434_int8_B64", lambda: fused_dense(x, q, w_scale=sc, ln_scale=ln),
           lambda: reference_dense(x, q, w_scale=sc, ln_scale=ln), None, cost, lambda: F.linear(hn, w),
           "F.linear(LN(x), W) over the bf16 weight")
    (q1, s1, by1), (q2, s2, by2) = qweight(w1, 4), qweight(w2, 4)
    kw = dict(w1_scale=s1, w2_scale=s2, ln_scale=ln, residual=x)
    cost = (by1 + by2 + (2 * b64 * d + d) * es, 4 * b64 * d * k2)
    yield ("fused_mlp", "mpt_mlp_int4_B64", lambda: fused_mlp(x, q1, q2, **kw), lambda: reference_mlp(x, q1, q2, **kw),
           None, cost, lambda: F.linear(F.linear(hn, w1), w2), "F.linear twice over the bf16 weights")

def pipe_k3_kernel_cases(dtype, gen, dev):
    """The B 64 pipe's K3 (bench.py b64_i4_pipe), int4 weights over caches
    in x's dtype, all 64 rows in one pass of the weights: MPT-1B's
    self-attention (slot 40 of 64, ALiBi, rows 0 and 1 left-padded) and the
    gated block over 64 latents (row 3 before any image: y == x there).
    Yields as kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)
    gate = torch.tensor([0.5], device=dev, dtype=dtype)
    b64, d = 64, 2048
    x, ln = rn(b64, d), 1 + rn(d, scale=0.1)
    hn = layer_norm(x, ln, None)
    h, dh, s = 16, 128, 64
    wqkv, wout = rn(3 * d, d, scale=d**-0.5), rn(d, d, scale=d**-0.5)
    (qq, sq, byq), (qo, so, byo) = qweight(wqkv, 4), qweight(wout, 4)
    k0, v0 = rn(b64, h, s, dh), rn(b64, h, s, dh)
    kc, vc = k0.clone(), v0.clone()
    mask = left_padded_mask(b64, s, [4, 7], dev)
    mask[:, 41:] = False
    kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True, slopes=slopes16, wq_scale=sq, wout_scale=so,
              slot=torch.tensor([40], dtype=torch.int32, device=dev))
    n_valid = mask.sum().item()
    a_in = rn(b64, d)
    cost = (byq + byo + (2 * b64 * d + d + 2 * (n_valid + b64) * h * dh) * es + b64 * s + 4,
            8 * b64 * d * d + 4 * h * dh * n_valid)
    yield ("attn_block_decode", "self_S64_slot40_int4_B64",
           lambda: attn_block_decode(x, ln, None, qq, qo, kc, vc, mask, **kw)[0],
           lambda: reference_attn_block(x, ln, None, qq, qo, k0.clone(), v0.clone(), mask, **kw)[0], None, cost,
           lambda: (F.linear(hn, wqkv), F.linear(a_in, wout)), "F.linear for Wqkv and Wout over the bf16 weights")
    hx, dx = 8, 64
    ln_b = rn(d, scale=0.1)
    wq, wo = rn(hx * dx, d, scale=d**-0.5), rn(d, hx * dx, scale=(hx * dx) ** -0.5)
    (qq, sq, byq), (qo, so, byo) = qweight(wq, 4), qweight(wo, 4)
    km, vm = rn(b64, hx, s, dx), rn(b64, hx, s, dx)
    mask = torch.ones(b64, s, dtype=torch.bool, device=dev)
    mask[3] = False
    kw = dict(heads=hx, head_dim=dx, scale=dx**-0.5, gate=gate, wq_scale=sq, wout_scale=so)
    n_valid = mask.sum().item()
    cost = (byq + byo + (2 * b64 * d + 2 * d + 1 + 2 * n_valid * hx * dx) * es + b64 * s,
            4 * b64 * d * hx * dx + 4 * hx * dx * n_valid)
    hn_b, a_x = layer_norm(x, ln, ln_b), rn(b64, hx * dx)
    yield ("attn_block_decode", "xattn_S64_gate_int4_B64",
           lambda: attn_block_decode(x, ln, ln_b, qq, qo, km, vm, mask, **kw),
           lambda: reference_attn_block(x, ln, ln_b, qq, qo, km, vm, mask, **kw),
           lambda got: torch.equal(got[3], x[3]), cost, lambda: (F.linear(hn_b, wq), F.linear(a_x, wo)),
           "F.linear for Wq and Wout over the bf16 weights")


def vit_kernel_cases(dtype, gen, dev):
    """The ViT-L/14 blocks' kernels (S 257, 16 heads of Dh 64, D 1024) at
    B = 8 and 32 images, as the block calls them: K9 vit_attention_heads on
    (B, S, H, Dh) views of the q/k/v projections' (B, S, D) outputs, K10
    layer_norm on the (B, S, D) residual stream with scale and bias; edge
    cases K9 at a ragged S 17 on the (BH, S, Dh) signature and K10 without a
    bias. Yields as kernel_cases."""
    def rn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale + shift).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    s, h, dh = VIT_L_14.num_patches + 1, VIT_L_14.num_heads, VIT_L_14.head_dim
    d = h * dh
    for case, b in (("vitl14_B8", B), ("vitl14_B32", 32)):
        q, k, v = (rn(b, s, d).view(b, s, h, dh) for _ in range(3))
        q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
        cost = (4 * b * s * d * es, 4 * b * h * s * s * dh)
        yield ("vit_attention", case, lambda q=q, k=k, v=v: vit_attention_heads(q, k, v, dh**-0.5),
               lambda q=q, k=k, v=v: reference_heads(q, k, v, dh**-0.5), None, cost,
               lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(q4, k4, v4, scale=dh**-0.5),
               "scaled_dot_product_attention on (B, H, S, Dh) views of the same q/k/v")
        x, sc, bi = rn(b, s, d, scale=2.0, shift=1.0), rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1)
        cost = ((2 * b * s * d + 2 * d) * es, 8 * b * s * d)
        yield ("layer_norm", case, lambda x=x, sc=sc, bi=bi: ln_op.layer_norm(x, sc, bi),
               lambda x=x, sc=sc, bi=bi: layer_norm(x, sc, bi), None, cost,
               lambda x=x, sc=sc, bi=bi: F.layer_norm(x, (d,), sc, bi, 1e-5), "F.layer_norm (two-pass variance)")
        if b == B:
            cost = ((2 * b * s * d + d) * es, 7 * b * s * d)
            yield ("layer_norm", "vitl14_B8_nobias", lambda x=x, sc=sc: ln_op.layer_norm(x, sc, None),
                   lambda x=x, sc=sc: layer_norm(x, sc, None), None, cost,
                   lambda x=x, sc=sc: F.layer_norm(x, (d,), sc, None, 1e-5), "F.layer_norm (two-pass variance)")
    bh, s17 = 8 * h, 17
    q, k, v = rn(bh, s17, dh), rn(bh, s17, dh), rn(bh, s17, dh)
    cost = (4 * bh * s17 * dh * es, 4 * bh * s17 * s17 * dh)
    q4, k4, v4 = (x.view(8, h, s17, dh) for x in (q, k, v))
    yield ("vit_attention", "S17", lambda: vit_attention(q, k, v, dh**-0.5),
           lambda: vit_op.reference_vit_attention(q, k, v, dh**-0.5), None, cost,
           lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=dh**-0.5), "scaled_dot_product_attention")


def absorb_kernel_cases(dtype, gen, dev):
    """The absorbed next-batch ViT's kernels at OF-3B's shapes. K8
    flat_vit_attention on the flat (B', S_pad 264, 1024) workspace with s_real
    257 at B' 8, 32 and the pipe's 64 (SDPA with the key mask on
    (B, H, S_pad, Dh) views beside it). K2b: each slot kind (q/k/v with
    LayerNorm 1 and bias; the out-projection with bias and the workspace residual; an fc1 slice, a row
    block of the (4096, 1024) weight; fc2 slices 0 and 1, column blocks of the
    (1024, 4096) weight read with its row stride, quick_gelu, the residual
    chain, the bias on slice 0) as a (2112, 1024) x (1024, 1024) tile on
    OF-3B's MPT MLP and xattn FF carriers, main weights in x's dtype, int8
    and int4: the side output against reference_side_tile, the carrier's
    own output bit for bit that of the launch without a side tile. A K2b
    case's `fn.carrier` is that launch alone (timed beside it: the exposed
    cost) and `fn.tile_cost` the tile's bytes and operations. Yields as
    kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    v = VIT_L_14
    s_real, h, dh, d = v.num_patches + 1, v.num_heads, v.head_dim, v.hidden_size
    s_pad = -(-s_real // 8) * 8
    for case, b in (("of3b_next_B8", B), ("of3b_next_B32", 32), ("of3b_next_B64", 64)):
        q, k, vv = (rn(b, s_pad, d) for _ in range(3))
        q4, k4, v4 = (t.view(b, s_pad, h, dh).transpose(1, 2) for t in (q, k, vv))
        keys = (torch.arange(s_pad, device=dev) < s_real)[None, None, None, :]
        cost = (4 * b * s_pad * d * es, 4 * b * h * s_pad * s_real * dh)
        yield ("flat_vit_attention", case,
               lambda q=q, k=k, vv=vv: flat_vit_attention(q, k, vv, dh**-0.5, heads=h, s_real=s_real),
               lambda q=q, k=k, vv=vv: reference_flat_vit_attention(q, k, vv, dh**-0.5, heads=h, s_real=s_real),
               None, cost,
               lambda q4=q4, k4=k4, v4=v4, keys=keys: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=keys, scale=dh**-0.5),
               "scaled_dot_product_attention on (B, H, S_pad, Dh) views with the key mask")

    # K2b on the OF-3B carriers (MPT-1B: D 2048, hidden 8192)
    dm, k2, m, inter = 2048, 8192, B * s_pad, v.intermediate_size
    x, ln, ln_b = rn(B, dm), 1 + rn(dm, scale=0.1), rn(dm, scale=0.1)
    gate = torch.tensor([0.5], device=dev, dtype=dtype)
    w1f, w2f = rn(k2, dm, scale=dm**-0.5), rn(dm, k2, scale=k2**-0.5)
    xw, att, res = rn(m, d, scale=2.0), rn(m, d), rn(m, d)
    w_qkv, w_fc1, w_fc2 = rn(d, d, scale=d**-0.5), rn(inter, d, scale=d**-0.5), rn(d, inter, scale=inter**-0.5)
    s_ln = (1 + rn(d, scale=0.1), rn(d, scale=0.1))
    bias, h_in = rn(d, scale=0.1), rn(m, d)
    slots = {
        "qkv": dict(side_x=xw, side_w=w_qkv, side_ln=s_ln, side_b=bias),
        "out": dict(side_x=att, side_w=w_qkv, side_b=bias, side_residual=res),
        "fc1": dict(side_x=xw, side_w=w_fc1[d:2 * d], side_ln=s_ln, side_b=bias),
        "fc2": dict(side_x=h_in, side_w=w_fc2[:, :d], side_act="quick_gelu", side_b=bias, side_residual=res),
        "fc2_1": dict(side_x=h_in, side_w=w_fc2[:, d:2 * d], side_act="quick_gelu", side_residual=res),
    }
    for wtag, bits in (("", None), ("_int8", 8), ("_int4", 4)):
        if bits is None:
            w1, w2, mkw, wbytes = w1f, w2f, {}, 2 * dm * k2 * es
        else:
            (w1, s1, n1), (w2, s2, n2) = qweight(w1f, bits), qweight(w2f, bits)
            mkw, wbytes = dict(w1_scale=s1, w2_scale=s2), n1 + n2
        for carrier, ckw in (("mpt_mlp", dict(ln_scale=ln, residual=x)),
                             ("xattn_ff", dict(ln_scale=ln, ln_bias=ln_b, residual=x, gate=gate))):
            ckw = dict(ckw, **mkw)
            main = lambda w1=w1, w2=w2, ckw=ckw: fused_mlp(x, w1, w2, **ckw)
            y0 = main()
            for slot, skw in slots.items():
                y, _ = fused_mlp(x, w1, w2, **ckw, **skw)
                require(torch.equal(y, y0), f"fused_mlp/{carrier}{wtag}_side_{slot}/{dtype}: the side tile moved y")
                fn = lambda w1=w1, w2=w2, ckw=ckw, skw=skw: fused_mlp(x, w1, w2, **ckw, **skw)[1]
                fn.carrier = main
                tile_bytes = (2 * m * d + d * d + 3 * d) * es + (m * d * es if "side_residual" in skw else 0)
                fn.tile_cost = (tile_bytes, 2 * m * d * d)
                carrier_bytes = wbytes + (2 * B * dm + 2 * dm) * es
                cost = (carrier_bytes + tile_bytes, 4 * B * dm * k2 + 2 * m * d * d)
                sx, sw = skw["side_x"], skw["side_w"]
                hn = layer_norm(sx, *s_ln) if "side_ln" in skw else sx
                lib = lambda w1=w1, w2=w2, hn=hn, sw=sw: (F.linear(F.linear(x, w1f), w2f), F.linear(hn, sw))
                yield ("fused_mlp", f"{carrier}{wtag}_side_{slot}", fn,
                       lambda skw=skw: reference_side_tile(skw["side_x"], skw["side_w"], **{
                           key: val for key, val in skw.items() if key not in ("side_x", "side_w")}),
                       None, cost, lib, "F.linear x3: the carrier's two products (bf16 weights) and the tile's alone")


def w8a8_near(skw):
    """The plain version's int8 activations of a W8A8 tile and the ones at a
    rounding boundary: (q_plain, s_act, near), `near` (M, K) True where the
    quotient act(LN?(x)) / s_act lies within W8A8_NEAR of a .5. Only there
    may the kernel's activation land one step away: its LayerNorm
    statistics and activation sum in another order (~1e-6 relative, ~1e-4
    of a step at |q| 127)."""
    sh = side_activations(skw["side_x"], skw.get("side_ln"), skw.get("side_eps", 1e-5), skw.get("side_act"))
    q_p, s_p = w8a8.quantize_activations(sh)
    mag = (sh / s_p).abs()
    return q_p, s_p, ((mag - mag.floor()) - 0.5).abs() < W8A8_NEAR


def identity_flips(tile, skw, q_p, s_p):
    """The W8A8 tile's int8 activations, read back: `tile(**kw)` (the
    kernel's launch) with side_w the int8 identity and unit scales, no bias
    or residual, gives q * s_act per element; divided by the plain version's
    s_act and rounded that is the kernel's q exactly (|q| <= 127 keeps 7
    bits, bf16 rounds q * s_act by at most 2^-9 of it). Returns
    |q_kernel - q_plain| per activation (int32, (M, K))."""
    sk = skw["side_x"].shape[1]
    eye = torch.eye(sk, dtype=torch.int8, device=skw["side_x"].device)
    ones = torch.ones(sk, dtype=torch.float32, device=eye.device)
    kw = {key: skw[key] for key in ("side_x", "side_ln", "side_act", "side_eps") if key in skw}
    so = tile(**kw, side_w=eye, side_w_scale=ones)
    return (torch.round(so.float() / s_p).int() - q_p.int()).abs()


def w8a8_allowance(near, s_act, side_w, side_w_scale, dtype):
    """The W8A8 tile's tolerance per element (M, SN), from the plain
    version's activations and the weights alone: each activation at a
    rounding boundary (`near`) may land one step apart and move the output
    by s_act * |w_q[n, k]| * w_scale[n] (with identical activations kernel
    and plain version round the same int32 sums at the same points, bit for
    bit), plus one rounding of the result (bf16: 2^-7 of it; fp32: 1e-6)."""
    reach = near.float() @ side_w.float().abs().t()
    return reach * s_act * side_w_scale[None], (2.0**-7 if dtype == torch.bfloat16 else 1e-6)


def w8a8_kernel_cases(dtype, gen, dev):
    """K2b int8, the W8A8 side tile, and K2b-attn, K3 as a carrier, at the
    OF-3B pipe's shapes: the decode batch and the next batch B 8 (a 2,112-row
    tile) and B 64 (16,896 rows, the pipe's); K = N = 1,024. At B 8 each slot
    kind with its int8 ViT weights and scales (q/k/v with LayerNorm 1 and
    bias; the out-projection with the workspace residual, a column block of a
    wider workspace (a row stride); an fc1 row block with LayerNorm 2; an fc2
    column block of the (1024, 4096) weight, read with its row stride, with
    quick_gelu, the bias and the residual chain) on OF-3B's MPT MLP carrier
    with bf16, int8 and int4 weights; the q/k/v and fc2 kinds on K3 (MPT's
    fused-QKV self-attention at slot 40 of 64 with ALiBi and clip, bf16,
    int4 and int8 over the int8 cache; the gated q-only block over 64
    latents, bf16 and int4), and K3 with the tile in x's dtype. At B 64 the
    pipe's int4 carriers with the q/k/v and fc2 kinds. Each case: the
    carrier's own outputs (y, and the caches K3 writes) bit for bit those of
    the launch without a tile; the kernel's int8 activations, read back by
    `identity_flips`, equal to the plain version's or one step apart at a
    rounding boundary (`w8a8_near`); the tile against reference_side_tile
    within `w8a8_allowance` of the plain version's boundary activations. `fn.carrier` is the launch alone;
    `fn.tile_cost` the tile's bytes and bf16-equivalent operations (int8
    runs at twice bf16's rate: 1,979 TOP/s). The library call: the
    carrier's products (F.linear, or K3 alone) and torch._int_mm on the
    pre-quantized operands with the two scale multiplies (F.linear for the
    tile in x's dtype). Yields as kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    v = VIT_L_14
    d, inter, s_pad = v.hidden_size, v.intermediate_size, -(-(v.num_patches + 1) // 8) * 8
    dm, k2 = 2048, 8192
    ln, ln_b = 1 + rn(dm, scale=0.1), rn(dm, scale=0.1)
    gate = torch.tensor([0.5], device=dev, dtype=dtype)
    w1f, w2f = rn(k2, dm, scale=dm**-0.5), rn(dm, k2, scale=k2**-0.5)
    (q_qkv, s_qkv), (q_fc1, s_fc1), (q_fc2, s_fc2) = (
        quantize_weight(w.float(), 8) for w in (rn(d, d, scale=d**-0.5), rn(inter, d, scale=d**-0.5),
                                                rn(d, inter, scale=inter**-0.5)))
    s_ln, bias, w_float = (1 + rn(d, scale=0.1), rn(d, scale=0.1)), rn(d, scale=0.1), rn(d, d, scale=d**-0.5)
    h, dh, s, slot = 16, 128, 64, 40            # MPT-1B's self-attention, slot 40 of 64
    hx, dhx, sx = 8, 64, 64                     # the gated block over 64 latents
    wqkv_f, wout_f = rn(3 * dm, dm, scale=dm**-0.5), rn(dm, dm, scale=dm**-0.5)
    wq_x, wo_x = rn(hx * dhx, dm, scale=dm**-0.5), rn(dm, hx * dhx, scale=(hx * dhx) ** -0.5)
    slot_t = torch.tensor([slot], dtype=torch.int32, device=dev)
    self_kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=True, slot=slot_t,
                   slopes=torch.from_numpy(alibi_slopes(h)).to(dev), clip=6.0)
    x_kw = dict(heads=hx, head_dim=dhx, scale=dhx**-0.5, gate=gate)
    stored = {bits: (qweight(w1f, bits), qweight(w2f, bits), qweight(wqkv_f, bits), qweight(wout_f, bits),
                     qweight(wq_x, bits), qweight(wo_x, bits)) for bits in (8, 4)}

    def plain(skw):
        return lambda: reference_side_tile(**skw)

    def at_batch(bd, sfx, mlp_bits, k3_forms, slot_kinds):
        """The cases at decode batch and next batch `bd`."""
        m = bd * s_pad
        x = rn(bd, dm)
        xw, att, h_in, res_wide = rn(m, d, scale=2.0), rn(m, d), rn(m, d), rn(m, 2 * d)
        slots = {
            "qkv": dict(side_x=xw, side_w=q_qkv, side_w_scale=s_qkv, side_ln=s_ln, side_b=bias),
            "out": dict(side_x=att, side_w=q_qkv, side_w_scale=s_qkv, side_b=bias, side_residual=res_wide[:, d:]),
            "fc1": dict(side_x=xw, side_w=q_fc1[d:2 * d], side_w_scale=s_fc1[d:2 * d], side_ln=s_ln, side_b=bias),
            "fc2": dict(side_x=h_in, side_w=q_fc2[:, d:2 * d], side_w_scale=s_fc2, side_act="quick_gelu",
                        side_b=bias, side_residual=res_wide[:, :d]),
        }
        tile_ops = 2 * m * d * d

        def tile_bytes(skw):
            """side_x and side_out, the weight (int8 with its scales, or in x's
            dtype), the vectors, the residual."""
            w = d * d + 4 * d if "side_w_scale" in skw else d * d * es
            return (2 * m * d + 3 * d + (m * d if "side_residual" in skw else 0)) * es + w

        def case(name, kernel, tile, carrier, skw, carrier_cost, carrier_lib, outputs):
            """One W8A8 case: `tile(**skw)` runs the carrier with the tile and
            returns its outputs with side_out last; `outputs()` the carrier's
            outputs without it."""
            got = tile(**skw)
            require(all(torch.equal(g, w) for g, w in zip(got[:-1], outputs())),
                    f"{kernel}/{name}/{dtype}: the side tile moved the carrier's outputs")
            q_p, s_act, near = w8a8_near(skw)
            steps = identity_flips(lambda **kw: tile(**kw)[-1], skw, q_p, s_act)
            n_flip, n_near, n_stray = int((steps > 0).sum()), int(near.sum()), int(((steps > 0) & ~near).sum())
            log({"phase": "kernels", "kernel": kernel, "case": name, "dtype": str(dtype).split(".")[-1],
                 "w8a8_activations_differing": n_flip, "of": steps.numel(), "near_boundary": n_near,
                 "differing_off_boundary": n_stray, "max_step": int(steps.max())})
            require(int(steps.max()) <= 1 and n_stray == 0,
                    f"{kernel}/{name}/{dtype}: {n_flip} int8 activations differ from the plain version's, "
                    f"{n_stray} of them off a rounding boundary, up to {int(steps.max())} steps")
            fn = lambda: tile(**skw)[-1]
            fn.carrier = carrier
            fn.tile_cost = (tile_bytes(skw), tile_ops / 2)
            fn.allow = w8a8_allowance(near, s_act, skw["side_w"], skw["side_w_scale"], dtype)
            # the library's tile: torch._int_mm on the pre-quantized rows and a contiguous copy of the weight
            q_pre, s_pre = w8a8.quantize_activations(side_activations(skw["side_x"], skw.get("side_ln"), 1e-5,
                                                                      skw.get("side_act")))
            wq = skw["side_w"].contiguous()
            lib = lambda: (carrier_lib(), torch._int_mm(q_pre, wq.t()).float() * s_pre * skw["side_w_scale"])
            return (kernel, name, fn, plain(skw), None, (carrier_cost[0] + tile_bytes(skw), carrier_cost[1] + tile_ops / 2),
                    lib, "the carrier's products (F.linear, or K3 alone) + torch._int_mm on the pre-quantized "
                    "operands and the two scale multiplies")

        # K2 carriers: MPT-1B's MLP
        for bits in mlp_bits:
            wtag = "" if bits is None else f"_int{bits}"
            if bits is None:
                w1, w2, mkw, wbytes = w1f, w2f, {}, 2 * dm * k2 * es
            else:
                (w1, s1, n1), (w2, s2, n2) = stored[bits][:2]
                mkw, wbytes = dict(w1_scale=s1, w2_scale=s2), n1 + n2
            ckw = dict(ln_scale=ln, residual=x, **mkw)
            main = lambda w1=w1, w2=w2, ckw=ckw: fused_mlp(x, w1, w2, **ckw)
            for slot_kind in slot_kinds:
                yield case(f"mpt_mlp{wtag}{sfx}_side8_{slot_kind}", "fused_mlp",
                           lambda w1=w1, w2=w2, ckw=ckw, **kw: fused_mlp(x, w1, w2, **ckw, **kw), main,
                           slots[slot_kind], (wbytes + (2 * bd * dm + 2 * dm) * es, 4 * bd * dm * k2),
                           lambda: F.linear(F.linear(x, w1f), w2f), lambda main=main: (main(),))

        # K3 carriers
        k0, v0 = rn(bd, h, s, dh), rn(bd, h, s, dh)
        mask = left_padded_mask(bd, s, [0, 3], dev)
        mask[:, slot + 1:] = False
        km, vm = rn(bd, hx, sx, dhx), rn(bd, hx, sx, dhx)
        mmask = torch.ones(bd, sx, dtype=torch.bool, device=dev)
        mmask[3] = False
        for form, bits, kv8 in k3_forms:
            wtag = ("" if bits is None else f"_int{bits}") + ("_kv8" if kv8 else "")
            if bits is None:
                wq, wo = (wqkv_f, wout_f) if form == "self" else (wq_x, wo_x)
                qkw, wbytes = {}, (wq.numel() + wo.numel()) * es
            else:
                (wq, sq, nq), (wo, so_, no) = stored[bits][2:4] if form == "self" else stored[bits][4:]
                qkw, wbytes = dict(wq_scale=sq, wout_scale=so_), nq + no
            if form == "self":
                if kv8:
                    (kq, ks), (vq, vs) = quantize_kv(k0.float()), quantize_kv(v0.float())
                    caches = (kq, vq, ks, vs)
                else:
                    caches = (k0.clone(), v0.clone(), None, None)
                kw = dict(self_kw, **qkw, k_scale=caches[2], v_scale=caches[3])
                n_valid = int(mask.sum())     # (b, s) cache rows read, each of H heads
                cache_bytes = 2 * n_valid * h * (dh + 4) if kv8 else 2 * n_valid * h * dh * es
                ccost = (wbytes + 2 * bd * dm * es + cache_bytes, 8 * bd * dm * dm + 4 * n_valid * h * dh)
                cname, mask_, lnb_ = f"self_S64_slot40{wtag}{sfx}", mask, None
            else:
                caches = (km, vm, None, None)
                kw = dict(x_kw, **qkw)
                n_valid = int(mmask.sum())
                ccost = (wbytes + (2 * bd * dm + 2 * n_valid * hx * dhx) * es,
                         4 * bd * dm * hx * dhx + 4 * n_valid * hx * dhx)
                cname, mask_, lnb_ = f"xattn_S64_gate{wtag}{sfx}", mmask, ln_b

            def k3(caches=caches, kw=kw, wq=wq, wo=wo, mask_=mask_, lnb_=lnb_, **skw):
                out = attn_block_decode(x, ln, lnb_, wq, wo, caches[0], caches[1], mask_, **kw, **skw)
                return out if isinstance(out, tuple) else (out,)

            # the carrier's outputs without a tile, from copies of the caches (K3 writes its slot in place)
            def outputs(caches=caches, kw=kw, wq=wq, wo=wo, mask_=mask_, lnb_=lnb_):
                c = [None if t is None else t.clone() for t in caches]
                kwc = dict(kw, **({"k_scale": c[2], "v_scale": c[3]} if c[2] is not None else {}))
                out = attn_block_decode(x, ln, lnb_, wq, wo, c[0], c[1], mask_, **kwc)
                return (out,) if not isinstance(out, tuple) else out

            carrier = lambda k3=k3: k3()[0]
            for slot_kind in ("qkv", "fc2"):
                yield case(f"{cname}_side8_{slot_kind}", "attn_block_decode", k3, carrier, slots[slot_kind], ccost,
                           carrier, outputs)
            if bits is None:     # K2b-attn with the tile in x's dtype
                float_tile = dict(side_x=xw, side_w=w_float, side_ln=s_ln, side_b=bias)
                got = k3(**float_tile)
                require(all(torch.equal(g, w) for g, w in zip(got[:-1], outputs())),
                        f"attn_block_decode/{cname}_side/{dtype}: the side tile moved the carrier's outputs")
                fn = lambda k3=k3, float_tile=float_tile: k3(**float_tile)[-1]
                fn.carrier = carrier
                fn.tile_cost = (tile_bytes(float_tile), tile_ops)
                hn = layer_norm(xw, *s_ln)
                yield ("attn_block_decode", f"{cname}_side", fn, plain(float_tile), None,
                       (ccost[0] + tile_bytes(float_tile), ccost[1] + tile_ops),
                       lambda carrier=carrier, hn=hn: (carrier(), F.linear(hn, w_float)),
                       "K3 alone + F.linear for the tile")

    yield from at_batch(B, "", (None, 8, 4), (("self", None, False), ("self", 4, False), ("self", 8, True),
                                              ("xattn", None, False), ("xattn", 4, False)), ("qkv", "out", "fc1", "fc2"))
    yield from at_batch(64, "_B64", (4,), (("self", 4, False), ("xattn", 4, False)), ("qkv", "fc2"))


def layer_kernel_cases(dtype, gen, dev):
    """K11 fused_layer_decode, a whole decode layer in one launch: OF-3B's
    MPT-1B layer (D 2048, 16 heads of Dh 128, MLP 8,192, ALiBi, slot 40 of a
    64-slot cache, rows 0 and 1 left-padded) and gated cross-attention layer
    (8 heads of Dh 64 over 64 media latents, LN biases, both tanh gates, row
    3 before any image) in x's dtype, int8 and int4, at B 8 and the MPT and
    xattn layers at B 1, 13 and 72 (two passes of 64 rows) too; MPT-7B's
    layer (OF-9B's LM: D 4096, 32 heads of Dh 128, MLP 16,384) in every
    weight type. Each case is held against reference_fused_layer on the card
    (y, and the written caches) and called three more times on fresh caches,
    which must give the same bits (a stale read of what another block wrote
    earlier in the launch would show now and then). In fp32, y and both
    caches are bit for bit those of the K3 + K2 kernel route; in bf16 the
    written caches are K3's bits and K11's fp32 x2 (`x2_out`) rounded to bf16
    is K3's output bit for bit (every phase on its separate launch's plan).
    The all-masked xattn row's y is bit for bit K2's on that row alone (x2 =
    x there). No one PyTorch call computes a layer (no library call);
    `fn.two_launch` is the K3 + K2 route on the same inputs, timed beside
    K11. Yields as kernel_cases."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    sfx = {None: "", 8: "_int8", 4: "_int4"}
    s, slot = 64, 40
    for case, b, dm, h, dh, k2, mpt, bits_list in (
            ("mpt_layer_S64_slot40", B, 2048, 16, 128, 8192, True, (None, 8, 4)),
            ("mpt_layer_B1_S64_slot40", 1, 2048, 16, 128, 8192, True, (None,)),
            ("mpt_layer_B13_S64_slot40", 13, 2048, 16, 128, 8192, True, (None,)),
            ("xattn_layer_S64", B, 2048, 8, 64, 8192, False, (None, 8, 4)),
            ("xattn_layer_B13_S64", 13, 2048, 8, 64, 8192, False, (None,)),
            ("mpt_layer_B72_S64_slot40", 72, 2048, 16, 128, 8192, True, (None,)),
            ("xattn_layer_B72_S64", 72, 2048, 8, 64, 8192, False, (None,)),
            ("mpt7b_layer_S64_slot40", B, 4096, 32, 128, 16384, True, (None, 8, 4))):
        inner = h * dh
        x, ln1, ln2 = rn(b, dm), 1 + rn(dm, scale=0.1), 1 + rn(dm, scale=0.1)
        ln1_b, ln2_b = (None, None) if mpt else (rn(dm, scale=0.1), rn(dm, scale=0.1))
        wf = dict(wq=rn((3 if mpt else 1) * inner, dm, scale=dm**-0.5), wout=rn(dm, inner, scale=inner**-0.5),
                  w1=rn(k2, dm, scale=dm**-0.5), w2=rn(dm, k2, scale=k2**-0.5))
        k0, v0 = rn(b, h, s, dh), rn(b, h, s, dh)
        kw = dict(heads=h, head_dim=dh, scale=dh**-0.5, fused_qkv=mpt)
        if mpt:
            mask = left_padded_mask(b, s, [4, 7][:b], dev)
            mask[:, slot + 1:] = False
            kw.update(slot=torch.tensor([slot], dtype=torch.int32, device=dev),
                      slopes=torch.from_numpy(alibi_slopes(h)).to(dev))
        else:
            mask = torch.ones(b, s, dtype=torch.bool, device=dev)
            mask[3 % b] = False
            kw.update(gate=torch.tensor([0.5], device=dev, dtype=dtype), gate2=torch.tensor([-0.3], device=dev,
                                                                                          dtype=dtype))
        n_valid = mask.sum().item()
        for bits in bits_list:
            if bits is None:
                ws, scales, wbytes = wf, {}, sum(w.numel() for w in wf.values()) * es
            else:
                stored = {name: qweight(w, bits) for name, w in wf.items()}
                ws = {name: q for name, (q, _, _) in stored.items()}
                scales = {f"{name}_scale": sc for name, (_, sc, _) in stored.items()}
                wbytes = sum(n for _, _, n in stored.values())
            lkw = dict(kw, **scales)
            attn_kw = {k: v for k, v in lkw.items() if k not in ("gate2", "w1_scale", "w2_scale")}
            mlp_kw = dict(ln_scale=ln2, ln_bias=ln2_b, gate=kw.get("gate2"), w1_scale=scales.get("w1_scale"),
                          w2_scale=scales.get("w2_scale"))
            name = f"fused_layer_decode/{case}{sfx[bits]}/{dtype}"

            def layer(kc, vc, ws=ws, lkw=lkw, mask=mask, x=x, x2_out=None):
                out = fused_layer_decode(x, ln1, ln1_b, ws["wq"], ws["wout"], kc, vc, mask, ws["w1"], ws["w2"], ln2,
                                         ln2_b, x2_out=x2_out, **lkw)
                return out if mpt else (out, kc, vc)

            def two_launch(kc, vc, ws=ws, attn_kw=attn_kw, mlp_kw=mlp_kw, mask=mask, x=x):
                """(y, k cache, v cache, K3's output) of the K3 + K2 route"""
                x2 = attn_block_decode(x, ln1, ln1_b, ws["wq"], ws["wout"], kc, vc, mask, **attn_kw)
                x2 = x2[0] if mpt else x2
                return fused_mlp(x2, ws["w1"], ws["w2"], residual=x2, **mlp_kw), kc, vc, x2

            x2 = torch.empty(b, dm, dtype=torch.float32, device=dev)
            got = layer(k0.clone(), v0.clone(), x2_out=x2)
            for _ in range(3):
                again = layer(k0.clone(), v0.clone())
                require(all(torch.equal(a, g) for a, g in zip(again, got)), f"{name}: a repeated call differs")
            kp, vp = k0.clone(), v0.clone()
            reference_fused_layer(x, ln1, ln1_b, ws["wq"], ws["wout"], kp, vp, mask, ws["w1"], ws["w2"], ln2, ln2_b,
                                  **lkw)
            require(torch.allclose(got[1].float(), kp.float(), **TOL[dtype])
                    and torch.allclose(got[2].float(), vp.float(), **TOL[dtype]),
                    f"{name}: the written caches differ from the plain version's")
            if mpt:
                others = torch.arange(s, device=dev) != slot
                require(torch.equal(got[1][:, :, others], k0[:, :, others])
                        and torch.equal(got[2][:, :, others], v0[:, :, others]),
                        f"{name}: slots other than the new token's changed")
            two = two_launch(k0.clone(), v0.clone())
            same = [torch.equal(a, t) for a, t in zip(got, two)]
            x2_is_k3 = torch.equal(x2.to(dtype), two[3])
            log({"phase": "kernels", "kernel": "fused_layer_decode", "case": case + sfx[bits],
                 "dtype": str(dtype).split(".")[-1], "bits_of_k3_then_k2": same, "x2_bits_of_k3": x2_is_k3,
                 "max_abs_diff_from_k3_then_k2": (got[0].float() - two[0].float()).abs().max().item()})
            if dtype == torch.float32:
                require(all(same), f"{name}: y and the caches are not bit for bit those of K3 then K2")
            require(all(same[1:]) and x2_is_k3, f"{name}: the written caches or x2 rounded are not K3's bits")
            exact = None
            if not mpt:
                r = 3 % b
                exact = lambda y, r=r, ws=ws, mlp_kw=mlp_kw, x=x: torch.equal(
                    y[r:r + 1], fused_mlp(x[r:r + 1], ws["w1"], ws["w2"], residual=x[r:r + 1], **mlp_kw))
            kc, vc = k0.clone(), v0.clone()
            fn = lambda kc=kc, vc=vc, layer=layer: layer(kc, vc)[0]
            fn.two_launch = lambda kc=kc, vc=vc, two_launch=two_launch: two_launch(kc, vc)[0]
            plain = lambda ws=ws, lkw=lkw, mask=mask, x=x: (lambda out: out[0] if mpt else out)(reference_fused_layer(
                x, ln1, ln1_b, ws["wq"], ws["wout"], k0.clone(), v0.clone(), mask, ws["w1"], ws["w2"], ln2, ln2_b,
                **lkw))
            vecs = (2 + 2 * (not mpt)) * dm + 2 * (not mpt)
            cost = (wbytes + (2 * b * dm + vecs + 2 * n_valid * inner + 2 * mpt * b * inner) * es + b * s,
                    2 * b * ((3 if mpt else 1) * inner * dm + dm * inner + 2 * k2 * dm) + 4 * inner * n_valid)
            yield "fused_layer_decode", case + sfx[bits], fn, plain, exact, cost, None, None


def vit_grad_checks(dev) -> None:
    """The autograd Functions of K9 and K10 (the kernel forward, the backward
    through the plain version) against plain autograd, fp32, at a small
    shape; the kernel forward counted once each."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    b, s, h, dh = 2, 17, 4, 64
    x, sc, bi, dy = rn(b, s, h * dh), 1 + 0.1 * rn(h * dh), 0.1 * rn(h * dh), rn(b, s, h * dh)
    q, k, v, do = (rn(b, s, h, dh) for _ in range(4))
    for name, fn, plain, args, grad_out in (
            ("vit_attention", lambda *a: vit_attention_heads(*a, dh**-0.5),
             lambda *a: reference_heads(*a, dh**-0.5), (q, k, v), do),
            ("layer_norm", ln_op.layer_norm, layer_norm, (x, sc, bi), dy)):
        grads = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in args]
            before = kernel_functions()[name].launches
            (f(*leaves) * grad_out).sum().backward()
            require(kernel_functions()[name].launches == before + (f is fn), f"{name}: the Function's forward launch")
            grads.append([leaf.grad for leaf in leaves])
        errs = [(g - w).abs().max().item() for g, w in zip(*grads)]
        log({"phase": "kernels", "kernel": name, "case": "autograd_fp32", "grad_max_abs_err": errs,
             "tol": BWD_TOL[torch.float32]})
        require(all(torch.allclose(g, w, **BWD_TOL[torch.float32]) for g, w in zip(*grads)),
                f"{name}: autograd gradients {errs}")


def phase_kernels(dev) -> dict:
    """Returns, per kernel, its bf16 numbers at each timed shape."""
    summary = {}
    functions = kernel_functions()
    vit_grad_checks(dev)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cases = itertools.chain(kernel_cases(dtype, gen, dev), neox_kernel_cases(dtype, gen, dev),
                                quant_kernel_cases(dtype, gen, dev), llama_opt_kernel_cases(dtype, gen, dev),
                                vit_kernel_cases(dtype, gen, dev), absorb_kernel_cases(dtype, gen, dev),
                                w8a8_kernel_cases(dtype, gen, dev), layer_kernel_cases(dtype, gen, dev),
                                pipe_k3_kernel_cases(dtype, gen, dev), k7_long_cases(dtype, gen, dev))
        for name, case, fn, plain, exact, cost, lib, lib_is in cases:
            got, launched = launched_variant(functions[name], fn)
            torch.cuda.synchronize()
            want = plain()
            if hasattr(fn, "heads") and dtype == torch.bfloat16:
                err = heads_check(name, case, dtype, fn, exact)
            else:
                err = compare(name, case, dtype, got, want, exact,
                              getattr(fn, "allow", None) or CASE_TOL.get(name, {}).get(dtype))
            vocab = re.search(r"_V(\d+)", case)
            if vocab:                                   # the ragged last columns, past the 2048-wide blocks
                c0 = int(vocab.group(1)) // 2048 * 2048
                tail = (got[:, c0:].float() - want[:, c0:].float()).abs().max().item()
                log({"phase": "kernels", "kernel": name, "case": case, "tail_cols": got.shape[1] - c0,
                     "tail_max_abs_err": tail})
                require(torch.allclose(got[:, c0:].float(), want[:, c0:].float(), **TOL[dtype]), "head tail")
            if dtype != torch.bfloat16:
                continue
            fma_err = fma_check(name, case, fn, want, exact) if hasattr(fn, "fma") else None
            if case not in TIMED_CASES:
                continue
            b_ms, b_by = bound(*cost, dtype)
            row = {"ms": device_ms(fn), "call_ms": call_ms(fn), "plain_ms": device_ms(plain),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None if lib is None else device_ms(lib),
                   "library_is": lib_is, "max_abs_err": err, "case": case, "variant": launched}
            if fma_err is not None:        # K4/K5: the FMA body the tensor-core body replaced, on the same inputs
                row["fma_ms"], row["fma_max_abs_err"] = device_ms(fn.fma), fma_err
            if hasattr(fn, "carrier"):      # K2b (and K2b-attn): the carrier launch alone, and the tile's own bound
                row["carrier_ms"] = device_ms(fn.carrier)
                row["exposed_ms"] = row["ms"] - row["carrier_ms"]
                row["tile_bound_ms"], row["tile_bound_by"] = bound(*fn.tile_cost, dtype)
            if hasattr(fn, "two_launch"):   # K11: the K3 + K2 kernel route on the same inputs
                row["two_launch_ms"] = device_ms(fn.two_launch)
            log({"phase": "kernels", "kernel": name, "timing": row})
            summary.setdefault(name, {})[case] = row
    # each side tile's exposed time (the launch with it less the carrier alone) beside the tile's own bound
    log({"phase": "kernels", "side_tiles": [
        {"kernel": name, "case": case, **{key: row[key] for key in ("exposed_ms", "tile_bound_ms", "tile_bound_by",
                                                                     "carrier_ms", "ms", "variant")}}
        for name, rows_ in summary.items() for case, row in rows_.items() if "exposed_ms" in row]})
    return summary


def fma_check(name, case, fn, want, exact) -> float:
    """K4/K5 in bf16: the FMA body (`fn.fma`) against the plain version
    under the same tolerance and exact zeros; its max abs error."""
    got = fn.fma()
    torch.cuda.synchronize()
    return compare(f"{name}[fma]", case, torch.bfloat16, got, want, exact)


def sdpa_backward(q, k, v, dout, b, h, attn_mask, scale):
    """The library's backward on the same inputs: torch.autograd.grad of one
    scaled_dot_product_attention output (forward run once, outside the
    timing) for dq, dk, dv. Returns (fn, stream): autograd runs a backward
    op on its forward's stream, so the forward runs on `stream` and the
    timing graph is captured there."""
    q4, k4, v4 = (x.detach().view(b, h, -1, x.shape[-1]).clone().requires_grad_(True) for x in (q, k, v))
    do4 = dout.view(b, h, -1, dout.shape[-1])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask, scale=scale)
    torch.cuda.current_stream().wait_stream(stream)
    return lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), stream


def sdpa_forward(q, k, v, b, h, attn_mask, scale):
    """The library's forward on the same inputs and mask (no lse output)."""
    q4, k4, v4 = (x.view(b, h, -1, x.shape[-1]) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask, scale=scale)


def attention_costs(allowed, tq, s, d, es, mask_bytes):
    """(bytes, FLOPs) of the forward with lse and of the backward for the
    allowed (BH, Tq, S) pairs: the forward reads q and the K/V rows some
    query reaches and writes out and lse, 4 Dh FLOPs per pair; the backward
    reads q, k, v, out, dout and lse and writes dq, dk, dv, 10 Dh FLOPs per
    pair (five products)."""
    bh, pairs = allowed.shape[0], allowed.sum().item()
    keys = allowed.any(1).sum().item()
    fwd = ((2 * bh * tq * d + 2 * keys * d) * es + 4 * bh * tq + mask_bytes, 4 * d * pairs)
    bwd = ((4 * bh * tq * d + 4 * bh * s * d) * es + 4 * bh * tq + mask_bytes, 10 * d * pairs)
    return fwd, bwd


def backward_cases(dtype, gen, dev):
    """Yields (name, case, fwd, plain_fwd, bwd, plain_bwd, allowed, costs,
    library): fwd() -> (out, lse); bwd(out, lse) -> (dq, dk, dv); allowed
    the (BH, Tq, S) pairs the mask lets through; library (timed cases only,
    else None) the SDPA backward, its stream and the SDPA forward."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    es = torch.tensor([], dtype=dtype).element_size()
    slopes16 = torch.from_numpy(alibi_slopes(16)).to(dev)

    # K4b: MPT self-attention, H = 16, Dh = 128, ALiBi
    h, d = 16, 128
    for case, b, tq, s, q_off, left, right in [
        ("laion_T32", B_L, T_L, T_L, 0, [], [(1, 5), (6, 9)]),
        ("mmc4_T256", B_M, T_M, T_M, 0, [], [(2, 20), (3, 37)]),
        ("left_pad_q_offset16", B, T_PROMPT, 64, 16, [4, 7], []),
        ("ragged_S257", 2, 257, 257, 0, [0, 257], []),     # row 1: every key masked
    ]:
        q, k, v, do = rn(b * h, tq, d), rn(b * h, s, d), rn(b * h, s, d), rn(b * h, tq, d)
        valid = left_padded_mask(b, s, left, dev)
        for r, n in right:
            valid[r, s - n:] = False
        valid[:, q_off + tq:] = False                    # unwritten cache slots
        pad = valid.repeat_interleave(h, 0)
        sl = slopes16.repeat(b)[:, None]
        qpos = q_off + torch.arange(tq, device=dev)[:, None]
        allowed = pad[:, None, :] & (torch.arange(s, device=dev)[None, :] <= qpos)[None]
        args = (pad, sl, q_off)
        lib = None
        if case in BWD_TIMED:
            bias = torch.where(allowed, sl[:, :, None] * (torch.arange(s, device=dev) - (s - 1)).float(), float("-inf"))
            bias4 = bias.view(b, h, tq, s).to(dtype)
            lib = (*sdpa_backward(q, k, v, do, b, h, bias4, d**-0.5), sdpa_forward(q, k, v, b, h, bias4, d**-0.5))
        yield ("flash_attention_backward", case,
               with_fma(lambda q=q, k=k, v=v, args=args: flash_attention_forward(
                            q, k, v, *args, True, d**-0.5, with_lse=True),
                        lambda q=q, k=k, v=v, args=args: flash_attention_fma(q, k, v, *args, True, d**-0.5, True)),
               lambda q=q, k=k, v=v, args=args: reference_attention(q, k, v, *args, True, d**-0.5, with_lse=True),
               with_fma(lambda o, lse, q=q, k=k, v=v, do=do, args=args: flash_attention_backward(
                            q, k, v, *args, o, lse, do, True, d**-0.5),
                        lambda o, lse, q=q, k=k, v=v, do=do, args=args: flash_attention_backward_fma(
                            q, k, v, *args, o, lse, do, True, d**-0.5)),
               lambda o, lse, q=q, k=k, v=v, do=do, args=args: reference_attention_backward(
                   q, k, v, *args, o, lse, do, True, d**-0.5),
               allowed, attention_costs(allowed, tq, s, d, es, b * h * s + 4 * b * h), lib)

    # K5b: gated xattn, H = 8, Dh = 64, 64 latents per image; LAION row 3
    # and every MMC4 row start with text before any image
    h, d, n_lat = 8, 64, 64
    for case, b, tq, media_at in [
        ("laion_T32", B_L, T_L, [0]),
        ("mmc4_T256", B_M, T_M, [3 + 42 * j for j in range(N_IMG)]),
    ]:
        s = len(media_at) * n_lat
        q, k, v, do = rn(b * h, tq, d), rn(b * h, s, d), rn(b * h, s, d), rn(b * h, tq, d)
        loc = torch.zeros(b, tq, dtype=torch.int32, device=dev)
        loc[:, media_at] = 1
        if case == "laion_T32":
            loc[3, 0], loc[3, 5] = 0, 1
        tt = torch.cumsum(loc, 1).to(torch.int32).repeat_interleave(h, 0)
        allowed = tt[:, :, None] == (torch.arange(s, device=dev) // n_lat + 1)[None, None, :]
        lib = None
        if case in BWD_TIMED:
            m4 = allowed.view(b, h, tq, s)
            lib = (*sdpa_backward(q, k, v, do, b, h, m4, d**-0.5), sdpa_forward(q, k, v, b, h, m4, d**-0.5))
        yield ("masked_xattn_backward", case,
               with_fma(lambda q=q, k=k, v=v, tt=tt: masked_xattn_forward(q, k, v, tt, n_lat, d**-0.5, with_lse=True),
                        lambda q=q, k=k, v=v, tt=tt: masked_xattn_fma(q, k, v, tt, n_lat, d**-0.5, True)),
               lambda q=q, k=k, v=v, tt=tt: reference_masked_xattn(q, k, v, tt, n_lat, d**-0.5, with_lse=True),
               with_fma(lambda o, lse, q=q, k=k, v=v, tt=tt, do=do: masked_xattn_backward(
                            q, k, v, tt, n_lat, o, lse, do, d**-0.5),
                        lambda o, lse, q=q, k=k, v=v, tt=tt, do=do: masked_xattn_backward_fma(
                            q, k, v, tt, n_lat, o, lse, do, d**-0.5)),
               lambda o, lse, q=q, k=k, v=v, tt=tt, do=do: reference_masked_xattn_backward(
                   q, k, v, tt, n_lat, o, lse, do, d**-0.5),
               allowed, attention_costs(allowed, tq, s, d, es, 4 * b * h * tq), lib)


def phase_backward(dev, summary: dict) -> None:
    """K4b and K5b against their plain versions (and the forward's lse), in
    fp32 and bf16; bf16 timings of the backward, and of the forward with
    lse at the train shapes, go into `summary`."""
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        for name, case, fwd, plain_fwd, bwd, plain_bwd, allowed, costs, lib in backward_cases(dtype, gen, dev):
            fwd_name = name.removesuffix("_backward")
            zero_q, zero_k = ~allowed.any(-1), ~allowed.any(1)
            out, lse = fwd()
            torch.cuda.synchronize()
            out_p, lse_p = plain_fwd()
            compare(fwd_name, f"train_{case}", dtype, out, out_p, zeros_at(zero_q))
            lse_err = (lse - lse_p).abs().max().item()
            log({"phase": "kernels", "kernel": fwd_name, "case": f"train_{case}", "lse_max_abs_err": lse_err,
                 "tol": LSE_TOL})
            require(torch.allclose(lse, lse_p, **LSE_TOL), f"{fwd_name}/{case}: lse err {lse_err}")
            require(bool((lse[zero_q] == 0).all()), f"{fwd_name}/{case}: lse of rows without keys not 0")
            fma_err = None
            if dtype == torch.bfloat16:     # the FMA body the tensor-core body replaced, on the same inputs
                out_f, lse_f = fwd.fma()
                torch.cuda.synchronize()
                fma_err = compare(f"{fwd_name}[fma]", f"train_{case}", dtype, out_f, out_p, zeros_at(zero_q))
                require(torch.allclose(lse_f, lse_p, **LSE_TOL), f"{fwd_name}[fma]/{case}: lse")
            # the same out and lse into both backward versions (bf16: and into
            # the FMA body the tensor-core body replaced)
            want = plain_bwd(out_p, lse_p)
            bodies = {name: bwd} | ({f"{name}[fma]": bwd.fma} if dtype == torch.bfloat16 else {})
            errs = {}
            for label, fn in bodies.items():
                got = fn(out_p, lse_p)
                torch.cuda.synchronize()
                errs[label] = max(compare(label, f"{case}_{part}", dtype, g, w, tol=BWD_TOL[dtype])
                                  for part, g, w in zip(("dq", "dk", "dv"), got, want))
                exact = (bool((got[0][zero_q] == 0).all()) and bool((got[1][zero_k] == 0).all())
                         and bool((got[2][zero_k] == 0).all()))
                log({"phase": "kernels", "kernel": label, "case": case, "dtype": str(dtype).split(".")[-1],
                     "rows_without_keys": int(zero_q.sum()), "keys_no_query_sees": int(zero_k.sum()),
                     "exact_zeros": exact})
                require(exact, f"{label}/{case}: dq of rows without keys or dk/dv of unseen keys not exactly 0")
            if dtype != torch.bfloat16 or case not in BWD_TIMED:
                continue
            b_ms, b_by = bound(*costs[1], dtype)
            row = {"ms": device_ms(lambda: bwd(out_p, lse_p)), "call_ms": call_ms(lambda: bwd(out_p, lse_p)),
                   "plain_ms": device_ms(lambda: plain_bwd(out_p, lse_p)), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": device_ms(lib[0], stream=lib[1]), "max_abs_err": errs[name], "case": case,
                   "fma_ms": device_ms(lambda: bwd.fma(out_p, lse_p)), "fma_max_abs_err": errs[f"{name}[fma]"],
                   "library_is": "torch.autograd.grad of scaled_dot_product_attention's output (same mask and "
                                 "ALiBi bias), its forward outside the timing"}
            log({"phase": "kernels", "kernel": name, "timing": row})
            summary.setdefault(name, {})[case] = row
            f_ms, f_by = bound(*costs[0], dtype)
            row = {"ms": device_ms(fwd), "call_ms": call_ms(fwd), "plain_ms": device_ms(plain_fwd), "bound_ms": f_ms,
                   "bound_by": f_by, "library_ms": device_ms(lib[2]),
                   "library_is": "scaled_dot_product_attention (same mask and ALiBi bias), without lse",
                   "max_abs_err": (out.float() - out_p.float()).abs().max().item(), "case": f"train_{case}_lse",
                   "fma_ms": device_ms(fwd.fma), "fma_max_abs_err": fma_err}
            log({"phase": "kernels", "kernel": fwd_name, "timing": row})
            summary.setdefault(fwd_name, {})[f"train_{case}_lse"] = row


# ---------------------------------------------------------------- the ViT


@torch.no_grad()
def vit_model(dev, dtype) -> VisionTransformer:
    """ViT-L/14 alone, random weights from SEED + 6 drawn in fp32 and cast:
    Linear weights N(0, 1/fan_in), CLIP's class and position embeddings
    N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.1^2), every bias N(0, 0.02^2)
    (so that K10's scale and bias do work)."""
    vit = VisionTransformer(VIT_L_14, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for name, p in vit.named_parameters():
        r = torch.randn(p.shape, generator=gen, device=dev)
        if "embedding" in name:
            p.copy_(0.02 * r)
        elif p.ndim == 2:
            p.copy_(r * p.shape[1] ** -0.5)
        elif name.endswith("weight"):
            p.copy_(1 + 0.1 * r)
        else:
            p.copy_(0.02 * r)
    return vit


@torch.no_grad()
def phase_vit(dev) -> dict:
    """ViT-L/14 forward (the vision encode of generate and of each train
    batch). fp32 at B = 8: the patch tokens with K9/K10 against plain_path()
    within VIT_RTOL of their largest entry, K9 24 and K10 48 launches. bf16 at
    B = 8 and 32: device time of one forward (CUDA-graph replay) with the
    kernels and on the plain route (`vit_plain_route`), in turns kernels,
    plain, plain, kernels. Returns {batch: numbers}."""
    px, layers = VIT_L_14.image_size, VIT_L_14.num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    vit = vit_model(dev, torch.float32)
    pixels = torch.randn(B, px, px, 3, generator=gen, device=dev)
    before = vit_attention.launches, ln_op.layer_norm.launches
    got = vit(pixels)
    launches = vit_attention.launches - before[0], ln_op.layer_norm.launches - before[1]
    require(launches == (layers, 2 * layers), f"ViT forward launches (K9, K10) {launches}")
    with plain_path():
        want = vit(pixels)
    require(got.shape == (B, VIT_L_14.num_patches, VIT_L_14.hidden_size) and torch.isfinite(got).all().item(),
            "ViT patch tokens")
    latents_agree("ViT-L/14 B8 patch tokens, kernels vs plain_path", got, want, phase="vit")
    del vit, got, want
    torch.cuda.empty_cache()

    vit = vit_model(dev, torch.bfloat16)
    result = {}
    for b in (B, 32):
        pixels = torch.randn(b, px, px, 3, generator=gen, device=dev)
        forward = lambda: vit(pixels)
        times = {"kernels": [], "plain": []}
        for route in ("kernels", "plain", "plain", "kernels"):
            with vit_plain_route() if route == "plain" else contextlib.nullcontext():
                times[route].append(device_ms(forward, reps=2, rounds=5))
        got = vit(pixels)
        with vit_plain_route():
            want = vit(pixels)
        row = {"vision_ms_kernels": sum(times["kernels"]) / 2, "vision_ms_plain": sum(times["plain"]) / 2,
               "runs_ms": times, "images": b, "tokens": b * (VIT_L_14.num_patches + 1),
               "bf16_kernels_vs_plain_max_abs_diff": (got.float() - want.float()).abs().max().item(),
               "bf16_tokens_max_abs": want.float().abs().max().item()}
        log({"phase": "vit", "dtype": "bfloat16", "batch": b, **row})
        require(torch.isfinite(got).all().item(), f"bf16 ViT tokens at B {b} not finite")
        result[b] = row
    del vit
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 3


def make_inputs(cfg, dev, b=B):
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # token ids below the added special tokens (LLaMA's 32,000, OPT's 50,265)
    ids = torch.randint(0, min(50277, cfg.media_token_id, cfg.eoc_token_id), (b, T_PROMPT), generator=gen, device=dev)
    mask = torch.ones(b, T_PROMPT, dtype=torch.long, device=dev)
    for r, n in ((0, 4), (1, 7)):                     # two left-padded rows
        ids[r, :n] = 0
        mask[r, :n] = 0
    first = mask.argmax(1)                              # media token first
    ids[torch.arange(b, device=dev), first] = cfg.media_token_id
    px = cfg.vision.image_size
    vision_x = torch.randn(b, 1, 1, px, px, 3, generator=gen, device=dev)
    return vision_x, ids, mask


def step_logits(model, latents, ids, mask, tokens, int8_kv=False, max_seq=T_PROMPT + NEW_TOKENS):
    """(N, B, V) logits on a fixed token stream `tokens` (B, N): at the last
    prompt position after prefill (K4, K5) into a cache of `max_seq` slots,
    then after each decode step that feeds tokens[:, t] back in (K1-K3 on
    the fused route, K7 on the unfused one), over an int8 cache with
    `int8_kv`."""
    logits, cache = prefill(model, latents, ids, mask, max_seq, int8_kv)
    require((cache.layers[0].k.dtype == torch.int8) == int8_kv, "the cache's dtype")
    out = [logits[:, -1]]
    n_media = count_media(ids, model.cfg.media_token_id)
    ones = torch.ones(tokens.shape[0], 1, dtype=torch.long, device=ids.device)
    for t in range(tokens.shape[1] - 1):
        logits, cache = model.decode_step(latents, tokens[:, t:t + 1], ones, cache, n_media)
        out.append(logits[:, 0])
    return torch.stack(out)


@contextlib.contextmanager
def unfused_route():
    """The unfused decode route: K7 decode attention with the eager
    projections, LayerNorms and MLP around it (`DISABLE_FUSED`)."""
    prev, dense_stream.DISABLE_FUSED = dense_stream.DISABLE_FUSED, True
    try:
        yield
    finally:
        dense_stream.DISABLE_FUSED = prev


def fp32_agree(what, tok_a, tok_b, la, lb, init_s=None):
    step_err = (la - lb).abs().amax(dim=(1, 2)).tolist()
    same = torch.equal(tok_a, tok_b)
    log({"phase": "generate", "dtype": "float32", "compare": what, "init_s": init_s,
         "logits_max_abs_err": max(step_err), "first_step_err": step_err[0], "first_decode_step_err": step_err[1],
         "last_step_err": step_err[-1], "tol": LOGITS_TOL, "logit_std": lb.std().item(), "tokens_equal": same,
         "distinct_tokens_per_row": [len(set(r)) for r in tok_a.tolist()],
         "first_mismatch_step": None if same else int((tok_a != tok_b).any(0).nonzero()[0].item())})
    require(max(step_err) <= LOGITS_TOL, f"fp32 {what}: logits differ by {max(step_err)} (per step: {step_err})")
    require(same, f"fp32 {what}: greedy tokens differ")


def latents_agree(what, got, want, phase="generate") -> None:
    """fp32 latents (or patch tokens) of two routes within VIT_RTOL of the
    largest entry."""
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    log({"phase": phase, "dtype": "float32", "compare": what, "latents_max_abs_err": err,
         "latents_max_abs": top, "rtol_of_max": VIT_RTOL})
    require(err <= VIT_RTOL * top, f"fp32 {what}: latents differ by {err} (largest entry {top})")


@contextlib.contextmanager
def vit_plain_route():
    """The ViT blocks on their einsum attention and plain LayerNorms on the
    card (both kernels' DISABLE hooks), the rest of the model unchanged."""
    prev = vit_op.DISABLE, ln_op.DISABLE
    vit_op.DISABLE = ln_op.DISABLE = True
    try:
        yield
    finally:
        vit_op.DISABLE, ln_op.DISABLE = prev


def reset_counters(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants.clear()


def timed_generate(model, vision_x, ids, mask, gcfg, dev, counters, route, seed=None):
    """One bf16 generate call with every launch counter (and the decode
    kernels' per-variant counts) reset just before and read just after;
    then vision encode and prefill timed alone. A sampled call (`seed`)
    draws from a generator seeded so, anew for each call. Returns
    (launches, variants)."""
    def call():
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        return flamingo_generate(model, vision_x, ids, mask, gcfg, generator=gen, device=dev)

    warm = call()
    torch.cuda.synchronize()
    reset_counters(counters)
    t0 = time.perf_counter()
    tokens = call()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
    t0 = time.perf_counter()
    lat16 = model.embed_vision(vision_x)
    torch.cuda.synchronize()
    vision_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lk16 = prefill(model, lat16, ids, mask, T_PROMPT + NEW_TOKENS, gcfg.int8_kv)[0][:, -1]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    log({"phase": "generate", "dtype": "bfloat16", "route": route, "seconds": dt,
         "tokens_per_s": B * NEW_TOKENS / dt, "vision_s": vision_s, "prefill_s": prefill_s,
         "decode_s": dt - vision_s - prefill_s, "decode_step_ms": (dt - vision_s - prefill_s) / (NEW_TOKENS - 1) * 1e3,
         "ttft_s": vision_s + prefill_s, "batch": B, "prompt": T_PROMPT, "new_tokens": NEW_TOKENS,
         "num_beams": gcfg.num_beams, "do_sample": gcfg.do_sample, "launches": launches, "variants": variants,
         "distinct_tokens_per_row": [len(set(r)) for r in tokens.tolist()], "tokens_row0": tokens[0].tolist()})
    require(tokens.shape == (B, NEW_TOKENS), "bf16 token shape")
    require(bool(((tokens >= 0) & (tokens < model.cfg.lm.vocab_size)).all().item()), "bf16 token ids out of range")
    require(torch.equal(tokens, warm), f"bf16 generate ({route}) is not deterministic")
    require(torch.isfinite(lk16).all().item(), "bf16 logits not finite")
    return launches, variants


def sync_free_step(model, vision_x, ids, mask, dev, int8_kv=False, route="fused") -> None:
    """One fused decode step under torch's sync debug mode "error": the step
    issues no host sync, so it can later be captured in a CUDA graph. With
    int8_kv the kernels quantize the new token into an int8 cache. `route`
    names the step's route in the log (a K11 form)."""
    lat = model.embed_vision(vision_x)
    logits, cache = prefill(model, lat, ids, mask, T_PROMPT + NEW_TOKENS, int8_kv)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    n_media = count_media(ids, model.cfg.media_token_id)
    ones = torch.ones(B, 1, dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    vit_before = vit_attention.launches, ln_op.layer_norm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(lat, tok, ones, cache, n_media)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    require((vit_attention.launches, ln_op.layer_norm.launches) == vit_before, "a ViT kernel launched in a decode step")
    log({"phase": "generate", "dtype": "bfloat16", "route": route, "decode_step_host_syncs": 0,
         "model": type(model.lm.blocks[0]).__name__, "int8_kv": int8_kv,
         "cache_dtype": str(cache.layers[0].k.dtype).split(".")[-1]})


# K1 launches per decoder layer and decode step on the fused route: MPT's
# K3 projects its own q/k/v, GPT-NeoX's fused QKV is one K1, llama's and
# OPT's q, k and v are three
K1_PER_LAYER = {"mpt": 0, "gptneox": 1, "llama": 3, "opt": 3}


def route_launches(cfg, counters, fused: bool, form=None) -> dict:
    """The launches one generate call must give: the vision encoded once, K9
    per ViT block and K10 twice; prefill K4 per decoder layer and K5 per
    xattn block; per decode step, on the fused route, MPT
    K3 + K2 per layer, GPT-NeoX K1 + K6 + K2, llama and OPT 3 K1 + K6 + K2,
    K3 + K2 per xattn block and K1 for the head; on the unfused route K7
    with the update per layer (without it over a grouped-query cache,
    repeated) and without it per xattn block. With a K11 `form` (MPT), K11
    in place of K3 + K2 in every block (`fused_layer`) or in the xattn
    blocks alone (`xattn_only`)."""
    steps, layers = NEW_TOKENS - 1, cfg.lm.num_layers
    xattn = layers // cfg.cross_attn_every_n
    mpt = cfg.lm.family == "mpt"
    want = {name: 0 for name in counters}
    want.update(flash_attention=layers, masked_xattn=xattn, vit_attention=cfg.vision.num_layers,
                layer_norm=2 * cfg.vision.num_layers)
    if fused:
        want.update(fused_dense=steps * (1 + layers * K1_PER_LAYER[cfg.lm.family]), fused_mlp=steps * (layers + xattn),
                    attn_block_decode=steps * (xattn + layers * mpt), attend_out_decode=steps * layers * (not mpt))
        if form is not None:
            k11 = steps * (xattn + layers * (form == "fused_layer"))
            want.update(fused_layer_decode=k11, fused_mlp=want["fused_mlp"] - k11,
                        attn_block_decode=want["attn_block_decode"] - k11)
    elif cfg.lm.kv_heads < cfg.lm.num_heads:
        want.update(decode_attention=steps * (xattn + layers))
    else:
        want.update(decode_attention=steps * xattn, decode_attention_update=steps * layers)
    return want


@torch.no_grad()
def random_lm_biases(model, seed) -> None:
    """Draw every bias of the LM's decoder blocks from N(0, 0.02^2) (a
    torch.Generator on the card, from `seed`, drawn in fp32): init_random
    leaves them 0, and GPT-NeoX's bias epilogues (K1, K6, K2) should do work
    in the checks."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.lm.blocks.named_parameters():
        if name.endswith(".bias"):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)


def build_model(cfg, dev, dtype):
    """Random weights from SEED (GPT-NeoX's decoder biases drawn too)."""
    model = init_random(cfg, SEED, device=dev, dtype=dtype)
    if cfg.lm.attention_bias:
        random_lm_biases(model, SEED + 4)
    return model


def factory_model(cfg, dev, dtype):
    """OF-3B through the port's entry point: create_model_and_transforms
    with the registry's names and random weights from SEED. Its config must
    be model_config("OF-3B")'s (<|endofchunk|> 50432, <image> 50433,
    vocabulary 50434) and its weights init_random's bit for bit."""
    model, _, _ = create_model_and_transforms("ViT-L-14", "openai", "mosaicml/mpt-1b-redpajama-200b",
                                              init_params=True, init_seed=SEED, device=dev, dtype=dtype)
    got, ref = model.state_dict(), init_random(cfg, SEED, device=dev, dtype=dtype).state_dict()
    same = list(got) == list(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    del ref
    torch.cuda.empty_cache()
    ids = (model.cfg.eoc_token_id, model.cfg.media_token_id, model.cfg.lm.vocab_size)
    log({"phase": "generate", "dtype": str(dtype).split(".")[-1], "check": "OF-3B from create_model_and_transforms",
         "config_equal": model.cfg == cfg, "eoc_media_vocab": ids, "weights_bit_equal_init_random": same,
         "tensors": len(got)})
    require(model.cfg == cfg and ids == (50432, 50433, 50434), f"create_model_and_transforms: config {model.cfg}")
    require(same, "create_model_and_transforms: weights differ from init_random(cfg, SEED)")
    return model


# K11's two forms on the fused route (the JAX package's hooks): every MPT and
# gated cross-attention block one launch, or the gated blocks alone
LAYER_FORMS = {"fused_layer": ("DISABLE", False), "xattn_only": ("XATTN_ONLY", True)}


@contextlib.contextmanager
def layer_form(form):
    """Decode with K11's `form` (a key of LAYER_FORMS); None: the default."""
    if form is None:
        yield
        return
    hook, value = LAYER_FORMS[form]
    prev = getattr(fl_op, hook)
    setattr(fl_op, hook, value)
    try:
        yield
    finally:
        setattr(fl_op, hook, prev)


def forms_in_turns(model, vision_x, ids, mask, gcfg, dev, name) -> None:
    """bf16 generate on the default fused route and K11's two forms, in turns
    (default, xattn_only, fused_layer, then back): host clock to a
    synchronize, which wanders between calls on this shared host."""
    order = [None, "xattn_only", "fused_layer"]
    times = {form or "default": [] for form in order}
    for form in order + order[::-1]:
        with layer_form(form):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
            torch.cuda.synchronize()
            times[form or "default"].append(time.perf_counter() - t0)
    log({"phase": "generate", "dtype": "bfloat16", "compare": f"{name} K11 forms in turns", "seconds": times,
         "tokens_per_s": {form: B * NEW_TOKENS * len(t) / sum(t) for form, t in times.items()}})


# beam search and sampling on OF-3B (phase generate): the eval harness's beam
# search (3 beams, length_penalty 0) and a sampled call with every filter
BEAMS, SAMPLE, SAMPLE_SEED = 3, dict(temperature=0.7, top_k=50, top_p=0.9), SEED + 5


def beam_recorder():
    """flamingo_generate's `observe` hook and what it records: each step's
    log-probs (B, K, V) and the chosen beams and tokens (B, K)."""
    rec = {"logprobs": [], "beams": [], "tokens": []}

    def observe(step, logprobs, beams, tokens):
        for key, val in (("logprobs", logprobs), ("beams", beams), ("tokens", tokens)):
            rec[key].append(val)

    return rec, observe


def forced_beam_logprobs(model, latents, ids, mask, gcfg, rec):
    """(steps, B, K, V) fp32 log-probs of a beam search forced onto `rec`'s
    beams and tokens: prefill at B, the cache repeated per beam, each step
    gathered to the recorded beams and fed the recorded tokens."""
    k, steps = gcfg.num_beams, gcfg.max_new_tokens
    logits, cache = prefill(model, latents, ids, mask, T_PROMPT + NEW_TOKENS)
    cache, logits = _repeat_beams(cache, k), logits[:, -1].repeat_interleave(k, dim=0)
    lat = latents.repeat_interleave(k, dim=0)
    n_media = count_media(ids, model.cfg.media_token_id).repeat_interleave(k, dim=0)
    ones = torch.ones(B * k, 1, dtype=torch.long, device=ids.device)
    out = []
    for step in range(steps):
        out.append(F.log_softmax(_process_logits(logits, step, gcfg).float(), dim=-1).reshape(B, k, -1))
        if step + 1 < steps:
            cache = _gather_beams(cache, rec["beams"][step], B, k)
            logits, cache = model.decode_step(lat, rec["tokens"][step].reshape(-1, 1), ones, cache, n_media)
            logits = logits[:, 0]
    return torch.stack(out)


def beam_tie_margin(rec_a, rec_b, logprobs, step):
    """At the first `step` where route b chose other beams than route a on
    the same history: how much worse a's choice scores than b's under b's
    log-probs (`logprobs`, b forced onto a's choices), the sorted live
    scores compared. A near tie gives a margin within the log-probs' error
    summed over the steps so far."""
    k = rec_a["beams"][0].shape[1]
    live = torch.full((B, k), NEG_INF, device=logprobs.device)
    live[:, 0] = 0.0
    for s in range(step):
        beams, toks = rec_a["beams"][s], rec_a["tokens"][s]
        live = torch.gather(live, 1, beams) + logprobs[s][torch.arange(B, device=live.device)[:, None], beams, toks]
    cand = (live[:, :, None] + logprobs[step]).reshape(B, -1)
    vocab = logprobs.shape[-1]

    def chosen(rec):
        return torch.gather(cand, 1, rec["beams"][step] * vocab + rec["tokens"][step]).sort(dim=1).values

    return (chosen(rec_b) - chosen(rec_a)).abs().max().item()


def beam_agree(what, tok_a, rec_a, tok_b, rec_b, lp_b) -> None:
    """Route a's beam search against route b's, in two parts: b's log-probs
    forced onto a's beams and tokens (`lp_b`) within LOGITS_TOL of a's at
    every step; the tokens equal, or, where a near tie tipped a choice, the
    first step where the choices part within the error those log-probs show
    (`beam_tie_margin`). Nothing else may part."""
    lp_a = torch.stack(rec_a["logprobs"])
    step_err = (lp_a - lp_b).abs().amax(dim=(1, 2, 3)).tolist()
    same = torch.equal(tok_a, tok_b)
    parted = next((s for s in range(len(step_err)) if not (torch.equal(rec_a["beams"][s], rec_b["beams"][s])
                                                           and torch.equal(rec_a["tokens"][s], rec_b["tokens"][s]))),
                  None)
    margin = allowed = None
    if not same and parted is not None:
        margin, allowed = beam_tie_margin(rec_a, rec_b, lp_b, parted), 2 * (parted + 1) * max(step_err)
    log({"phase": "generate", "dtype": "float32", "compare": what, "logprobs_max_abs_err": max(step_err),
         "first_step_err": step_err[0], "last_step_err": step_err[-1], "tol": LOGITS_TOL, "tokens_equal": same,
         "first_parted_step": parted, "tie_margin": margin, "tie_allowed": allowed})
    require(max(step_err) <= LOGITS_TOL, f"fp32 {what}: log-probs differ by {max(step_err)} (per step: {step_err})")
    require(same or (margin is not None and margin <= allowed),
            f"fp32 {what}: beam tokens differ (first parted step {parted}, margin {margin}, allowed {allowed})")


def sample_agree(what, tok_a, tok_b, la, lb, gcfg, dev) -> None:
    """Route a's sampled tokens against route b's (the same generator seed):
    b's step logits on a's token stream (`lb`) within LOGITS_TOL of a's
    (`la`); the tokens equal, or at the first step where they part, b's
    draw (filtered logits + the same Gumbel noise) at a's token within the
    logits' error of its draw at b's own."""
    step_err = (la - lb).abs().amax(dim=(1, 2)).tolist()
    same = torch.equal(tok_a, tok_b)
    parted = None if same else int((tok_a != tok_b).any(0).nonzero()[0].item())
    margin = allowed = None
    if parted is not None:
        noise = gumbel_noise(torch.Generator(device=dev).manual_seed(SAMPLE_SEED))
        for s in range(parted + 1):
            g = noise(s, la[s].shape)
        z = _filter_logits(lb[parted], gcfg) + g
        rows = (tok_a[:, parted] != tok_b[:, parted]).nonzero()[:, 0]
        margin = (z[rows, tok_b[rows, parted]] - z[rows, tok_a[rows, parted]]).abs().max().item()
        allowed = 2 * step_err[parted] / gcfg.temperature
    log({"phase": "generate", "dtype": "float32", "compare": what, "logits_max_abs_err": max(step_err),
         "tol": LOGITS_TOL, "tokens_equal": same, "first_parted_step": parted, "draw_margin": margin,
         "draw_allowed": allowed, "distinct_tokens_per_row": [len(set(r)) for r in tok_a.tolist()]})
    require(max(step_err) <= LOGITS_TOL, f"fp32 {what}: logits differ by {max(step_err)} (per step: {step_err})")
    require(same or margin <= allowed, f"fp32 {what}: sampled tokens differ at step {parted} (margin {margin})")


def search_checks(model, vision_x, ids, mask, dev, greedy, latents, latents_p):
    """fp32 beam search and sampling on OF-3B: the fused route's kernels
    against plain_path() (beams also against the unfused route, K7). eos is
    the token the greedy stream emits most often, so that hypotheses finish.
    Returns the beam and sampling GenerationConfigs."""
    eos = int(torch.bincount(greedy.flatten()).argmax().item())
    bcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, num_beams=BEAMS, length_penalty=0.0, eos_token_id=eos,
                            pad_token_id=0)
    routes = {"kernels": (contextlib.nullcontext, latents), "plain_path": (plain_path, latents_p),
              "unfused": (unfused_route, latents)}
    runs = {}
    for route, (ctx, _) in routes.items():
        rec, observe = beam_recorder()
        with ctx():
            runs[route] = flamingo_generate(model, vision_x, ids, mask, bcfg, observe=observe, device=dev), rec
    tok_k, rec_k = runs["kernels"]
    log({"phase": "generate", "dtype": "float32", "check": f"OF-3B beam {BEAMS}", "eos_token_id": eos,
         "rows_ending_on_eos": int((tok_k == eos).any(1).sum().item()),
         "eos_among_live_choices": int(sum(int((t == eos).sum().item()) for t in rec_k["tokens"])),
         "differs_from_greedy": not torch.equal(tok_k, greedy),
         "distinct_tokens_per_row": [len(set(r)) for r in tok_k.tolist()]})
    for route in ("plain_path", "unfused"):
        ctx, lat = routes[route]
        with ctx():
            lp = forced_beam_logprobs(model, lat, ids, mask, bcfg, rec_k)
        beam_agree(f"OF-3B beam {BEAMS} kernels vs {route}", tok_k, rec_k, *runs[route], lp)
    del runs, lp
    scfg = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=True, pad_token_id=0, **SAMPLE)
    tok = {}
    for route in ("kernels", "plain_path"):
        with routes[route][0]():
            gen = torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
            tok[route] = flamingo_generate(model, vision_x, ids, mask, scfg, generator=gen, device=dev)
    lk = step_logits(model, latents, ids, mask, tok["kernels"])
    with plain_path():
        lp = step_logits(model, latents_p, ids, mask, tok["kernels"])
    log({"phase": "generate", "dtype": "float32", "check": "OF-3B sampled", **SAMPLE,
         "differs_from_greedy": not torch.equal(tok["kernels"], greedy)})
    sample_agree("OF-3B sampled kernels vs plain_path", tok["kernels"], tok["plain_path"], lk, lp, scfg, dev)
    return bcfg, scfg


def searches_in_turns(model, vision_x, ids, mask, greedy_cfg, search_cfgs, dev) -> None:
    """bf16 greedy, beam and sampled generate on the fused route in turns
    (greedy, beams, sampling, then back): host clock to a synchronize, which
    wanders between calls on this shared host."""
    cfgs = {"greedy": (greedy_cfg, None), "beam": (search_cfgs[0], None), "sample": (search_cfgs[1], SAMPLE_SEED)}
    times = {name: [] for name in cfgs}
    for name in list(cfgs) + list(cfgs)[::-1]:
        gcfg, seed = cfgs[name]
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flamingo_generate(model, vision_x, ids, mask, gcfg, generator=gen, device=dev)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    log({"phase": "generate", "dtype": "bfloat16", "compare": "OF-3B greedy, beam, sampled in turns", "seconds": times,
         "tokens_per_s": {name: B * NEW_TOKENS * len(t) / sum(t) for name, t in times.items()}})


def gather_ms(model, dev) -> dict:
    """Device time of one beam step's cache gather on OF-3B's cache in the
    model's dtype (B 8 x 3 beams, half the new tokens written), beside the
    bytes it moves (index_select reads and writes the written slots, copy_
    again) over the card's memory rate."""
    cache = KVCache.create(model.cfg.lm, B * BEAMS, T_PROMPT + NEW_TOKENS, model.dtype, dev)
    cache = dataclasses.replace(cache, index=T_PROMPT + NEW_TOKENS // 2)
    idx = torch.randint(0, BEAMS, (B, BEAMS), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    ms = device_ms(lambda: _gather_beams(cache, idx, B, BEAMS))
    written = sum(x[:, :, :cache.index].numel() * x.element_size() for kv in cache.layers for x in (kv.k, kv.v))
    return {"gather_ms": ms, "gather_bytes": 4 * written, "gather_bound_ms": 4 * written / HBM_BYTES_PER_S * 1e3}


@torch.no_grad()   # generation: the forward is differentiable, nothing here needs a graph
def phase_generate(dev, name="OF-3B"):
    counters = kernel_functions()
    cfg = model_config(name)
    vision_x, ids, mask = make_inputs(cfg, dev)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)

    def build(dtype):      # OF-3B through the entry point a user calls
        return factory_model(cfg, dev, dtype) if name == "OF-3B" else build_model(cfg, dev, dtype)

    # fp32: (a) fused route, kernels vs plain versions; (b) fused vs unfused route
    t0 = time.perf_counter()
    model = build(torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # each route encodes the images itself (the ViT's K9/K10 or their plain
    # versions) and computes its step logits from its own latents
    latents = model.embed_vision(vision_x)
    lat_shape = (B, 1, cfg.num_vis_latents, cfg.vision.hidden_size)
    require(latents.shape == lat_shape and torch.isfinite(latents).all().item(), "latents")
    tok_k = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
    lk = step_logits(model, latents, ids, mask, tok_k)   # every step's logits on the kernels' token stream
    require(torch.isfinite(lk).all().item(), "fp32 fused-route logits not finite")
    with plain_path():
        latents_p = model.embed_vision(vision_x)
        tok_p = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
        lp = step_logits(model, latents_p, ids, mask, tok_k)
    latents_agree(f"{name} kernels vs plain_path", latents, latents_p)
    fp32_agree(f"{name} fused kernels vs plain_path", tok_k, tok_p, lk, lp, init_s)
    with unfused_route():
        latents_u = model.embed_vision(vision_x)
        tok_u = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
        lu = step_logits(model, latents_u, ids, mask, tok_k)
    require(torch.equal(latents_u, latents), f"{name}: the unfused route's latents differ from the fused route's")
    fp32_agree(f"{name} fused route vs unfused route (K7)", tok_k, tok_u, lk, lu)
    forms = LAYER_FORMS if name == "OF-3B" else {}
    for form in forms:      # K11: the same tokens, and in fp32 the same sums as K3 + K2
        with layer_form(form):
            tok_f = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
            lf = step_logits(model, latents, ids, mask, tok_k)
        log({"phase": "generate", "dtype": "float32", "compare": f"{name} {form} (K11) vs the default fused route",
             "logits_bit_equal": torch.equal(lf, lk)})
        fp32_agree(f"{name} {form} (K11) vs the default fused route", tok_f, tok_k, lf, lk)
        fp32_agree(f"{name} {form} (K11) vs plain_path", tok_f, tok_p, lf, lp)
    if name == "OF-3B":
        search_cfgs = search_checks(model, vision_x, ids, mask, dev, tok_k, latents, latents_p)
    del model, latents, latents_p, latents_u
    torch.cuda.empty_cache()

    # bf16, the serving dtype, timed: (c) fused route, (d) unfused route
    model = build(torch.bfloat16)
    fused, variants = timed_generate(model, vision_x, ids, mask, gcfg, dev, counters, f"{name} fused")
    want = route_launches(cfg, counters, fused=True)
    require(fused == want, f"{name} fused route launches {fused}, expected {want}")
    sync_free_step(model, vision_x, ids, mask, dev)
    more, more_variants = {}, {}
    if name == "OF-3B":    # beams at B x 3 decode rows, sampling: the fused route's launches, prefill at B
        for path, gcfg_x, seed in zip(("beam_generate_fused", "sample_generate_fused"), search_cfgs, (None, SAMPLE_SEED)):
            more[path], more_variants[path] = timed_generate(model, vision_x, ids, mask, gcfg_x, dev, counters,
                                                             f"{name} {path}", seed=seed)
            want = route_launches(cfg, counters, fused=True)
            require(more[path] == want, f"{name} {path} launches {more[path]}, expected {want}")
        log({"phase": "generate", "dtype": "bfloat16", "route": f"{name} beam {BEAMS} cache gather",
             **gather_ms(model, dev)})
        searches_in_turns(model, vision_x, ids, mask, gcfg, search_cfgs, dev)
    for form in forms:
        with layer_form(form):
            got, more_variants[f"generate_{form}"] = timed_generate(model, vision_x, ids, mask, gcfg, dev, counters,
                                                                    f"{name} {form}")
            want = route_launches(cfg, counters, fused=True, form=form)
            require(got == want, f"{name} {form} launches {got}, expected {want}")
            sync_free_step(model, vision_x, ids, mask, dev, route=form)
        more[f"generate_{form}"] = got
    if forms:
        forms_in_turns(model, vision_x, ids, mask, gcfg, dev, name)
    if name == "OF-3B":    # the ViT on its plain route: vision_s and TTFT without K9/K10
        with vit_plain_route():
            plain_vit, _ = timed_generate(model, vision_x, ids, mask, gcfg, dev, counters, f"{name} fused, ViT plain")
        want = dict(route_launches(cfg, counters, fused=True), vit_attention=0, layer_norm=0)
        require(plain_vit == want, f"{name} fused route, ViT plain: launches {plain_vit}, expected {want}")
    with unfused_route():
        unfused, _ = timed_generate(model, vision_x, ids, mask, gcfg, dev, counters, f"{name} unfused")
    want = route_launches(cfg, counters, fused=False)
    require(unfused == want, f"{name} unfused route launches {unfused}, expected {want}")
    del model
    torch.cuda.empty_cache()
    return fused, unfused, variants, more, more_variants


def next_pixels(cfg, dev, b=B, batch=0):
    """The next batch's images: (b, 1, 1, H, W, 3), one per row; `batch`
    numbers the batches of a pipe."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8 + batch)
    px = cfg.vision.image_size
    return torch.randn(b, 1, 1, px, px, 3, generator=gen, device=dev)


def absorbed_workspace(model, vision_x, ids, mask, next_px, gcfg):
    """flamingo_generate(next_pixels=)'s absorbed path up to the final flat
    workspace (m_pad, D) of the next batch's ViT. Returns (tokens, workspace)."""
    latents = model.embed_vision(vision_x)
    logits, cache = prefill(model, latents, ids, mask, T_PROMPT + NEW_TOKENS)
    plan = make_plan(model.cfg, next_px.shape[:3], gcfg.max_new_tokens)
    n_media = count_media(ids, model.cfg.media_token_id)
    xw = patch_embed_flat(model.vision_encoder, next_px.reshape(plan.bv, *next_px.shape[3:]), plan)
    return greedy_absorb(lambda tok, m, c, side=None: model.decode_step(latents, tok, m, c, n_media, side),
                         logits[:, -1], cache, gcfg, xw, model.vision_encoder.blocks, plan)


def side_variants(variants: dict, key: str, tiles: int) -> dict:
    """`variants` with `tiles` of fused_mlp's `key` launches carrying a side
    tile (the "+side" variant)."""
    mlp = dict(variants["fused_mlp"])
    mlp[key] -= tiles
    mlp[key + "+side"] = tiles
    return {**variants, "fused_mlp": {k: n for k, n in mlp.items() if n}}


def side_launches() -> int:
    """The launches of K2 and K3 that carried a side tile ("+side", "+side8")."""
    return sum(n for fn in (fused_mlp, attn_block_decode) for k, n in fn.variants.items() if "+side" in k)


def sync_free_absorb_step(model, vision_x, ids, mask, next_px, plan, latents=None, label="") -> None:
    """One absorbing decode step (ViT layer 0 of the next batch) under the
    sync debug mode "error": K8 and the side tiles (K2b, K2b int8, K2b-attn)
    take no host scalar."""
    lat = model.embed_vision(vision_x) if latents is None else latents
    logits, cache = prefill(model, lat, ids, mask, T_PROMPT + NEW_TOKENS)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    n_media = count_media(ids, model.cfg.media_token_id)
    ones = torch.ones(ids.shape[0], 1, dtype=torch.long, device=ids.device)
    xw = patch_embed_flat(model.vision_encoder, next_px.reshape(plan.bv, *next_px.shape[3:]), plan)
    hook = SideHook(model.vision_encoder.blocks[:plan.per_step], xw, plan)
    torch.cuda.synchronize()
    k8, side = flat_vit_attention.launches, side_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(lat, tok, ones, cache, n_media, side=hook)
        hook.result()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    side = side_launches() - side
    require((flat_vit_attention.launches - k8, side) == (plan.per_step, plan.per_step * plan.slots_per_layer),
            f"absorbing step launches: K8 {flat_vit_attention.launches - k8}, side tiles {side}")
    log({"phase": "absorb", "dtype": str(model.dtype).split(".")[-1], "label": label, "absorbing_step_host_syncs": 0,
         "k8_launches": plan.per_step, "side_tile_launches": side})


def timed_absorb(model, cfg, b, gcfg, dev, counters, label):
    """bf16 (or quantized) OF-3B at batch b: generate(next_pixels=) against
    generate followed by a serial embed_vision of the same next batch, host
    clock to a synchronize, in turns absorbed, serial, serial, absorbed,
    after one warm-up of each; every launch counter reset just before one
    absorbed call and read just after. Returns (launches, variants, plan)."""
    vision_x, ids, mask = make_inputs(cfg, dev, b)
    next_px = next_pixels(cfg, dev, b)
    plan = make_plan(cfg, next_px.shape[:3], gcfg.max_new_tokens)

    def absorbed():
        return flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)

    def serial():
        return flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev), model.embed_vision(next_px)

    warm_a, warm_s = absorbed(), serial()
    require(torch.equal(warm_a[0], warm_s[0]), f"{label}: absorbed tokens differ from the call without next_pixels")
    torch.cuda.synchronize()
    times = {"absorbed": [], "serial": []}
    for name, fn in (("absorbed", absorbed), ("serial", serial), ("serial", serial), ("absorbed", absorbed)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    reset_counters(counters)
    tokens, latents = absorbed()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
    a_s, s_s = sum(times["absorbed"]) / 2, sum(times["serial"]) / 2
    log({"phase": "absorb", "dtype": str(model.dtype).split(".")[-1], "label": label, "batch": b,
         "next_batch": b, "prompt": T_PROMPT, "new_tokens": NEW_TOKENS, "absorbed_s": a_s, "serial_s": s_s,
         "absorbed_minus_serial_s": a_s - s_s, "runs_s": times, "tokens_per_s_absorbed": b * NEW_TOKENS / a_s,
         "tokens_per_s_serial": b * NEW_TOKENS / s_s, "plan": dataclasses.asdict(plan), "launches": launches,
         "variants": variants})
    require(torch.isfinite(latents.float()).all().item(), f"{label}: next_latents not finite")
    return launches, variants, plan


@torch.no_grad()
def phase_absorb(dev) -> tuple:
    """Cross-batch absorbed ViT on full-width OF-3B (B 8 prompts of 32
    tokens, the next batch's 8 images, 32 new tokens): the next batch's
    ViT-L/14 rides the first 24 decode forwards as 288 K2b side tiles on K2
    launches (12 a ViT layer over 6 groups), with K8 as the attention glue.
    fp32: tokens identical across the absorbed call with the kernels, under
    plain_path() and the call without next_pixels; next_latents within
    VIT_RTOL of the largest entry of embed_vision on the same pixels and of
    the plain_path() absorbed call; K8 24 and K2b 288 launches. bf16: the
    absorbed workspace against plain_path()'s (ABSORB_BF16_RTOL); timed at B
    8 and 32 against the serial encode, with exact launch counts (K9 / K10
    only for the current batch); one absorbing step under the sync debug
    mode "error"; int4 weights timed at B 8. Returns ({path: launches},
    {path: variants})."""
    counters = kernel_functions()
    cfg = model_config("OF-3B")
    vision_x, ids, mask = make_inputs(cfg, dev)
    next_px = next_pixels(cfg, dev)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    model = build_model(cfg, dev, torch.float32)
    plan = make_plan(cfg, next_px.shape[:3], NEW_TOKENS)
    require(plan is not None and (plan.n_steps, plan.slots_per_layer, plan.macro) == (24, 12, 6),
            f"OF-3B absorb plan {plan}")
    tok_plain = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
    reset_counters(counters)
    tok_k, lat_k = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)
    side = counters["fused_mlp"].variants.get("float+side", 0)
    require((flat_vit_attention.launches, side) == (24, 288),
            f"fp32 absorbed call: K8 {flat_vit_attention.launches}, K2b {side} (expected 24, 288)")
    serial = model.embed_vision(next_px)
    with plain_path():
        tok_p, lat_p = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)
    log({"phase": "absorb", "dtype": "float32", "tokens_equal_plain_call": torch.equal(tok_k, tok_plain),
         "tokens_equal_plain_path": torch.equal(tok_k, tok_p), "latents_shape": list(lat_k.shape),
         "distinct_tokens_per_row": [len(set(r)) for r in tok_k.tolist()]})
    require(torch.equal(tok_k, tok_plain), "fp32 absorbed tokens differ from the call without next_pixels")
    require(torch.equal(tok_k, tok_p), "fp32 absorbed tokens differ between the kernels and plain_path()")
    require(lat_k.shape == serial.shape == (B, 1, cfg.num_vis_latents, cfg.vision.hidden_size), "next_latents shape")
    latents_agree("OF-3B absorbed next_latents vs embed_vision", lat_k, serial, phase="absorb")
    latents_agree("OF-3B absorbed next_latents, kernels vs plain_path", lat_k, lat_p, phase="absorb")
    paths, vpaths = {}, {}
    paths["absorb_fp32_attn"], vpaths["absorb_fp32_attn"] = absorb_attn_carriers_fp32(
        model, cfg, vision_x, ids, mask, next_px, gcfg, counters, tok_plain, serial)
    vpaths["absorb_fp32_int8"] = absorb_int8_side_car_fp32(model, cfg, vision_x, ids, mask, next_px, gcfg, counters,
                                                           serial)
    del model, serial, lat_k, lat_p
    torch.cuda.empty_cache()

    model = build_model(cfg, dev, torch.bfloat16)
    tok_k, xw_k = absorbed_workspace(model, vision_x, ids, mask, next_px, gcfg)
    with plain_path():
        tok_p, xw_p = absorbed_workspace(model, vision_x, ids, mask, next_px, gcfg)
    err, top = (xw_k.float() - xw_p.float()).abs().max().item(), xw_p.float().abs().max().item()
    log({"phase": "absorb", "dtype": "bfloat16", "compare": "absorbed workspace, kernels vs plain_path",
         "max_abs_err": err, "max_abs": top, "rtol_of_max": ABSORB_BF16_RTOL,
         "tokens_equal": torch.equal(tok_k, tok_p)})
    require(torch.isfinite(xw_k.float()).all().item() and err <= ABSORB_BF16_RTOL * top,
            f"bf16 absorbed workspace: {err} against the largest entry {top}")
    sync_free_absorb_step(model, vision_x, ids, mask, next_px, plan, label="bf16")
    for b in (B, 32):
        launches, variants, plan_b = timed_absorb(model, cfg, b, gcfg, dev, counters, f"OF-3B bf16 B{b}")
        want = dict(route_launches(cfg, counters, fused=True), flat_vit_attention=plan_b.n_vit_layers)
        require(launches == want, f"bf16 absorbed B{b} launches {launches}, expected {want}")
        tiles = plan_b.slots_per_layer * plan_b.n_vit_layers
        require(variants["fused_mlp"] == {"float": want["fused_mlp"] - tiles, "float+side": tiles},
                f"bf16 absorbed B{b} K2 variants {variants['fused_mlp']}")
        if b == B:
            paths["absorb_bf16"], vpaths["absorb_bf16"] = launches, variants
    quantize_decode_weights(model, 4)
    launches, variants, plan_b = timed_absorb(model, cfg, B, gcfg, dev, counters, "OF-3B int4 B8")
    want_v = side_variants(quant_variants(cfg, 4, False), "int4", plan_b.slots_per_layer * plan_b.n_vit_layers)
    require(variants == want_v, f"int4 absorbed variant launches {variants}, expected {want_v}")
    vpaths["absorb_int4"] = variants
    more, vmore = phase_pipe(model, cfg, dev, counters)
    paths.update(more)
    vpaths.update(vmore)
    del model
    torch.cuda.empty_cache()
    return paths, vpaths


@contextlib.contextmanager
def attn_carriers(on: bool):
    """absorb_vit.ATTN_CARRIERS for the block: K3's launches carry tiles too."""
    prev, absorb_vit.ATTN_CARRIERS = absorb_vit.ATTN_CARRIERS, on
    try:
        yield
    finally:
        absorb_vit.ATTN_CARRIERS = prev


@contextlib.contextmanager
def w8a8_prefill():
    """ops.w8a8.ENABLED for the block: prefill and the serial ViT W8A8."""
    prev, w8a8.ENABLED = w8a8.ENABLED, True
    try:
        yield
    finally:
        w8a8.ENABLED = prev


def absorb_attn_carriers_fp32(model, cfg, vision_x, ids, mask, next_px, gcfg, counters, tok_plain, serial):
    """(a) fp32 OF-3B with ATTN_CARRIERS: the JAX plan (24 steps, 12 slots,
    macro 3: xattn K3, xattn K2, MPT K3, MPT K2 a group), tokens identical to
    the call without next_pixels and to plain_path()'s, next_latents within
    VIT_RTOL of embed_vision, K8 24 and 144 tiles on each of K3 and K2.
    Returns (launches, variants) of the call."""
    with attn_carriers(True):
        plan = make_plan(cfg, next_px.shape[:3], NEW_TOKENS)
        require(plan is not None and (plan.n_steps, plan.slots_per_layer, plan.macro) == (24, 12, 3),
                f"OF-3B absorb plan with attention carriers {plan}")
        reset_counters(counters)
        tok, lat = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=model.device)
        launches = {name: fn.launches for name, fn in counters.items()}
        variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
        with plain_path():
            tok_p, lat_p = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px,
                                             device=model.device)
    k3, k2 = variants["attn_block_decode"].get("float+side", 0), variants["fused_mlp"].get("float+side", 0)
    log({"phase": "absorb", "dtype": "float32", "form": "attn_carriers", "plan": dataclasses.asdict(plan),
         "k8_launches": launches["flat_vit_attention"], "k3_side_launches": k3, "k2_side_launches": k2,
         "tokens_equal_plain_call": torch.equal(tok, tok_plain), "tokens_equal_plain_path": torch.equal(tok, tok_p)})
    require((launches["flat_vit_attention"], k3, k2) == (24, 144, 144),
            f"fp32 attention carriers: K8 {launches['flat_vit_attention']}, K3 tiles {k3}, K2 tiles {k2}")
    require(torch.equal(tok, tok_plain) and torch.equal(tok, tok_p), "fp32 attention carriers: tokens differ")
    latents_agree("OF-3B absorbed with attention carriers vs embed_vision", lat, serial, phase="absorb")
    latents_agree("OF-3B absorbed with attention carriers, kernels vs plain_path", lat, lat_p, phase="absorb")
    return launches, variants


def absorb_int8_side_car_fp32(model, cfg, vision_x, ids, mask, next_px, gcfg, counters, serial):
    """(b) fp32 OF-3B with quantize_prefill_weights(model, 8): the 288 tiles
    are W8A8 ("int8+side8"); tokens those of the int8 call without
    next_pixels and of plain_path()'s; the next latents of the kernels and of
    plain_path() within W8A8_ABSORB_RTOL of the largest entry, and against
    the unquantized embed_vision strictly between 1e-6 and 0.1 of it (JAX
    tests/test_absorb_vit.py test_generate_absorb_int8_side: the int8 path
    engaged, its grid error bounded). Returns the call's variants; the
    quantized copies are dropped again."""
    dev = model.device
    quantize_prefill_weights(model, 8)
    try:
        tok_plain = flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
        reset_counters(counters)
        tok, lat = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)
        variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
        k8 = counters["flat_vit_attention"].launches
        with plain_path():
            tok_p, lat_p = flamingo_generate(model, vision_x, ids, mask, gcfg, next_pixels=next_px, device=dev)
    finally:
        drop_decode_weights(model)
    side8 = variants["fused_mlp"].get("int8+side8", 0)
    top = serial.abs().max().item()
    err_kp = (lat - lat_p).abs().max().item()
    rel_grid = (lat - serial).abs().max().item() / top
    log({"phase": "absorb", "dtype": "float32", "form": "int8_side_car", "k8_launches": k8, "k2_side8_launches": side8,
         "tokens_equal_plain_call": torch.equal(tok, tok_plain), "tokens_equal_plain_path": torch.equal(tok, tok_p),
         "latents_kernels_vs_plain_path_max_abs_err": err_kp, "latents_max_abs": lat_p.abs().max().item(),
         "rtol_of_max": W8A8_ABSORB_RTOL, "rel_err_vs_unquantized_embed_vision": rel_grid})
    require((k8, side8) == (24, 288), f"fp32 int8 side-car: K8 {k8}, W8A8 tiles {side8}")
    require(torch.equal(tok, tok_plain) and torch.equal(tok, tok_p), "fp32 int8 side-car: tokens differ")
    require(err_kp <= W8A8_ABSORB_RTOL * lat_p.abs().max().item(),
            f"fp32 int8 side-car: latents kernels vs plain_path {err_kp}")
    require(1e-6 < rel_grid < 0.1, f"fp32 int8 side-car: latents vs unquantized embed_vision {rel_grid}")
    return variants


def pipe_variants(cfg, plan) -> dict:
    """The per-variant launches of one pipe call (OF-3B, int4 decode, the
    current batch's latents given): quant_variants' int4 counts, with the
    plan's tiles "int4+side8" on K2 and, with attention carriers, half of
    them on K3."""
    want = quant_variants(cfg, 4, False)
    tiles = plan.slots_per_layer * plan.n_vit_layers
    k3 = tiles // 2 if plan.attn_carriers else 0
    for kernel, n in (("fused_mlp", tiles - k3), ("attn_block_decode", k3)):
        if n:
            want[kernel] = dict(want[kernel], int4=want[kernel]["int4"] - n, **{"int4+side8": n})
    return want


def latent_gap(got, want):
    """max |got - want| over the largest |want|, in fp32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_pipe(model, cfg, dev, counters) -> tuple:
    """(c) The JAX package's offline-throughput pipe (bench.py `b64_i4_pipe`)
    at full width: bf16 OF-3B, B 64 prompts of 32 tokens with one image
    each, 32 new tokens; int4 decode weights with the ViT's int8 side-car
    (quantize_prefill_weights(model, 4)) and W8A8 prefill; each call given
    its batch's latents and the next batch's pixels, whose ViT rides the
    decode loop as 288 W8A8 side tiles; the latents fed forward. The first
    latents from embed_vision under W8A8. Against the serial form (the same
    generate without next_pixels, then a serial W8A8 embed_vision of the
    next batch): the first call's tokens equal, then 5 calls of each in
    turns (pipe, serial, serial, pipe, ...), host clock to a synchronize,
    medians; every launch counter reset before one more pipe call and read
    after it (K9/K10 0: the current batch's vision arrives as latents); the
    latents of every pipe call within 0.1 of the largest entry (the JAX
    gate of the int8 grid) of the serial W8A8 embed_vision of the same
    pixels (the absorbed tiles quantize each fc2 slice on its own); one
    absorbing step under the sync debug mode "error". Then the same with
    ATTN_CARRIERS. Returns ({path: launches}, {path: variants})."""
    b, calls = 64, 5
    quantize_prefill_weights(drop_decode_weights(model), 4)
    side_car = sum(t.numel() * t.element_size() for n, t in model.named_buffers()
                   if n.endswith(("weight_q", "weight_s")))
    # W8A8 prefill unpacks each packed int4 stream at its use: the time of every unpack of one call
    packed = [m for m in model.modules()
              if getattr(m, "weight_q", None) is not None and m.weight_q.dtype == torch.uint8]
    unpack_ms = call_ms(lambda: [w8a8_weight(m) for m in packed], iters=5)
    log({"phase": "absorb", "dtype": "bfloat16", "label": "int4_unpack", "streams": len(packed),
         "packed_mb": sum(m.weight_q.numel() for m in packed) / 2**20, "unpack_ms_per_prefill": unpack_ms})
    vision_x, ids, mask = make_inputs(cfg, dev, b)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    pixels = [next_pixels(cfg, dev, b, batch=i) for i in range(calls + 2)]
    paths, vpaths = {}, {}
    with w8a8_prefill():
        lat0 = model.embed_vision(vision_x)
        for form, carriers in (("pipe_int4_w8a8", False), ("pipe_int4_w8a8_attn", True)):
            with attn_carriers(carriers):
                plan = make_plan(cfg, pixels[0].shape[:3], NEW_TOKENS)
                require(plan is not None and (plan.n_steps, plan.slots_per_layer, plan.macro)
                        == (24, 12, 3 if carriers else 6), f"{form}: plan {plan}")

                def pipe(lat, px):
                    return flamingo_generate(model, None, ids, mask, gcfg, media_latents=lat, next_pixels=px,
                                             device=dev)

                def serial(lat, px):
                    return flamingo_generate(model, None, ids, mask, gcfg, media_latents=lat, device=dev), \
                        model.embed_vision(px)

                tok_p, lat_p = pipe(lat0, pixels[0])
                tok_s, lat_s = serial(lat0, pixels[0])
                require(torch.equal(tok_p, tok_s), f"{form}: tokens differ from the serial form's on the same latents")
                gaps = [latent_gap(lat_p, lat_s)]
                torch.cuda.synchronize()
                times = {"pipe": [], "serial": []}
                for i in range(calls):
                    for name in (("pipe", "serial") if i % 2 == 0 else ("serial", "pipe")):
                        t0 = time.perf_counter()
                        if name == "pipe":
                            tok_p, lat_p = pipe(lat_p, pixels[i + 1])
                        else:
                            tok_s, lat_s = serial(lat_s, pixels[i + 1])
                        torch.cuda.synchronize()
                        times[name].append(time.perf_counter() - t0)
                    gaps.append(latent_gap(lat_p, lat_s))      # both the latents of pixels[i + 1]
                reset_counters(counters)
                tok_p, lat_p = pipe(lat_p, pixels[calls + 1])
                torch.cuda.synchronize()
                launches = {name: fn.launches for name, fn in counters.items()}
                gaps.append(latent_gap(lat_p, model.embed_vision(pixels[calls + 1])))
                variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
                med_p, med_s = sorted(times["pipe"])[calls // 2], sorted(times["serial"])[calls // 2]
                log({"phase": "absorb", "dtype": "bfloat16", "label": form, "batch": b, "prompt": T_PROMPT,
                     "new_tokens": NEW_TOKENS, "median_pipe_s": med_p, "median_serial_s": med_s,
                     "pipe_minus_serial_s": med_p - med_s, "tokens_per_s_pipe": b * NEW_TOKENS / med_p,
                     "tokens_per_s_serial": b * NEW_TOKENS / med_s, "runs_s": times,
                     "side_car_mb": side_car / 2**20, "latents_vs_serial_rel_of_max": gaps,
                     "plan": dataclasses.asdict(plan), "launches": launches, "variants": variants})
                want = dict(route_launches(cfg, counters, fused=True), vit_attention=0, layer_norm=0,
                            flat_vit_attention=plan.n_vit_layers)
                require(launches == want, f"{form}: launches {launches}, expected {want}")
                want_v = pipe_variants(cfg, plan)
                require(variants == want_v, f"{form}: variant launches {variants}, expected {want_v}")
                require(torch.isfinite(lat_p.float()).all().item() and lat_p.shape == lat0.shape,
                        f"{form}: next_latents")
                require(all(g < 0.1 for g in gaps),
                        f"{form}: next_latents against the serial W8A8 embed_vision of the same pixels: {gaps}")
                sync_free_absorb_step(model, None, ids, mask, pixels[0], plan, latents=lat0, label=form)
                paths[form], vpaths[form] = launches, variants
    drop_decode_weights(model)
    return paths, vpaths


def quant_variants(cfg, bits: int, kv8: bool) -> dict:
    """The per-variant launches of one quantized generate call on the fused
    route (the counts of `route_launches`, split by variant): the head K1
    int8 in every mode, every other projection int8 or int4, K3 and K6 over
    the int8 caches with kv8; llama's K1 with the RMSNorm ("+rms") and its
    K2 in the SwiGLU form ("+rms+swiglu+silu"), the xattn FF as it is; no
    K11 (off by default)."""
    steps, layers = NEW_TOKENS - 1, cfg.lm.num_layers
    xattn = layers // cfg.cross_attn_every_n
    family = cfg.lm.family
    rms = "+rms" if family == "llama" else ""
    w = "int8" if bits == 8 else "int4"
    kv = w + ("+kv8" if kv8 else "")
    dense = {"int8" + rms: steps}
    if K1_PER_LAYER[family]:
        dense[w + rms] = dense.get(w + rms, 0) + steps * layers * K1_PER_LAYER[family]
    decoder_mlp = w + {"llama": "+rms+swiglu+silu", "opt": "+relu"}.get(family, "")
    mlp = {w: steps * xattn}
    mlp[decoder_mlp] = mlp.get(decoder_mlp, 0) + steps * layers
    return {"fused_dense": dense, "fused_mlp": mlp,
            "attn_block_decode": {kv: steps * (xattn + layers * (family == "mpt"))},
            "attend_out_decode": {kv: steps * layers} if family != "mpt" else {}, "fused_layer_decode": {}}


def paired_step_logits(model, latents, ids, mask, tokens, int8_kv):
    """(kernels, plain) logits (N, B, V) on the token stream `tokens`, every
    decode step run by both from one state: one prefill (kernels), then per
    step the plain_path() step on a copy of the cache and the kernel step on
    the cache itself, which carries on. (Over an int8 cache two free-running
    calls part at rounding boundaries: fp32 sums taken in another order put
    a few entries one quantization step apart, and every later layer reads
    them, so the kernels are held to their plain versions step by step.)"""
    logits, cache = prefill(model, latents, ids, mask, T_PROMPT + NEW_TOKENS, int8_kv)
    lk, lp = [logits[:, -1]], [logits[:, -1]]
    n_media = count_media(ids, model.cfg.media_token_id)
    ones = torch.ones(B, 1, dtype=torch.long, device=ids.device)
    for t in range(tokens.shape[1] - 1):
        copy = dataclasses.replace(cache, layers=tuple(
            dataclasses.replace(l, **{f: getattr(l, f).clone() for f in ("k", "v", "k_s", "v_s")
                                      if getattr(l, f) is not None}) for l in cache.layers))
        with plain_path():
            lp.append(model.decode_step(latents, tokens[:, t:t + 1], ones, copy, n_media)[0][:, 0])
        logits, cache = model.decode_step(latents, tokens[:, t:t + 1], ones, cache, n_media)
        lk.append(logits[:, 0])
    return torch.stack(lk), torch.stack(lp)


def prefill_cache_flips(model, latents, ids, mask) -> dict:
    """Prefill into an int8 cache on the kernels and under plain_path(): per
    decoder layer, the int8 K/V entries one step (or more) apart."""
    _, ck = prefill(model, latents, ids, mask, T_PROMPT + NEW_TOKENS, True)
    with plain_path():
        _, cp = prefill(model, latents, ids, mask, T_PROMPT + NEW_TOKENS, True)
    diffs = [torch.cat([(a.k.int() - b.k.int()).abs().flatten(), (a.v.int() - b.v.int()).abs().flatten()])
             for a, b in zip(ck.layers, cp.layers)]
    return {"entries_per_layer": diffs[0].numel(), "differing_per_layer": [int((d > 0).sum()) for d in diffs],
            "max_step": int(max(d.max() for d in diffs))}


def drift(l_ref, l_q) -> dict:
    """Mean KL(ref || quantized) of the step logits (N, B, V) and their
    top-1 agreement, the JAX package's quantization gates."""
    lp_r, lp_q = torch.log_softmax(l_ref.float(), -1), torch.log_softmax(l_q.float(), -1)
    kl = (lp_r.exp() * (lp_r - lp_q)).sum(-1).mean().item()
    return {"mean_kl": kl, "top1_agreement": (l_ref.argmax(-1) == l_q.argmax(-1)).float().mean().item()}


@torch.no_grad()
def phase_quantized(dev, name="OF-3B") -> dict:
    """Quantized decode on the fused route. OF-3B: int8 and int4 weights and
    int8 weights with the int8 caches; OF-4B: int8 weights with the int8
    caches (and int4 weights, timed, the only path that runs K1 and K6 with
    int4). fp32 on dequantize_roundtrip weights: the side-car against no
    side-car and kernels against plain_path(), identical tokens and logits
    within LOGITS_TOL. bf16 timed with exact launch counts per variant, the
    drift against the unquantized call on its token stream (OF-3B gated: int8
    mean KL < 1e-3, int4 < 0.1), one sync-free int8-cache step. Returns
    {path: per-variant launches}."""
    counters = kernel_functions()
    cfg = model_config(name)
    vision_x, ids, mask = make_inputs(cfg, dev)
    neox = cfg.lm.family == "gptneox"
    tag = name.replace("-", "").lower()

    def gcfg(int8_kv):
        return GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0, int8_kv=int8_kv)

    def run(model, latents, int8_kv, stream=None):
        tokens = flamingo_generate(model, vision_x, ids, mask, gcfg(int8_kv), device=dev)
        return tokens, step_logits(model, latents, ids, mask, tokens if stream is None else stream, int8_kv)

    # fp32, on weights that the quantization grid holds exactly
    t0 = time.perf_counter()
    model = build_model(cfg, dev, torch.float32)
    latents = model.embed_vision(vision_x)
    for bits in ((8,) if neox else (8, 4)):
        dequantize_roundtrip(drop_decode_weights(model), bits)
        if not neox:
            tok_a, la = run(model, latents, False)
            quantize_decode_weights(model, bits)
            tok_b, lb = run(model, latents, False, tok_a)
            fp32_agree(f"{name} int{bits} side-car vs none, kernels", tok_b, tok_a, lb, la)
            with plain_path():
                tok_c, lc = run(model, latents, False, tok_a)
            fp32_agree(f"{name} int{bits} side-car, kernels vs plain_path", tok_b, tok_c, lb, lc)
        if bits == 8:
            quantize_decode_weights(model, bits)
            tok_d, ld = run(model, latents, True)
            with plain_path():
                tok_e, le = run(model, latents, True, tok_d)
            log({"phase": "quantized", "model": name, "dtype": "float32", "compare": "int8 cache, free-running",
                 "logits_max_abs_err": (ld - le).abs().max().item(),
                 "prefill_logits_max_abs_err": (ld[0] - le[0]).abs().max().item(),
                 "prefill_cache_flips": prefill_cache_flips(model, latents, ids, mask)})
            lk, lp = paired_step_logits(model, latents, ids, mask, tok_d, True)
            fp32_agree(f"{name} int8 + int8 cache, kernels vs plain_path step by step", tok_d, tok_e, lk, lp,
                       time.perf_counter() - t0)
    del model, latents
    torch.cuda.empty_cache()

    # bf16, timed; drift against the unquantized call
    model = build_model(cfg, dev, torch.bfloat16)
    latents = model.embed_vision(vision_x)
    tok_ref = flamingo_generate(model, vision_x, ids, mask, gcfg(False), device=dev)
    l_ref = step_logits(model, latents, ids, mask, tok_ref)
    paths, bits_now = {}, None
    for bits, kv8 in (((8, True), (4, False)) if neox else ((8, False), (8, True), (4, False))):
        if bits != bits_now:
            quantize_decode_weights(drop_decode_weights(model), bits)
            bits_now = bits
        mode = f"int{bits}" + ("_kv8" if kv8 else "")
        launches, variants = timed_generate(model, vision_x, ids, mask, gcfg(kv8), dev, counters, f"{name} {mode}")
        want = route_launches(cfg, counters, fused=True)
        require(launches == want, f"{name} {mode} launches {launches}, expected {want}")
        want_v = quant_variants(cfg, bits, kv8)
        require(variants == want_v, f"{name} {mode} variant launches {variants}, expected {want_v}")
        d = drift(l_ref, step_logits(model, latents, ids, mask, tok_ref, kv8))
        gate = None if (neox or kv8) else (1e-3 if bits == 8 else 0.1)
        log({"phase": "quantized", "model": name, "dtype": "bfloat16", "mode": mode, "drift_vs_bf16": d,
             "kl_gate": gate, "side_car_mb": sum(b.numel() * b.element_size() for n, b in model.named_buffers()
                                                 if n.endswith(("weight_q", "weight_s"))) / 2**20})
        require(gate is None or d["mean_kl"] < gate, f"{name} {mode}: mean KL {d['mean_kl']} above {gate}")
        if kv8:
            sync_free_step(model, vision_x, ids, mask, dev, int8_kv=True)
        paths[f"{tag}_{mode}"] = variants
    if name in W8A8_GATES:
        w8a8_drift(model, cfg, name, vision_x, ids, mask, tok_ref, l_ref, latents)
    del model, latents
    torch.cuda.empty_cache()
    return paths


# W8A8 prefill's drift gates per model and bits (mean KL of the step logits): OF-3B int4 + W8A8 at the int4
# gate, int8 + W8A8 at 1e-2 (the JAX package records it, ungated); LLaMA-7B int8 + W8A8 at 1e-2, int4 + W8A8
# recorded ungated (int4 alone is at 0.088 of its 0.1 gate: the W8A8 part has no room left under it)
W8A8_GATES = {"OF-3B": {8: 1e-2, 4: 0.1}, "LLaMA-7B": {8: 1e-2, 4: None}}


def w8a8_drift(model, cfg, name, vision_x, ids, mask, tok_ref, l_ref, latents) -> None:
    """W8A8 prefill's drift (bf16 OF-3B and LLaMA-7B):
    quantize_prefill_weights(model, bits) and ops.w8a8.ENABLED, the latents
    from the W8A8 ViT and the prompt prefilled by W8A8 products, then the
    quantized decode steps on the unquantized call's tokens: the mean KL and
    top-1 agreement of the step logits against that call's, gated by
    W8A8_GATES. Logged beside it, its parts: the W8A8 latents with a float
    prefill, and the float latents (`latents`) with a W8A8 prefill; and the
    output widths of the int8 products, which hold an untied head's
    (LLaMA-7B: 32,003 rows, not a multiple of 8, padded for `torch._int_mm`)."""
    widths = set()
    real = w8a8.int8_matmul

    def spy(a, b):
        widths.add(b.shape[0])
        return real(a, b)

    w8a8.int8_matmul = spy
    try:
        for bits, gate in W8A8_GATES[name].items():
            quantize_prefill_weights(drop_decode_weights(model), bits)
            with w8a8_prefill():
                lat_w = model.embed_vision(vision_x)
                d = drift(l_ref, step_logits(model, lat_w, ids, mask, tok_ref))
                prefill_only = drift(l_ref, step_logits(model, latents, ids, mask, tok_ref))
            vit_only = drift(l_ref, step_logits(model, lat_w, ids, mask, tok_ref))
            log({"phase": "quantized", "model": name, "dtype": "bfloat16", "mode": f"int{bits}_w8a8",
                 "drift_vs_bf16": d, "kl_gate": gate, "parts": {"w8a8_vit_only": vit_only,
                                                                "w8a8_prefill_only": prefill_only},
                 "int8_product_widths": sorted(widths)})
            require(math.isfinite(d["mean_kl"]), f"{name} int{bits} + W8A8 prefill: mean KL {d['mean_kl']}")
            require(gate is None or d["mean_kl"] < gate,
                    f"{name} int{bits} + W8A8 prefill: mean KL {d['mean_kl']} above {gate}")
    finally:
        w8a8.int8_matmul = real
    if not cfg.lm.tie_word_embeddings:
        require(cfg.lm.vocab_size in widths, f"{name}: the untied head took no W8A8 product ({sorted(widths)})")
    drop_decode_weights(model)


# ---------------------------------------------------------------- phase 4


# ---------------------------------------------------------------- serving and speculative decoding

# the fp32 check's engine: 8 rows, prompts left-padded into a 32-token window, chunks of 8, two chunks in
# flight; 96 slots hold one epoch of 64 decode slots, so 12 staggered requests of up to 32 new tokens are
# admitted at several global slots and the engine drains and resets once
SERVE_FP32 = dict(batch_size=8, max_seq_len=96, max_prompt_len=32, chunk_tokens=8, pipeline_depth=2)
SERVE_FP32_REQUESTS, SERVE_FP32_NEW, SERVE_FP32_FIRST = 12, (8, 16, 32), 4
# the churn workload (the JAX package's scripts_dev/tpu_serving_ab.py): 64 requests, prompts of 8-32 tokens
# left-padded to 32, one image each, max_new drawn from {8, 16, 32, 64}, all queued at once; the engine at
# scripts/serve.py's defaults. No EOS: every request runs its max_new, the churn is length-driven.
CHURN = dict(batch_size=8, max_seq_len=512, max_prompt_len=64, chunk_tokens=8)
CHURN_REQUESTS, CHURN_PROMPT, CHURN_NEW, CHURN_DEPTHS = 64, 32, (8, 16, 32, 64), (0, 4)
SERVE_INT8_REQUESTS = 16
# a bf16 stream that parts from another route's (the engine's prefill pads into its own window and batches
# its own waves; over the int8 cache a K/V entry at a rounding boundary lands one step apart) must part at a
# near tie: the reference route's logits at the first parted step put the two tokens within this
SERVE_BF16_TIE = 0.1
SPEC_NEW = 64
# fp32: (batch, D, draft): the int4 draft at B 8 through D 7's K4 / K5 verify and at B 1 through the einsum
# verify, tokens held to flamingo_generate's; the self-draft at B 8, every window accepted
SPEC_FP32 = ((8, 7, "int4"), (1, 4, "int4"), (8, 4, "self"), (8, 7, "self"))


def serving_model(cfg, dev, dtype):
    """OF-3B through create_model_and_transforms (registry names, random
    weights from SEED), the entry point a server calls."""
    model, _, _ = create_model_and_transforms("ViT-L-14", "openai", "mosaicml/mpt-1b-redpajama-200b",
                                              init_params=True, init_seed=SEED, device=dev, dtype=dtype)
    require(model.cfg == cfg, f"create_model_and_transforms: config {model.cfg}")
    return model


def serving_requests(cfg, dev, n, seed, new_choices, pad_to=None):
    """n requests: a prompt of 8-32 tokens (ids below the special tokens, the
    image token first), left-padded to `pad_to` when given, one image, and
    max_new_tokens drawn from `new_choices`; lengths and ids from a CPU
    generator seeded `seed`, pixels from one on the card."""
    gen = torch.Generator().manual_seed(seed)
    pix = torch.Generator(device=dev).manual_seed(seed)
    size, top = cfg.vision.image_size, min(1000, cfg.media_token_id, cfg.eoc_token_id)
    out = []
    for _ in range(n):
        p = int(torch.randint(8, 33, (1,), generator=gen))
        ids = torch.randint(0, top, (p,), generator=gen)
        ids[0] = cfg.media_token_id
        mask = torch.ones(p, dtype=torch.long)
        if pad_to:
            ids, mask = F.pad(ids, (pad_to - p, 0)), F.pad(mask, (pad_to - p, 0))
        max_new = new_choices[int(torch.randint(len(new_choices), (1,), generator=gen))]
        out.append(dict(vx=torch.randn(1, 1, size, size, 3, generator=pix, device=dev), ids=ids, mask=mask,
                        max_new=max_new))
    return out


@contextlib.contextmanager
def engine_counts(engine):
    """Count an engine's decode steps (and those carrying ViT layers), its
    admission waves (and those that ran the vision encode) and the global
    slots it admitted at, by wrapping `Flamingo.decode_step` on its model
    and its `_admit`."""
    counts = {"steps": 0, "absorbing_steps": 0, "waves": 0, "vision_waves": 0, "admit_slots": []}
    model, admit, step = engine.model, engine._admit, engine.model.decode_step

    def decode_step(*args, **kw):
        counts["steps"] += 1
        counts["absorbing_steps"] += (args[5] if len(args) > 5 else kw.get("side")) is not None
        return step(*args, **kw)

    def counted_admit(admits, lat=None):
        counts["waves"] += 1
        counts["vision_waves"] += lat is None
        counts["admit_slots"].append(engine._cache.index)
        return admit(admits, lat)

    model.decode_step, engine._admit = decode_step, counted_admit
    try:
        yield counts
    finally:
        del model.decode_step, engine._admit


def serving_launches(cfg, counters, counts, plan=None) -> dict:
    """The launches an engine run must give on the fused route (MPT): per
    decode step K1 1 (the head), K2 and K3 one a decoder layer and one an
    xattn block; per admission wave K4 a decoder layer and K5 an xattn block,
    and K9 a ViT block and K10 two for a wave that ran the vision encode; K8
    per ViT layer an absorbing step carried."""
    layers, vit = cfg.lm.num_layers, cfg.vision.num_layers
    xattn = layers // cfg.cross_attn_every_n
    s, w, v = counts["steps"], counts["waves"], counts["vision_waves"]
    want = {name: 0 for name in counters}
    want.update(fused_dense=s, fused_mlp=s * (layers + xattn), attn_block_decode=s * (layers + xattn),
                flash_attention=w * layers, masked_xattn=w * xattn, vit_attention=v * vit, layer_norm=2 * v * vit)
    if plan is not None:
        want["flat_vit_attention"] = counts["absorbing_steps"] * plan.per_step
    return want


def submit_all(engine, reqs):
    return [engine.submit(r["vx"], r["ids"], attention_mask=r["mask"], max_new_tokens=r["max_new"]) for r in reqs]


def served_staggered(engine, reqs, first):
    """Submit `first` requests, then one after every engine step; run to the
    end. Returns each request's tokens in submission order."""
    rids = submit_all(engine, reqs[:first])
    rest = iter(reqs[first:])
    alive = True
    while alive:
        alive = engine.step()
        nxt = next(rest, None)
        if nxt is not None:
            rids += submit_all(engine, [nxt])
            alive = True
    res = engine.run()
    return [res[r] for r in rids]


def request_logits(model, r, stream, int8_kv=False):
    """(N, V) logits of flamingo_generate's route for request `r` alone along
    its token list `stream`, in a cache of generate's length."""
    ids, mask, n = r["ids"][None].to(r["vx"].device), r["mask"][None].to(r["vx"].device), len(stream)
    return step_logits(model, model.embed_vision(r["vx"][None]), ids, mask, torch.tensor([stream], device=ids.device),
                       int8_kv, -(-(ids.shape[1] + n) // 16) * 16)[:, 0].float()


def tokens_agree(phase, what, got, want, logits_fn, tol) -> int:
    """Each stream of `got` against `want` (token lists): equal, or equal up
    to a first parted step where the reference logits along want's stream
    (`logits_fn(i)`, (N, V)) put the two tokens within `tol`: a near tie the
    routes' error can tip, after which the streams are not compared.
    Returns the number of equal streams."""
    parted = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = [int(x) for x in g], [int(x) for x in w]
        require(len(g) == len(w), f"{what}: stream {i} has {len(g)} tokens, the reference {len(w)}")
        if g == w:
            continue
        s = next(k for k in range(len(w)) if g[k] != w[k])
        lg = logits_fn(i)[s]
        parted.append({"stream": i, "step": s, "tokens": [w[s], g[s]], "gap": (lg[w[s]] - lg[g[s]]).item()})
    log({"phase": phase, "compare": what, "streams": len(got), "equal": len(got) - len(parted), "parted": parted,
         "tie_tol": tol})
    require(all(abs(p["gap"]) <= tol for p in parted), f"{what}: streams part away from a near tie: {parted}")
    return len(got) - len(parted)


def engine_fp32_checks(model, cfg, dev, counters) -> None:
    """fp32: 12 requests (prompts of 8-32 tokens, max_new from {8, 16, 32})
    submitted staggered to an engine of 8 rows, admitted at several global
    slots across an epoch reset: each request's tokens those of
    flamingo_generate at B 1 on the fused route, and the same engine under
    plain_path() and on the unfused route (K7) giving the kernels' tokens."""
    reqs = serving_requests(cfg, dev, SERVE_FP32_REQUESTS, SEED + 20, SERVE_FP32_NEW)
    gen = GenerationConfig(max_new_tokens=0, pad_token_id=0)

    def reference(i):
        r = reqs[i]
        return (r["vx"][None], r["ids"][None].to(dev), r["mask"][None].to(dev))

    want = [flamingo_generate(model, *reference(i), GenerationConfig(max_new_tokens=r["max_new"], pad_token_id=0),
                              device=dev)[0].tolist() for i, r in enumerate(reqs)]
    memo = {}

    def ref_logits(i, streams):
        key = (i, tuple(streams[i]))
        if key not in memo:
            memo[key] = request_logits(model, reqs[i], streams[i])
        return memo[key]

    runs = {}
    for route, ctx in (("kernels", contextlib.nullcontext), ("plain_path", plain_path), ("unfused", unfused_route)):
        with ctx():
            engine = ServingEngine(model, **SERVE_FP32, gen=gen, device=dev)
            with engine_counts(engine) as counts:
                runs[route] = served_staggered(engine, reqs, SERVE_FP32_FIRST)
        log({"phase": "serving", "dtype": "float32", "route": route, "epochs": engine.epochs,
             "admit_slots": counts["admit_slots"], "waves": counts["waves"], "steps": counts["steps"],
             "requests": len(reqs), "max_new": [r["max_new"] for r in reqs]})
        if route == "kernels":
            require(engine.epochs >= 1 and len(set(counts["admit_slots"])) >= 3,
                    f"fp32 engine: {engine.epochs} epoch resets, admitted at slots {counts['admit_slots']}")
    tokens_agree("serving", "fp32 engine (kernels) vs flamingo_generate at B 1", runs["kernels"], want,
                 lambda i: ref_logits(i, want), LOGITS_TOL)
    for route in ("plain_path", "unfused"):
        tokens_agree("serving", f"fp32 engine under {route} vs the engine on the kernels", runs[route],
                     runs["kernels"], lambda i: ref_logits(i, runs["kernels"]), LOGITS_TOL)


def churn_engine(model, reqs, dev, counters, label, depth=0, **kw):
    """One engine run over `reqs`, all queued at once, every launch counter
    reset just before and read just after, host clock to a synchronize.
    Returns (tokens in submission order, result record)."""
    engine = ServingEngine(model, **CHURN, pipeline_depth=depth, gen=GenerationConfig(max_new_tokens=0,
                           pad_token_id=0, int8_kv=kw.pop("int8_kv", False)), device=dev, **kw)
    rids = submit_all(engine, reqs)
    torch.cuda.synchronize()
    reset_counters(counters)
    with engine_counts(engine) as counts:
        t0 = time.perf_counter()
        res = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    useful = sum(r["max_new"] for r in reqs)
    rec = {"label": label, "seconds": dt, "useful_tokens": useful, "useful_tokens_per_s": useful / dt,
           "pipeline_depth": depth, "epochs": engine.epochs, "latency": engine.latency_stats(),
           "launches": {name: fn.launches for name, fn in counters.items()},
           "variants": {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")},
           "counts": {k: v for k, v in counts.items() if k != "admit_slots"}, "engine": engine}
    tokens = [res[r] for r in rids]
    require(all(len(t) == r["max_new"] for t, r in zip(tokens, reqs)), f"{label}: a request's token count")
    return tokens, rec


def static_batches(model, reqs, dev, int8_kv=False):
    """flamingo_generate over the requests in batches of 8 in submission
    order, each at its batch's largest max_new (the overshoot is waste).
    Returns (each request's tokens, seconds)."""
    out = []
    t0 = time.perf_counter()
    for k in range(0, len(reqs), 8):
        batch = reqs[k:k + 8]
        new = max(r["max_new"] for r in batch)
        tok = flamingo_generate(model, torch.stack([r["vx"] for r in batch]),
                                torch.stack([r["ids"] for r in batch]).to(dev),
                                torch.stack([r["mask"] for r in batch]).to(dev),
                                GenerationConfig(max_new_tokens=new, pad_token_id=0, int8_kv=int8_kv), device=dev)
        out += [row[:r["max_new"]] for row, r in zip(tok.tolist(), batch)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sync_free_chunk(model, reqs, dev) -> None:
    """One engine chunk (8 decode steps on the fused route and the start of
    its tokens' copy to the host) under the sync debug mode "error"."""
    engine = ServingEngine(model, **CHURN, pipeline_depth=1, gen=GenerationConfig(max_new_tokens=0, pad_token_id=0),
                           device=dev)
    submit_all(engine, reqs[:8])
    engine.step()              # the admission wave and the first chunk
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._dispatch(engine._decode_chunk())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log({"phase": "serving", "dtype": "bfloat16", "chunk_host_syncs": 0, "chunk_tokens": CHURN["chunk_tokens"]})


def serve_absorbed(model, cfg, reqs, dev, counters, plain):
    """bf16 with absorb_vision: queued requests' images ride the decode
    chunks as K2b tiles (K8 between the projections) and admissions take the
    pooled latents. Side tiles never touch the main outputs: the same engine
    without absorption, handed the same latents at the same admissions,
    gives the tokens bit for bit. Against the plain engine (embed_vision's
    latents) the streams are held in two parts. Returns (launches,
    variants)."""
    taken = {}
    take = ServingEngine._abs_pool_take

    def recording(self, admits):
        out = take(self, admits)
        if out is not None:
            taken.update(out)
        return out

    ServingEngine._abs_pool_take = recording
    try:
        tokens, rec = churn_engine(model, reqs, dev, counters, "absorb_vision", absorb_vision=True)
    finally:
        ServingEngine._abs_pool_take = take
    engine = rec.pop("engine")
    plan = engine._abs_plan
    require(engine._absorb_on and plan is not None and engine.absorb_hits > 0,
            f"absorb_vision did not engage: on {engine._absorb_on}, plan {plan}, hits {engine.absorb_hits}")
    want = serving_launches(cfg, counters, rec["counts"], plan)
    tiles = rec["counts"]["absorbing_steps"] * plan.per_step * plan.slots_per_layer
    require(rec["launches"] == want, f"absorb_vision launches {rec['launches']}, expected {want}")
    require(rec["variants"]["fused_mlp"] == {"float": want["fused_mlp"] - tiles, "float+side": tiles} and tiles > 0,
            f"absorb_vision K2 variants {rec['variants']['fused_mlp']}, {tiles} tiles expected")

    def replay(self, admits):       # the absorbed run's latents, at the same admissions
        if all(req.rid in taken for _, req in admits):
            return {req.rid: taken[req.rid] for _, req in admits}
        return None

    ServingEngine._abs_pool_take = replay
    try:
        replayed, _ = churn_engine(model, reqs, dev, counters, "absorb_vision replayed without tiles")
    finally:
        ServingEngine._abs_pool_take = take
    with torch.no_grad():
        serial = model.embed_vision(torch.stack([r["vx"] for r in reqs]))
    lat_err = max((taken[rid].float() - serial[rid].float()).abs().max().item() for rid in taken)
    lat_top = serial.float().abs().max().item()
    log({"phase": "serving", "dtype": "bfloat16", **{k: v for k, v in rec.items() if k != "variants"},
         "card": card_line(), "plan": dataclasses.asdict(plan), "plan_n_steps": plan.n_steps,
         "absorb_hits": engine.absorb_hits, "absorb_misses": engine.absorb_misses,
         "k8_launches": rec["launches"]["flat_vit_attention"], "side_tiles": tiles,
         "tokens_bit_equal_replayed": tokens == replayed, "pooled_latents_max_abs_err": lat_err,
         "latents_max_abs": lat_top})
    require(tokens == replayed, "absorb_vision: tokens differ from the engine without tiles on the same latents")
    require(lat_err <= ABSORB_BF16_RTOL * lat_top, f"absorb_vision: pooled latents {lat_err} from embed_vision's")
    tokens_agree("serving", "bf16 absorb_vision engine vs the plain engine", tokens, plain,
                 lambda i: request_logits(model, reqs[i], plain[i]), SERVE_BF16_TIE)
    return rec["launches"], rec["variants"]


def serve_int8_kv(model, cfg, reqs, dev, counters):
    """bf16 with int8 decode weights and int8_kv (the attn_block_decode
    [int8+kv8] variant) against flamingo_generate(int8_kv=True) batched as
    static batches, held in two parts at a rounding flip. Returns
    (launches, variants)."""
    quantize_decode_weights(model, 8)
    try:
        tokens, rec = churn_engine(model, reqs, dev, counters, "int8_kv", int8_kv=True)
        engine = rec.pop("engine")
        require(engine._int8_kv and engine._cache.layers[0].k.dtype == torch.int8, "int8_kv did not engage")
        want = serving_launches(cfg, counters, rec["counts"])
        require(rec["launches"] == want, f"int8_kv launches {rec['launches']}, expected {want}")
        s = rec["counts"]["steps"]
        layers = cfg.lm.num_layers + cfg.lm.num_layers // cfg.cross_attn_every_n
        want_v = {"fused_dense": {"int8": s}, "fused_mlp": {"int8": s * layers},
                  "attn_block_decode": {"int8+kv8": s * layers}}
        require(all(rec["variants"][k] == v for k, v in want_v.items()),
                f"int8_kv variants {rec['variants']}, expected {want_v}")
        ref, _ = static_batches(model, reqs, dev, int8_kv=True)
        log({"phase": "serving", "dtype": "bfloat16", **{k: v for k, v in rec.items() if k != "engine"},
             "card": card_line()})
        tokens_agree("serving", "bf16 int8_kv engine vs flamingo_generate(int8_kv=True)", tokens, ref,
                     lambda i: request_logits(model, reqs[i], ref[i], int8_kv=True), SERVE_BF16_TIE)
    finally:
        drop_decode_weights(model)
    return rec["launches"], rec["variants"]


@torch.no_grad()
def phase_serving(dev) -> tuple:
    """The continuous-batching ServingEngine on full-width OF-3B built by
    create_model_and_transforms. fp32: `engine_fp32_checks`. bf16: the churn
    workload at pipeline depth 0 and 4 against static batching of the same
    requests (useful tokens/s, latency_stats, epochs, exact launches from
    the engine's counted steps and waves), one sync-free chunk, then
    absorb_vision and int8_kv. Returns ({path: launches}, {path: variants})."""
    counters = kernel_functions()
    cfg = model_config("OF-3B")
    model = serving_model(cfg, dev, torch.float32)
    engine_fp32_checks(model, cfg, dev, counters)
    del model
    torch.cuda.empty_cache()

    model = serving_model(cfg, dev, torch.bfloat16)
    reqs = serving_requests(cfg, dev, CHURN_REQUESTS, SEED, CHURN_NEW, pad_to=CHURN_PROMPT)
    card = card_line()
    churn_engine(model, reqs[:8], dev, counters, "warm-up")            # first calls of each prefill shape
    static_batches(model, reqs[:8], dev)
    paths, vpaths, runs = {}, {}, {}
    for depth in CHURN_DEPTHS:
        tokens, rec = churn_engine(model, reqs, dev, counters, f"churn depth {depth}", depth=depth)
        rec.pop("engine")
        want = serving_launches(cfg, counters, rec["counts"])
        require(rec["launches"] == want, f"churn depth {depth} launches {rec['launches']}, expected {want}")
        runs[depth] = tokens, rec
        log({"phase": "serving", "dtype": "bfloat16", **{k: v for k, v in rec.items() if k != "variants"},
             "card": card})
    # depth 0 and depth 4 run the same kernels on the same rows: a token routed to the wrong tenant by the
    # dispatch-time snapshot would part them
    require(runs[CHURN_DEPTHS[0]][0] == runs[CHURN_DEPTHS[1]][0],
            f"churn: depth {CHURN_DEPTHS[1]}'s tokens differ from depth {CHURN_DEPTHS[0]}'s")
    static, static_s = static_batches(model, reqs, dev)
    useful = sum(r["max_new"] for r in reqs)
    log({"phase": "serving", "dtype": "bfloat16", "compare": "churn: engine depth 0 / 4 against static batching",
         "card": card, "useful_tokens": useful, "static_seconds": static_s, "static_useful_tokens_per_s": useful / static_s,
         "generated_static_tokens": sum(8 * max(r["max_new"] for r in reqs[k:k + 8]) for k in range(0, len(reqs), 8)),
         **{f"depth{d}_useful_tokens_per_s": runs[d][1]["useful_tokens_per_s"] for d in CHURN_DEPTHS},
         "engine_equal_static": sum(a == b for a, b in zip(runs[0][0], static))})
    paths["serving_fused"], vpaths["serving_fused"] = runs[0][1]["launches"], runs[0][1]["variants"]
    sync_free_chunk(model, reqs, dev)
    paths["serving_absorb"], vpaths["serving_absorb"] = serve_absorbed(model, cfg, reqs, dev, counters, runs[0][0])
    paths["serving_int8_kv"], vpaths["serving_int8_kv"] = serve_int8_kv(model, cfg, reqs[:SERVE_INT8_REQUESTS], dev,
                                                                        counters)
    del model
    torch.cuda.empty_cache()
    return paths, vpaths


def speculative_launches(cfg, counters, iters, d) -> dict:
    """The launches of one speculative_generate call on the fused route (MPT
    target and draft): the vision encoded once (K9, K10), both prefills (K4
    a decoder layer, K5 an xattn block), the draft's D + 1 decode steps an
    iteration (K1 1, K2 and K3 one a layer and one an xattn block), and the
    target's verify of D + 1 tokens, K4 and K5 from a window of 8 on."""
    layers, vit = cfg.lm.num_layers, cfg.vision.num_layers
    xattn = layers // cfg.cross_attn_every_n
    steps = iters * (d + 1)
    verify = iters if d + 1 >= 8 else 0
    want = {name: 0 for name in counters}
    want.update(fused_dense=steps, fused_mlp=steps * (layers + xattn), attn_block_decode=steps * (layers + xattn),
                flash_attention=(2 + verify) * layers, masked_xattn=(2 + verify) * xattn, vit_attention=vit,
                layer_norm=2 * vit)
    return want


@torch.no_grad()
def phase_speculative(dev) -> tuple:
    """speculative_generate on full-width OF-3B (create_model_and_transforms)
    with an int4 copy of the same weights as the draft, B 1 and 8 (rows 0 and
    1 left-padded), D 4 and 7 (D 7's verify window of 8 runs K4 and K5), a
    32-token prompt, 64 new tokens. fp32 (SPEC_FP32): each row's tokens
    those of the target's flamingo_generate (two parts at a near tie); a
    self-draft (draft = target) at B 8 takes ceil(63 / (D + 1)) iterations
    (13 at D 4, 8 at D 7: every window accepted). bf16, B 1 and 8 at D 4
    and 7: host clock in turns (generate, then speculative) against the
    target's flamingo_generate, iterations, tokens per target forward and
    exact launches (the draft's int4 variants). Returns ({path: launches},
    {path: variants})."""
    counters = kernel_functions()
    cfg = model_config("OF-3B")
    vision_x, ids, mask = make_inputs(cfg, dev)
    batches = {1: (vision_x[:1], ids[:1], mask[:1]), 8: (vision_x, ids, mask)}
    gcfg = GenerationConfig(max_new_tokens=SPEC_NEW, pad_token_id=0)
    target = serving_model(cfg, dev, torch.float32)
    draft = quantize_decode_weights(copy.deepcopy(target), 4)
    refs = {}
    for b, d, kind in SPEC_FP32:
        inputs = batches[b]
        if b not in refs:
            refs[b] = flamingo_generate(target, *inputs, gcfg, device=dev), []
        want, memo = refs[b]

        def ref(i, inputs=inputs, want=want, memo=memo):
            if not memo:
                vx, ids, mask = inputs
                memo.append(step_logits(target, target.embed_vision(vx), ids, mask, want,
                                        max_seq=-(-(ids.shape[1] + SPEC_NEW) // 16) * 16).float())
            return memo[0][:, i]

        got, stats = speculative_generate(target, draft if kind == "int4" else target, *inputs, gcfg,
                                          num_draft_tokens=d, return_stats=True, device=dev)
        equal = tokens_agree("speculative", f"fp32 B{b} D{d} {kind} draft vs flamingo_generate", got.tolist(),
                             want.tolist(), ref, LOGITS_TOL)
        rec = {"phase": "speculative", "dtype": "float32", "batch": b, "draft_tokens": d, "draft": kind,
               "iters": stats["iters"], "tokens_per_target_forward": SPEC_NEW / stats["iters"], "rows_equal": equal}
        if kind == "self":
            rec["full_acceptance_iters"] = full = math.ceil((SPEC_NEW - 1) / (d + 1))   # 1 from prefill, D + 1 a window
            require(stats["iters"] == full, f"fp32 self-draft D{d}: {stats['iters']} iterations, not {full}")
        log(rec)
    del target, draft, refs
    torch.cuda.empty_cache()

    target = serving_model(cfg, dev, torch.bfloat16)
    draft = quantize_decode_weights(copy.deepcopy(target), 4)
    card = card_line()
    paths, vpaths = {}, {}
    for b, d in ((8, 4), (8, 7), (1, 4), (1, 7)):
        inputs = batches[b]
        times = {}
        for name in ("generate", "speculative"):
            if name == "speculative":
                reset_counters(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "generate":
                ref = flamingo_generate(target, *inputs, gcfg, device=dev)
            else:
                got, stats = speculative_generate(target, draft, *inputs, gcfg, num_draft_tokens=d,
                                                  return_stats=True, device=dev)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        variants = {name: dict(fn.variants) for name, fn in counters.items() if hasattr(fn, "variants")}
        iters = stats["iters"]
        want = speculative_launches(cfg, counters, iters, d)
        steps = iters * (d + 1)
        layers = cfg.lm.num_layers + cfg.lm.num_layers // cfg.cross_attn_every_n
        want_v = {"fused_dense": {"int8": steps}, "fused_mlp": {"int4": steps * layers},
                  "attn_block_decode": {"int4": steps * layers}}
        spec_s, gen_s = times["speculative"], times["generate"]
        log({"phase": "speculative", "dtype": "bfloat16", "batch": b, "draft_tokens": d, "draft": "int4",
             "card": card, "iters": iters, "tokens_per_target_forward": SPEC_NEW / iters, "seconds": times,
             "speculative_tokens_per_s": b * SPEC_NEW / spec_s, "generate_tokens_per_s": b * SPEC_NEW / gen_s,
             "speedup": gen_s / spec_s, "tokens_equal_generate": torch.equal(got, ref),
             "rows_equal_generate": int((got == ref).all(1).sum()), "launches": launches, "variants": variants})
        require(launches == want, f"speculative B{b} D{d} launches {launches}, expected {want}")
        require(all(variants[k] == v for k, v in want_v.items()), f"speculative B{b} D{d} variants {variants}")
        if b == 8:
            paths[f"speculative_d{d}"], vpaths[f"speculative_d{d}"] = launches, variants
    del target, draft
    torch.cuda.empty_cache()
    return paths, vpaths


def train_batches(cfg, dev):
    """The bench shape (bench.py:494) with uint8 pixels: LAION 8x32, one
    image, <|endofchunk|> mid-row; MMC4 4x256, six images, text before the
    first, each later one after an <|endofchunk|>. Rows 1 and 6 of LAION
    and 2 and 3 of MMC4 end in padding."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    px = cfg.vision.image_size

    def batch(b, t, media_at, pads):
        ids = torch.randint(10, 50000, (b, t), generator=gen, device=dev)
        ids[:, media_at] = cfg.media_token_id
        ids[:, [p - 1 for p in media_at[1:]] or [t // 2]] = cfg.eoc_token_id
        mask = torch.ones(b, t, dtype=torch.long, device=dev)
        for r, n in pads:
            ids[r, t - n:] = TRAIN_PAD
            mask[r, t - n:] = 0
        vision = torch.randint(0, 256, (b, len(media_at), 1, px, px, 3), generator=gen, device=dev)
        return {"vision_x": vision.to(torch.uint8), "input_ids": ids, "attention_mask": mask}

    return (batch(B_L, T_L, [0], [(1, 5), (6, 9)]),
            batch(B_M, T_M, [3 + 42 * j for j in range(N_IMG)], [(2, 20), (3, 37)]))


def phase_train(dev, counters) -> dict:
    cfg = flamingo_config("OF-3B")
    loop_cfg = TrainLoopConfig(pad_token_id=TRAIN_PAD)
    bl, bm = train_batches(cfg, dev)

    # (a) fp32: one step's loss and trainable gradients, kernels vs plain_path()
    t0 = time.perf_counter()
    model = init_random(cfg, SEED, device=dev, dtype=torch.float32)
    trainable, _ = split_params(model)

    def loss_and_grads():
        for p in trainable.values():
            p.grad = None
        loss_l, loss_m = batch_losses(model, bl, bm, loop_cfg)
        total = loop_cfg.loss_multiplier_laion * loss_l + loop_cfg.loss_multiplier_mmc4 * loss_m
        total.backward()
        return total.item(), {n: p.grad for n, p in trainable.items()}

    loss_k, grads_k = loss_and_grads()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    rel = {n: ((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item() for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    log({"phase": "train", "dtype": "float32", "compare": "kernels vs plain_path", "loss_kernels": loss_k,
         "loss_plain": loss_p, "loss_abs_err": abs(loss_k - loss_p), "loss_tol": LOSS_TOL,
         "trainable_tensors": len(rel), "worst_tensor": worst, "worst_rel_err": rel[worst],
         "worst_max_abs_grad": grads_p[worst].abs().max().item(), "grad_rtol": GRAD_RTOL,
         "median_rel_err": sorted(rel.values())[len(rel) // 2], "seconds": time.perf_counter() - t0})
    require(all(torch.isfinite(g).all().item() for g in grads_k.values()), "fp32 kernel gradients not finite")
    require(abs(loss_k - loss_p) <= LOSS_TOL, f"fp32 train loss {loss_k} vs plain {loss_p}")
    require(rel[worst] <= GRAD_RTOL, f"fp32 gradient {worst}: relative error {rel[worst]}")
    del model, trainable, grads_k, grads_p
    torch.cuda.empty_cache()

    # (b) bf16, the dtype the JAX package's bench trains in, timed
    t0 = time.perf_counter()
    model = init_random(cfg, SEED, device=dev, dtype=torch.bfloat16)
    trainable, _ = split_params(model)
    tx = make_optimizer(OptimizerConfig(warmup_steps=0), media_token_id=cfg.media_token_id,
                        eoc_token_id=cfg.eoc_token_id)
    step = make_train_step(model, tx, loop_cfg)
    state = TrainState.create(trainable, tx)
    wte0 = model.lm.wte.weight.detach().clone()
    state, metrics = step(state, bl, bm)                 # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    layers = cfg.lm.num_layers
    want = {name: 0 for name in counters}
    vit = cfg.vision.num_layers      # two ViT forwards per step: the LAION and the MMC4 batch
    want.update(flash_attention=2 * layers, flash_attention_backward=2 * layers, masked_xattn=2 * layers,
                masked_xattn_backward=2 * layers, vit_attention=2 * vit, layer_norm=4 * vit)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, bl, bm)
        losses.append({k: v.item() for k, v in metrics.items()})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {name: fn.launches for name, fn in counters.items()}
        require(launches == want, f"train step launches {launches}, expected {want}")
    moved = (model.lm.wte.weight.detach() != wte0).any(-1)
    special = [cfg.media_token_id, cfg.eoc_token_id]
    others_moved = int(moved.sum()) - int(moved[special].sum())
    step_s = sorted(times)[len(times) // 2]
    tokens, images = B_L * T_L + B_M * T_M, B_L + B_M * N_IMG
    log({"phase": "train", "dtype": "bfloat16", "steps": TRAIN_STEPS, "step_s": times, "median_step_s": step_s,
         "tokens_per_step": tokens, "images_per_step": images, "tokens_per_s": tokens / step_s,
         "images_per_s": images / step_s, "warmup_s": warm_s, "metrics": losses, "launches_per_step": launches,
         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "special_rows_moved": int(moved[special].sum()),
         "other_wte_rows_moved": others_moved, "state_step": state.step})
    require(all(math.isfinite(v) for m in losses for v in m.values()), "bf16 train metrics not finite")
    require(others_moved == 0 and bool(moved[special].all()), "wte rows other than <image>/<|endofchunk|> moved")
    del model, state, trainable
    torch.cuda.empty_cache()
    return launches


def kernel_functions() -> dict:
    return {"fused_dense": fused_dense, "fused_mlp": fused_mlp, "attn_block_decode": attn_block_decode,
            "flash_attention": flash_attention, "masked_xattn": masked_xattn,
            "decode_attention": decode_attention, "decode_attention_update": decode_attention_update,
            "flash_attention_backward": flash_attention_backward, "masked_xattn_backward": masked_xattn_backward,
            "attend_out_decode": attend_out_decode, "vit_attention": vit_attention, "layer_norm": ln_op.layer_norm,
            "flat_vit_attention": flat_vit_attention, "fused_layer_decode": fused_layer_decode}


SOURCES = {
    "fused_dense": ("open_flamingo_tpu_torch/csrc/dense_stream.cu", "open_flamingo_tpu/ops/dense_stream.py:196"),
    "fused_mlp": ("open_flamingo_tpu_torch/csrc/dense_stream.cu", "open_flamingo_tpu/ops/dense_stream.py:537"),
    "attn_block_decode": ("open_flamingo_tpu_torch/csrc/decode_layer.cu", "open_flamingo_tpu/ops/decode_layer.py:426"),
    "flash_attention": ("open_flamingo_tpu_torch/csrc/prefill_attention.cu", "open_flamingo_tpu/ops/flash_attention.py:40"),
    "masked_xattn": ("open_flamingo_tpu_torch/csrc/prefill_attention.cu", "open_flamingo_tpu/ops/masked_xattn.py:38"),
    "decode_attention": ("open_flamingo_tpu_torch/csrc/decode_attention.cu", "open_flamingo_tpu/ops/decode_attention.py:45"),
    "decode_attention_update": ("open_flamingo_tpu_torch/csrc/decode_attention.cu", "open_flamingo_tpu/ops/decode_attention.py:45"),
    # dq kernels; the dkv kernels are flash_attention.py:270 and masked_xattn.py:196
    "flash_attention_backward": ("open_flamingo_tpu_torch/csrc/attention_backward.cu", "open_flamingo_tpu/ops/flash_attention.py:199"),
    "masked_xattn_backward": ("open_flamingo_tpu_torch/csrc/attention_backward.cu", "open_flamingo_tpu/ops/masked_xattn.py:148"),
    "attend_out_decode": ("open_flamingo_tpu_torch/csrc/decode_layer.cu", "open_flamingo_tpu/ops/decode_layer.py:65"),
    "vit_attention": ("open_flamingo_tpu_torch/csrc/vit_attention.cu", "open_flamingo_tpu/ops/vit_attention.py:57"),
    "layer_norm": ("open_flamingo_tpu_torch/csrc/layer_norm.cu", "open_flamingo_tpu/ops/layer_norm.py:47"),
    "flat_vit_attention": ("open_flamingo_tpu_torch/csrc/vit_attention.cu",
                           "open_flamingo_tpu/ops/vit_attention.py:117"),
    "fused_layer_decode": ("open_flamingo_tpu_torch/csrc/fused_layer.cu", "open_flamingo_tpu/ops/fused_layer.py:94"),
}
# K2b, the side tiles K2 carries, K2b int8 (the W8A8 tile) and K2b-attn (K3 carrying them): source and TPU code
SIDE_SOURCES = {
    ("fused_mlp", "+side"): ("open_flamingo_tpu_torch/csrc/side_tile.cuh", "open_flamingo_tpu/ops/dense_stream.py:422"),
    ("fused_mlp", "+side8"): ("open_flamingo_tpu_torch/csrc/side_tile.cuh",
                              "open_flamingo_tpu/ops/dense_stream.py:441"),
    ("attn_block_decode", "+side"): ("open_flamingo_tpu_torch/csrc/decode_layer.cu",
                                     "open_flamingo_tpu/ops/decode_layer.py:487"),
    ("attn_block_decode", "+side8"): ("open_flamingo_tpu_torch/csrc/side_tile.cuh",
                                      "open_flamingo_tpu/ops/decode_layer.py:487"),
}


# the quantized variants: kernels-line name -> (kernel, main case, the path
# that runs it, its launch-counter key)
VARIANTS = {
    "fused_dense[int8]": ("fused_dense", "head_V50434_int8", "of3b_int8", "int8"),
    "fused_dense[int4]": ("fused_dense", "neox_qkv_bias_int4", "of4b_int4", "int4"),
    "fused_mlp[int8]": ("fused_mlp", "mpt_mlp_int8", "of3b_int8", "int8"),
    "fused_mlp[int4]": ("fused_mlp", "mpt_mlp_int4", "of3b_int4", "int4"),
    "attn_block_decode[int8]": ("attn_block_decode", "self_S64_slot40_int8", "of3b_int8", "int8"),
    "attn_block_decode[int4]": ("attn_block_decode", "self_S64_slot40_int4", "of3b_int4", "int4"),
    "attn_block_decode[int8+kv8]": ("attn_block_decode", "self_S64_slot40_int8_kv8", "of3b_int8_kv8", "int8+kv8"),
    "attend_out_decode[int8+kv8]": ("attend_out_decode", "neox_S64_slot40_int8_kv8", "of4b_int8_kv8", "int8+kv8"),
    "attend_out_decode[int4]": ("attend_out_decode", "neox_S64_slot40_int4", "of4b_int4", "int4"),
    "fused_dense[float+rms]": ("fused_dense", "llama_q_rms", "llama7b_generate_fused", "float+rms"),
    "fused_dense[int8+rms]": ("fused_dense", "llama_q_rms_int8", "llama7b_int8", "int8+rms"),
    "fused_dense[int4+rms]": ("fused_dense", "llama_q_rms_int4", "llama7b_int4", "int4+rms"),
    "fused_mlp[float+rms+swiglu+silu]": ("fused_mlp", "llama_swiglu", "llama7b_generate_fused",
                                         "float+rms+swiglu+silu"),
    "fused_mlp[int8+rms+swiglu+silu]": ("fused_mlp", "llama_swiglu_int8", "llama7b_int8", "int8+rms+swiglu+silu"),
    "fused_mlp[int4+rms+swiglu+silu]": ("fused_mlp", "llama_swiglu_int4", "llama7b_int4", "int4+rms+swiglu+silu"),
    "fused_mlp[float+relu]": ("fused_mlp", "opt_mlp_relu_bias", "opt13b_generate_fused", "float+relu"),
    "fused_mlp[float+side]": ("fused_mlp", "mpt_mlp_side_qkv", "absorb_bf16", "float+side"),
    "fused_mlp[int4+side]": ("fused_mlp", "mpt_mlp_int4_side_qkv", "absorb_int4", "int4+side"),
    "fused_mlp[int4+side8]": ("fused_mlp", "mpt_mlp_int4_B64_side8_qkv", "pipe_int4_w8a8", "int4+side8"),
    "fused_mlp[int8+side8]": ("fused_mlp", "mpt_mlp_int8_side8_qkv", "absorb_fp32_int8", "int8+side8"),
    "attn_block_decode[int4+side8]": ("attn_block_decode", "self_S64_slot40_int4_B64_side8_qkv",
                                      "pipe_int4_w8a8_attn", "int4+side8"),
    "attn_block_decode[float+side]": ("attn_block_decode", "self_S64_slot40_side", "absorb_fp32_attn", "float+side"),
    "fused_layer_decode[float+xattn]": ("fused_layer_decode", "xattn_layer_S64", "generate_fused_layer",
                                        "float+xattn"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    seconds = {}
    t0 = time.perf_counter()
    phase_build()
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = phase_kernels(dev)
    phase_backward(dev, timing)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_vit(dev)
    seconds["vit"] = time.perf_counter() - t0
    # per path: every kernel's launches, and the decode kernels' per-variant launches
    paths, vpaths = {}, {}
    for name, tag in (("OF-3B", "generate"), ("OF-4B", "of4b_generate"), ("LLaMA-7B", "llama7b_generate"),
                      ("OPT-1.3B", "opt13b_generate")):
        t0 = time.perf_counter()
        paths[f"{tag}_fused"], paths[f"{tag}_unfused"], vpaths[f"{tag}_fused"], more, vmore = phase_generate(dev, name)
        paths.update(more)
        vpaths.update(vmore)
        seconds[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    absorb_paths, absorb_vpaths = phase_absorb(dev)
    paths.update(absorb_paths)
    vpaths.update(absorb_vpaths)
    seconds["absorb"] = time.perf_counter() - t0
    for tag, phase in (("serving", phase_serving), ("speculative", phase_speculative)):
        t0 = time.perf_counter()
        more, vmore = phase(dev)
        paths.update(more)
        vpaths.update(vmore)
        seconds[tag] = time.perf_counter() - t0
    for name, tag in (("OF-3B", "quantized"), ("OF-4B", "quantized_of4b"), ("LLaMA-7B", "quantized_llama7b")):
        t0 = time.perf_counter()
        vpaths.update(phase_quantized(dev, name))
        seconds[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counters = kernel_functions()
    paths["train_step"] = phase_train(dev, counters)
    seconds["train"] = time.perf_counter() - t0
    log({"phase": "seconds", **seconds})
    kernels = []

    def entry(name, kernel, variant, path, by_path, main_case):
        t = timing[kernel][main_case]
        src, replaces = SOURCES[kernel]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": by_path[path],
                "launches_by_path": by_path, "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "library_is": t["library_is"], "case": t["case"], "path": path, "variant": variant,
                **{key: t[key] for key in ("two_launch_ms", "fma_ms", "fma_max_abs_err") if key in t},
                "other_cases": [r for c, r in timing[kernel].items() if c != main_case and r.get("variant", "float") == variant]}

    for name in SOURCES:
        # each kernel's count from the path of its main case, every path beside it
        case, path = MAIN_CASES[name]
        by_path = {p: counts[name] for p, counts in paths.items()}
        require(by_path[path] > 0, f"{name}: no launch on {path}")
        kernels.append(entry(name, name, "float", path, by_path, case))
    for name, (kernel, main_case, path, key) in VARIANTS.items():
        by_path = {p: v.get(kernel, {}).get(key, 0) for p, v in vpaths.items()}
        require(by_path[path] > 0, f"{name}: no launch on {path}")
        kernels.append(entry(name, kernel, key, path, by_path, main_case))
        side = "+side8" if key.endswith("+side8") else "+side" if key.endswith("+side") else None
        if side:
            kernels[-1]["source"], kernels[-1]["replaces"] = SIDE_SOURCES[kernel, side]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
