#!/usr/bin/env python3
"""Where one greedy generate call, or one training step, of the PyTorch
port spends its time on the card.

    python3 chip_profile.py            # generate, the fused decode route (K1-K3)
    python3 chip_profile.py unfused    # generate, the unfused route (K7, DISABLE_FUSED)
    python3 chip_profile.py train      # one bf16 train step (K4/K5 and K4b/K5b)
    python3 chip_profile.py of4b       # OF-4B generate, the fused route (K1, K6, K2; K3)
    python3 chip_profile.py int8       # OF-3B generate, fused, int8 weights and the int8 K/V + media caches
    python3 chip_profile.py int4       # OF-3B generate, fused, int4 weights (the head int8)

Builds OF-3B (OF-4B for `of4b`) at full width with random weights
(bf16), runs the same inputs as chip_smoke.py (generate: 8 prompts of 32
tokens, one image each, 32 new tokens; train: LAION 8x32 and MMC4 4x256
with six images), warms up once, times one untraced call, then traces one
call with torch.profiler.
Prints one JSON line: wall seconds, the device's busy time (sum of the
device events' times; one stream, so they do not overlap) and idle share,
the device time of each hand-written kernel, and the kernels with the most
device time. Run from the repository root with one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import re
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, NEW_TOKENS, SEED, TRAIN_PAD, card_line, kernel_functions, make_inputs, train_batches
    from open_flamingo_tpu_torch.configs import flamingo_config
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
    from open_flamingo_tpu_torch.models.flamingo import init_random
    from open_flamingo_tpu_torch.ops import dense_stream
    from open_flamingo_tpu_torch.quantize import quantize_decode_weights
    from open_flamingo_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer, split_params
    from open_flamingo_tpu_torch.train.train_loop import TrainLoopConfig, TrainState, make_train_step

    mode = sys.argv[1] if len(sys.argv) > 1 else "fused"
    if mode not in ("fused", "unfused", "train", "of4b", "int8", "int4"):
        print(f"chip_profile: unknown mode {mode!r}", file=sys.stderr)
        return 2
    dense_stream.DISABLE_FUSED = mode == "unfused"
    dev = torch.device("cuda", 0)
    cfg = flamingo_config("OF-4B" if mode == "of4b" else "OF-3B")
    model = init_random(cfg, SEED, device=dev, dtype=torch.bfloat16)
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
    # on CUDA cores, gemv_mma_kernel on tensor cores) serves K1, K2 and the
    # projections of K3 and K6; K3's softmax is attend_kernel, K6's
    # attend_out_kernel; K4 and K5 share attention_fwd_kernel, K4b and K5b
    # the two backward kernels. The quantized variants are template cases of
    # the same symbols: the row GEMV over int8 weights names `signed char`
    # among its template arguments, over packed int4 `Int4` (split out below)
    ported = {kern: sum(r[1] for r in rows if kern in r[0])
              for kern in ("gemv", "attend_kernel", "attend_out_kernel", "attention_fwd_kernel", "decode_kernel",
                           "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")}
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
    print(json.dumps({
        "profile": "train_step_bf16" if mode == "train" else "generate_bf16", "mode": mode, "model": cfg.lm.family,
        **shape,
        "wrapper_launches_since_start": launches,
        "wall_s_untraced": wall_untraced, "wall_s_traced": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall, "device_idle_share_untraced": 1.0 - busy / wall_untraced,
        "aten_op_rows_device_s": op_rows_s,
        "ported_kernel_device_s": ported, "gemv_device_s_by_weight": gemv_by_weight, "device_s_by_kind": by_kind,
        "device_events": sum(r[2] for r in rows),
        "top": [{"name": k[:80], "device_s": s, "count": n} for k, s, n in rows[:12]],
    }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
