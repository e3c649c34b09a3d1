#!/usr/bin/env python3
"""Where one greedy generate call of the PyTorch port spends its time on
the card.

    python3 chip_profile.py            # the fused decode route (K1-K3)
    python3 chip_profile.py unfused    # the unfused route (K7, DISABLE_FUSED)

Builds OF-3B at full width with random weights (bf16), runs the same
inputs as chip_smoke.py (8 prompts of 32 tokens, one image each, 32 new
tokens), warms up once, then traces one call with torch.profiler. Prints
one JSON line: wall seconds, the device's busy time (sum of the device
events' times; one stream, so they do not overlap) and idle share, the
device time of each hand-written kernel, and the kernels with the most
device time. Run from the repository root with one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import B, NEW_TOKENS, SEED, card_line, kernel_functions, make_inputs
    from open_flamingo_tpu_torch.configs import flamingo_config
    from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
    from open_flamingo_tpu_torch.models.flamingo import init_random
    from open_flamingo_tpu_torch.ops import dense_stream

    route = sys.argv[1] if len(sys.argv) > 1 else "fused"
    if route not in ("fused", "unfused"):
        print(f"chip_profile: unknown route {route!r}", file=sys.stderr)
        return 2
    dense_stream.DISABLE_FUSED = route == "unfused"
    dev = torch.device("cuda", 0)
    cfg = flamingo_config("OF-3B")
    vision_x, ids, mask = make_inputs(cfg, dev)
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    model = init_random(cfg, SEED, device=dev, dtype=torch.bfloat16)
    flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
    torch.cuda.synchronize()
    wall_untraced = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        flamingo_generate(model, vision_x, ids, mask, gcfg, device=dev)
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
    # device symbols of the hand-written kernels: the row GEMV serves K1, K2
    # and K3's projections; K3's softmax is attend_kernel
    ported = {kern: sum(r[1] for r in rows if kern in r[0])
              for kern in ("gemv_kernel", "attend_kernel", "attention_fwd_kernel", "decode_kernel")}
    launches = {name: fn.launches for name, fn in kernel_functions().items()}
    print(json.dumps({
        "profile": "generate_bf16", "route": route, "batch": B, "new_tokens": NEW_TOKENS,
        "wrapper_launches_since_start": launches,
        "wall_s_untraced": wall_untraced, "wall_s_traced": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall, "device_idle_share_untraced": 1.0 - busy / wall_untraced,
        "aten_op_rows_device_s": op_rows_s,
        "ported_kernel_device_s": ported,
        "top": [{"name": k[:80], "device_s": s, "count": n} for k, s, n in rows[:12]],
    }), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
