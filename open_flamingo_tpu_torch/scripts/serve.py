"""Serve OpenFlamingo requests through the continuous-batching
ServingEngine (`serving.py`): jsonl requests in, jsonl tokens and text out.

    python -m open_flamingo_tpu_torch.scripts.serve --synthetic 8
    python -m open_flamingo_tpu_torch.scripts.serve --requests reqs.jsonl --checkpoint_path checkpoint.pt

Each input line (a file given by --requests, or stdin):
    {"prompt": "<image>An image of", "images": ["/path.jpg"], "max_new_tokens": 32}
Each output line (stdout, in submission order):
    {"id": 0, "token_ids": [...], "text": "..."}
The latency distribution (`ServingEngine.latency_stats`) goes to stderr.

Prompts use the reference's <image> / <|endofchunk|> conventions; rows keep
decoding while finished rows are refilled from the queue, and each
request's tokens are exactly flamingo_generate's greedy tokens. The model
comes from `create_model_and_transforms` with weights drawn from seed 0,
the released checkpoint (`--checkpoint_path`, the trainable set) grafted
over them; `--int8_decode` / `--int4_decode` attach quantized decode
weights. `--synthetic N` serves N dummy requests with zero images; PIL is
imported only when a request names an image. Runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--requests", default=None, help="jsonl file of requests; default: stdin")
    p.add_argument("--vision_encoder_path", default="ViT-L-14")
    p.add_argument("--lm_path", default="mosaicml/mpt-1b-redpajama-200b")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--checkpoint_path", default=None, help="a released OpenFlamingo checkpoint.pt")
    p.add_argument("--cross_attn_every_n_layers", type=int, default=1)
    p.add_argument("--precision", default="bf16", choices=("bf16", "fp32"))
    p.add_argument("--int8_decode", action="store_true")
    p.add_argument("--int4_decode", action="store_true")
    p.add_argument("--int8_kv", action="store_true")
    p.add_argument("--batch_rows", type=int, default=8, help="concurrent cache rows (tenants)")
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--max_prompt_len", type=int, default=64)
    p.add_argument("--chunk_tokens", type=int, default=8)
    p.add_argument("--pipeline_depth", type=int, default=4,
                   help="decoded chunks kept in flight before their tokens are read on the host "
                        "(0: read every chunk at once)")
    p.add_argument("--t_img", type=int, default=1, help="media slots per request (fixed per engine)")
    p.add_argument("--absorb_vision", action="store_true",
                   help="encode queued requests' images as side tiles of the decode chunks "
                        "(models/absorb_vit.py); admissions then skip the vision encode")
    p.add_argument("--absorb_batch", type=int, default=None,
                   help="images per pre-encode cycle (default: batch_rows)")
    p.add_argument("--default_max_new_tokens", type=int, default=32)
    p.add_argument("--synthetic", type=int, default=0, help="serve N dummy requests with zero images and exit")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..factory import _graft, create_model_and_transforms
    from ..generation import GenerationConfig
    from ..serving import ServingEngine

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    model, image_processor, tokenizer = create_model_and_transforms(
        args.vision_encoder_path, "openai", args.lm_path, args.tokenizer_path,
        cross_attn_every_n_layers=args.cross_attn_every_n_layers, init_params=True,
        device=args.device, dtype=dtype,
    )
    if args.checkpoint_path:
        from ..convert.flamingo_ckpt import convert_flamingo_checkpoint

        sd = torch.load(args.checkpoint_path, map_location="cpu", weights_only=True)
        if "model_state_dict" in sd:
            sd = sd["model_state_dict"]
        conv = convert_flamingo_checkpoint(sd)
        if model.cfg.lm.tie_word_embeddings:
            conv.pop("lm.lm_head.weight", None)
        _graft(model, conv, resize_vocab=True)
    if args.int4_decode or args.int8_decode:
        from ..quantize import quantize_decode_weights

        quantize_decode_weights(model, bits=4 if args.int4_decode else 8)

    eng = ServingEngine(
        model, batch_size=args.batch_rows, max_seq_len=args.max_seq_len, max_prompt_len=args.max_prompt_len,
        t_img=args.t_img, chunk_tokens=args.chunk_tokens, pipeline_depth=args.pipeline_depth,
        absorb_vision=args.absorb_vision, absorb_batch=args.absorb_batch, device=args.device,
        gen=GenerationConfig(max_new_tokens=0, pad_token_id=tokenizer.pad_token_id or 0,
                             eos_token_id=model.cfg.eoc_token_id, int8_kv=args.int8_kv),
    )
    if torch.device(args.device).type == "cuda":
        from ..ops import build

        # every source the engine launches (K1-K3, K4/K5, K8-K10), all compiled at once before the first
        # request is submitted: build time stays out of the latencies
        build.build(["dense_stream", "decode_layer", "prefill_attention", "vit_attention", "layer_norm"])
    size = model.cfg.vision.image_size

    def load_images(paths):
        """(t_img, 1, H, W, C) pixels; slots without an image are zero
        images (the reference pads the same way)."""
        out = np.zeros((args.t_img, 1, size, size, 3), np.float32)
        for j, path in enumerate(paths[:args.t_img]):
            from PIL import Image

            out[j, 0] = image_processor(Image.open(path).convert("RGB"))
        return out

    if args.synthetic:
        reqs = [{"prompt": "<image>An image of", "images": [], "max_new_tokens": args.default_max_new_tokens}
                for _ in range(args.synthetic)]
    else:
        if args.requests:
            with open(args.requests) as src:
                lines = src.readlines()
        else:
            lines = sys.stdin.readlines()
        reqs = [json.loads(line) for line in lines if line.strip()]

    tokenizer.padding_side = "left"
    order = []
    for r in reqs:
        enc = tokenizer([r["prompt"]], padding="longest", truncation=True, max_length=args.max_prompt_len,
                        return_tensors="np")
        order.append(eng.submit(load_images(r.get("images", [])), enc["input_ids"][0],
                                attention_mask=enc["attention_mask"][0],
                                max_new_tokens=int(r.get("max_new_tokens", args.default_max_new_tokens))))
    results = eng.run()
    for rid in order:
        ids = results[rid]
        print(json.dumps({"id": rid, "token_ids": ids, "text": tokenizer.decode(ids, skip_special_tokens=True)}),
              flush=True)
    # stdout is the result stream
    print(json.dumps({"latency": eng.latency_stats()}), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
