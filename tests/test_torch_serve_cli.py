"""The port's serve CLI (`open_flamingo_tpu_torch/scripts/serve.py`, the JAX
package's `scripts/serve.py`) end to end on the CPU: jsonl requests in,
jsonl results out in submission order, the latency distribution on stderr,
through the ServingEngine over a tiny registry entry (ViT-Tiny and a tiny
MPT patched into the factory's LM registry). Each request's tokens are the
port's flamingo_generate greedy tokens on the same model, and the same with
a released checkpoint grafted over the random weights; `--int8_decode`
streams the quantized copies. No PIL or transformers on these paths."""

import json

import pytest
import torch

from open_flamingo_tpu_torch import factory
from open_flamingo_tpu_torch.configs import DecoderConfig
from open_flamingo_tpu_torch.convert.flamingo_ckpt import export_flamingo_checkpoint
from open_flamingo_tpu_torch.generation import GenerationConfig, flamingo_generate
from open_flamingo_tpu_torch.models.flamingo import init_random
from open_flamingo_tpu_torch.scripts.serve import main

TINY = DecoderConfig(family="mpt", vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                     alibi=True, attention_bias=False, ln_no_bias=True)
ARGS = ["--vision_encoder_path", "ViT-Tiny", "--lm_path", "tiny-mpt", "--batch_rows", "2", "--max_seq_len", "96",
        "--max_prompt_len", "16", "--chunk_tokens", "4", "--precision", "fp32", "--device", "cpu"]


@pytest.fixture(autouse=True)
def tiny_registry(monkeypatch):
    monkeypatch.setitem(factory._LM_REGISTRY, "tiny-mpt", TINY)


def served(capsys, argv):
    main(ARGS + argv)
    out, err = capsys.readouterr()
    return [json.loads(line) for line in out.strip().splitlines()], json.loads(err.strip().splitlines()[-1])


def greedy(model, tokenizer, prompt, max_new):
    """The port's flamingo_generate on one request, as the CLI builds it."""
    tokenizer.padding_side = "left"
    enc = tokenizer([prompt], return_tensors="pt")
    size = model.cfg.vision.image_size
    cfg = GenerationConfig(max_new_tokens=max_new, pad_token_id=tokenizer.pad_token_id or 0,
                           eos_token_id=model.cfg.eoc_token_id)
    out = flamingo_generate(model, torch.zeros(1, 1, 1, size, size, 3), enc["input_ids"], enc["attention_mask"],
                            cfg, device="cpu")[0].tolist()
    return out[:out.index(cfg.eos_token_id) + 1] if cfg.eos_token_id in out else out


def test_serve_synthetic(capsys):
    lines, err = served(capsys, ["--synthetic", "3", "--default_max_new_tokens", "6"])
    assert [r["id"] for r in lines] == [0, 1, 2]
    assert lines[0]["token_ids"] == lines[1]["token_ids"] == lines[2]["token_ids"]
    assert all(isinstance(r["text"], str) and len(r["token_ids"]) <= 6 for r in lines)
    model, _, tokenizer = factory.create_model_and_transforms("ViT-Tiny", "openai", "tiny-mpt", init_params=True,
                                                              device="cpu")
    assert lines[0]["token_ids"] == greedy(model, tokenizer, "<image>An image of", 6)
    lat = err["latency"]
    assert lat["n_requests"] == 3
    assert {"ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "e2e_p50_s", "e2e_p99_s"} <= set(lat)
    assert 0 < lat["ttft_p50_s"] <= lat["e2e_p99_s"]


def test_serve_jsonl_int8(tmp_path, capsys, monkeypatch):
    """A jsonl file without images, in submission order, with the int8 decode
    copies streamed (the plain decode versions see int8 weights)."""
    from open_flamingo_tpu_torch.ops import dense_stream

    monkeypatch.setattr(dense_stream, "FORCE_FUSED", True)
    seen = []
    real = dense_stream.weight_values
    monkeypatch.setattr(dense_stream, "weight_values", lambda w: seen.append(w.dtype) or real(w))
    req = tmp_path / "reqs.jsonl"
    req.write_text("\n".join(json.dumps(r) for r in (
        {"prompt": "<image>An image of", "max_new_tokens": 5},
        {"prompt": "<image>A photo of a", "max_new_tokens": 7},
        {"prompt": "<image>A", "max_new_tokens": 3})) + "\n")
    lines, err = served(capsys, ["--requests", str(req), "--int8_decode"])
    assert [r["id"] for r in lines] == [0, 1, 2]
    assert [len(r["token_ids"]) <= n for r, n in zip(lines, (5, 7, 3))] == [True] * 3
    assert err["latency"]["n_requests"] == 3
    assert torch.int8 in seen and torch.float32 not in seen


def test_serve_checkpoint(tmp_path, capsys):
    """--checkpoint_path grafts a released checkpoint (the trainable set, from
    a model of another seed) over the random weights: the tokens are
    flamingo_generate's on that model."""
    model, _, tokenizer = factory.create_model_and_transforms("ViT-Tiny", "openai", "tiny-mpt", init_params=True,
                                                              device="cpu")
    other = init_random(model.cfg, seed=5, device="cpu")
    path = tmp_path / "checkpoint.pt"
    torch.save({"model_state_dict": export_flamingo_checkpoint(other, "mpt")}, path)
    lines, _ = served(capsys, ["--synthetic", "1", "--default_max_new_tokens", "6", "--checkpoint_path", str(path)])
    assert lines[0]["token_ids"] != greedy(model, tokenizer, "<image>An image of", 6)
    with torch.no_grad():
        for name, p in other.named_parameters():
            if name.startswith(("perceiver.", "lm.xattn.")) or name == "lm.wte.weight":
                model.get_parameter(name).copy_(p)
    assert lines[0]["token_ids"] == greedy(model, tokenizer, "<image>An image of", 6)
