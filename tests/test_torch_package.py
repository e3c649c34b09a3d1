"""Package rules of the PyTorch port: it imports with JAX blocked, no file
of it (or chip_smoke.py) imports the JAX package, entry points default to
the card and raise without one, and the kernel wrappers never fall back
to the CPU for a non-CPU tensor."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "open_flamingo_tpu_torch"


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_imports_with_jax_blocked():
    """Every module imports without JAX, and without transformers and PIL,
    which the card machine lacks: the factory and the image processor
    import them only where a local HF directory or a PIL image is used."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'open_flamingo_tpu', 'transformers', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from open_flamingo_tpu_torch import ServingEngine, create_model_and_transforms, speculative_generate\n"
        "from open_flamingo_tpu_torch.scripts.serve import main\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "flax", "open_flamingo_tpu"), f"{path}: imports {n}"


def test_default_device_raises_without_cuda(monkeypatch):
    from open_flamingo_tpu_torch.configs import flamingo_config
    from open_flamingo_tpu_torch.models.flamingo import Flamingo, init_random

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_random(flamingo_config("OF-3B"), seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Flamingo(flamingo_config("OF-3B"))


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """create_model_and_transforms and load_pretrained default to the card,
    with or without weights to make; so do the serving engine, speculative
    decoding and the serve CLI."""
    from open_flamingo_tpu_torch import ServingEngine, create_model_and_transforms, speculative_generate
    from open_flamingo_tpu_torch.generation import GenerationConfig
    from open_flamingo_tpu_torch.scripts.serve import main as serve_main
    from open_flamingo_tpu_torch.serialization import load_pretrained

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"init_params": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model_and_transforms(**kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_pretrained(str(tmp_path))
    model = torch.nn.Module()     # never reached: the device is resolved first
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, batch_size=2, max_seq_len=64, max_prompt_len=16)
    ids = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        speculative_generate(model, model, None, ids, ids, GenerationConfig(max_new_tokens=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--synthetic", "1"])


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises, forward
    and backward; the meta device stands in for one here."""
    from open_flamingo_tpu_torch.ops.decode_attention import decode_attention
    from open_flamingo_tpu_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from open_flamingo_tpu_torch.ops.masked_xattn import masked_xattn, masked_xattn_backward

    m = torch.device("meta")
    q, k = torch.empty(2, 8, 16, device=m), torch.empty(2, 8, 16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, k, torch.empty(2, 8, device=m), torch.empty(2, 1, device=m), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        masked_xattn(q, k, k, torch.empty(2, 8, dtype=torch.int32, device=m), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(torch.empty(1, 2, 16, device=m), torch.empty(1, 2, 8, 16, device=m),
                         torch.empty(1, 2, 8, 16, device=m), torch.empty(1, 8, device=m))
    lse = torch.empty(2, 8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_backward(q, k, k, torch.empty(2, 8, device=m), torch.empty(2, 1, device=m), 0, q, lse, q)
    with pytest.raises(ValueError, match="unsupported device"):
        masked_xattn_backward(q, k, k, torch.empty(2, 8, dtype=torch.int32, device=m), 4, q, lse, q)


def test_fused_decode_wrappers_refuse_other_devices():
    """K1-K3 and K6 as well: the meta device stands in for a non-CPU,
    non-CUDA one."""
    from open_flamingo_tpu_torch.ops.decode_layer import attend_out_decode, attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp

    m = torch.device("meta")
    x, w = torch.empty(2, 16, device=m), torch.empty(24, 16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_dense(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp(x, w, torch.empty(16, 24, device=m))
    kv = torch.empty(2, 2, 8, 8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        attn_block_decode(x, torch.empty(16, device=m), None, w[:16], w[:16].t(), kv, kv,
                          torch.empty(2, 8, dtype=torch.bool, device=m), heads=2, head_dim=8, scale=0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        attend_out_decode(torch.empty(2, 2, 8, device=m), kv, kv, torch.empty(2, 8, dtype=torch.bool, device=m),
                          w[:16], scale=0.3)


@pytest.mark.parametrize("grad", [False, True])
def test_vit_kernel_wrappers_refuse_other_devices(grad):
    """K9 and K10, with and without autograd, and K8: the meta device stands
    in for a non-CPU, non-CUDA one."""
    from open_flamingo_tpu_torch.ops.layer_norm import layer_norm
    from open_flamingo_tpu_torch.ops.vit_attention import flat_vit_attention, vit_attention, vit_attention_heads

    m = torch.device("meta")
    x = torch.empty(4, 16, device=m, requires_grad=grad)
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(x, torch.empty(16, device=m), None)
    q = torch.empty(2, 17, 16, device=m, requires_grad=grad)
    with pytest.raises(ValueError, match="unsupported device"):
        vit_attention(q, q, q, 0.25)
    q4 = torch.empty(1, 17, 2, 16, device=m, requires_grad=grad)
    with pytest.raises(ValueError, match="unsupported device"):
        vit_attention_heads(q4, q4, q4, 0.25)
    if not grad:     # K8 has no autograd: the absorbed ViT runs in decode
        with pytest.raises(ValueError, match="unsupported device"):
            flat_vit_attention(q, q, q, 0.25, heads=2, s_real=13)


@pytest.mark.parametrize("call", ["w_scale", "norm", "act", "w1_gate", "side_x", "k_scale", "wout_scale",
                                  "k6_v_scale", "layer_idx", "int4_odd_k", "w1_gate_scale", "k3_side_x",
                                  "float_w_scale", "side_w_scale"])
def test_unported_operands_raise(call):
    """Malformed operands raise ValueError: an int weight without its scale,
    a scale of the wrong shape, an int8 cache without scales (or scales
    without the other), int4 with an odd K, a scale with a weight in x's
    dtype, an RMSNorm with a bias, an unknown activation, w1 and w1_gate in
    two stored types, K6's stacked-layer index, which the port's per-layer
    layout does not take, side_x without side_w (K2's and K3's), and a
    side_w_scale beside a float side_w. (K3's side tiles and the W8A8 side
    tile, once refused here, are ported.)"""
    from open_flamingo_tpu_torch.ops.decode_layer import attend_out_decode, attn_block_decode
    from open_flamingo_tpu_torch.ops.dense_stream import fused_dense, fused_mlp

    x, w = torch.zeros(2, 16), torch.zeros(24, 16)
    w8 = torch.zeros(24, 16, dtype=torch.int8)
    kv, kv8 = torch.zeros(2, 2, 8, 8), torch.zeros(2, 2, 8, 8, dtype=torch.int8)
    mask = torch.ones(2, 8, dtype=torch.bool)
    k3 = dict(heads=2, head_dim=8, scale=0.3)
    malformed = {
        "side_w_scale": (lambda: fused_mlp(x, w, w.t(), side_x=x, side_w=w, side_w_scale=torch.ones(24)),
                         "side_w_scale goes with an int8 side_w"),
        "k3_side_x": (lambda: attn_block_decode(x, torch.ones(16), None, w[:16], w[:16].t(), kv, kv, mask, **k3,
                                                side_x=x), "side_x needs side_w"),
        "w_scale": (lambda: fused_dense(x, w8, w_scale=torch.ones(23)), "scale"),
        "norm": (lambda: fused_dense(x, w, ln_scale=torch.ones(16), ln_bias=torch.zeros(16), norm="rms"), "ln_bias"),
        "act": (lambda: fused_dense(x, w, act="swish"), "activation"),
        "w1_gate": (lambda: fused_mlp(x, w, w.t(), w1_gate=w8, w1_gate_scale=torch.ones(24)), "stored type"),
        "k_scale": (lambda: attn_block_decode(x, torch.ones(16), None, w[:16], w[:16].t(), kv8, kv8, mask, **k3),
                    "scale"),
        "wout_scale": (lambda: attend_out_decode(torch.zeros(2, 2, 8), kv, kv, mask, w8[:16], scale=0.3), "scale"),
        "k6_v_scale": (lambda: attend_out_decode(torch.zeros(2, 2, 8), kv8, kv8, mask, w[:16], scale=0.3,
                                                 v_scale=torch.ones(2, 2, 8)), "scale"),
        "layer_idx": (lambda: attend_out_decode(torch.zeros(2, 2, 8), kv, kv, mask, w[:16], scale=0.3,
                                                layer_idx=torch.zeros(1, dtype=torch.int32)), "per-layer layout"),
        "int4_odd_k": (lambda: fused_dense(torch.zeros(2, 15), torch.zeros(24, 7, dtype=torch.uint8),
                                           w_scale=torch.ones(24)), "int4"),
        "w1_gate_scale": (lambda: fused_mlp(x, w8, w8.t().contiguous(), w1_gate=w8, w1_scale=torch.ones(24),
                                            w2_scale=torch.ones(16)), "scale"),
        "float_w_scale": (lambda: fused_dense(x, w, w_scale=torch.ones(24)), "scale"),
        "side_x": (lambda: fused_mlp(x, w, w.t(), side_x=x), "side_w"),
    }
    fn, match = malformed[call]
    with pytest.raises(ValueError, match=match):
        fn()


def test_kernel_routing_follows_the_tensor_device():
    """CUDA tensors take the kernels (the meta device stands in for a
    non-CUDA accelerator and does not); `plain_path()` turns them off and
    restores the routing on exit, also after an error."""
    from open_flamingo_tpu_torch.ops import attention

    cpu = torch.empty(1)
    assert not attention.use_kernels(cpu)
    assert not attention.use_kernels(torch.empty(1, device="meta"))
    with pytest.raises(KeyError):
        with attention.plain_path():
            assert attention._PLAIN
            raise KeyError
    assert not attention._PLAIN


def test_build_names_every_source():
    from open_flamingo_tpu_torch.ops import build

    assert build.sources() == ["attention_backward", "decode_attention", "decode_layer", "dense_stream",
                               "fused_layer", "layer_norm", "prefill_attention", "vit_attention"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
