"""W8A8 prefill: int8 activations times int8 weights, the JAX package's
`ops/w8a8.py`.

Single-token decode streams weights, so quantized weights alone pay there
(K1-K3 stream them). Prefill and the ViT forward are large products, where
the lever is the int8 tensor-core rate itself (1,979 TOP/s on the H100
against 989 TFLOP/s in bf16): both operands int8. The weights come with
their static per-out-channel scales (`quantize.quantize_prefill_weights`),
the activations are quantized per row as they arrive: scale amax / 127 over
the reduction axis (1 for a zero row), round half to even of a true
division, clip to +-127.

    y = float(x_q @ w_q^T) * x_s * w_s  (+ bias), then one cast

The int32 product is exact, so the only error is the input rounding. The
dequantization keeps JAX's order: the int32 sum to fp32, times the row
scale, times the channel scale, plus the bias, one rounding to the output
dtype.

The int8 x int8 -> int32 product is the large product that the JAX package
leaves to XLA outside any Pallas kernel: on the card it is `torch._int_mm`
(cuBLASLt's int8 GEMM), which takes more than 16 rows and a reduction and
output width that are multiples of 8, and raises for any other shape. On the
CPU the plain version sums in float64, exactly (127^2 * K stays far below
2^53; fp32 would not be exact: 127^2 * 4096 > 2^24).

Gating, as in the JAX package: the module flag `ENABLED` (off by default)
and a shape gate, an (..., T, K) activation with at least `MIN_TOKENS`
rows, so decode (T = 1) keeps its own path bit for bit.
`models.layers.Dense` consults both when a module carries int8 weights.
"""

from __future__ import annotations

from typing import Optional

import torch

# set by the caller before a forward: W8A8 prefill and vision forward
ENABLED = False
# engage only on a product with at least this many rows (tokens)
MIN_TOKENS = 16


def use_w8a8(x: torch.Tensor) -> bool:
    """The shape gate for an (..., T, K) activation."""
    return ENABLED and x.dim() >= 3 and x.shape[-2] >= MIN_TOKENS


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8 over the last axis: (x_q int8, x_s fp32 with
    the last axis kept). A zero row gives zeros with scale 1."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    x_s = torch.where(amax == 0.0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))
    x_q = torch.clamp(torch.round(xf / x_s), -127, 127).to(torch.int8)
    return x_q, x_s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) fp32, the exact int32 sum cast
    once: `torch._int_mm` on the card, a float64 product on the CPU."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type == "cpu":
        return (a.double() @ b.double().t()).float()
    if a.device.type != "cuda":
        raise ValueError(f"w8a8: unsupported device {a.device}")
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"w8a8: the int8 product takes more than 16 rows and K, N multiples of 8; "
                         f"got ({m}, {k}) x ({k}, {n})")
    return torch._int_mm(a, b.t()).float()


def w8a8_dot(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor, bias: Optional[torch.Tensor] = None,
             out_dtype=None) -> torch.Tensor:
    """x (..., K) float; w_q (N, K) int8, torch's nn.Linear layout; w_s (N,)
    fp32; bias (N,). Returns (..., N) in out_dtype (x's by default)."""
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None and bias.requires_grad)):
        raise RuntimeError("w8a8_dot: the W8A8 product has no backward; call it under torch.no_grad()")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != x.shape[-1] or w_s.shape != w_q.shape[:1]:
        raise ValueError(f"w8a8_dot: w_q (N, {x.shape[-1]}) int8 with w_s (N,), got {w_q.dtype} "
                         f"{tuple(w_q.shape)} and {tuple(w_s.shape)}")
    x_q, x_s = quantize_activations(x)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
    y = y * x_s * w_s.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)
