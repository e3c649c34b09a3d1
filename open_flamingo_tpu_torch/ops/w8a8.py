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
(cuBLASLt's int8 GEMM), which takes only more than 16 rows and a reduction
and output width that are multiples of 8. JAX's `dot_general` takes any
shape, so the operands are zero-padded up to those (`pad_for_int_mm`: M to
17, K and N to multiples of 8) and the result sliced back; zero rows and
columns add nothing to an integer sum, so the padding is exact. On the CPU
the plain version sums in float64, exactly (127^2 * K stays far below 2^53;
fp32 would not be exact: 127^2 * 4096 > 2^24).

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


# torch._int_mm's shape rule on the card: M > 16, K and N multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def pad_for_int_mm(a: torch.Tensor, b: torch.Tensor):
    """(M, K) and (N, K) operands zero-padded to the shape `torch._int_mm`
    takes: M up to INT_MM_MIN_ROWS, K and N up to multiples of
    INT_MM_MULTIPLE (the operands themselves when they already fit). The
    first M x N entries of the padded product are the unpadded product."""
    m, k = a.shape
    n = b.shape[0]
    up = lambda x: -(-x // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    m_p, k_p, n_p = max(m, INT_MM_MIN_ROWS), up(k), up(n)
    if (m_p, k_p) != (m, k):
        a = torch.nn.functional.pad(a, (0, k_p - k, 0, m_p - m))
    if (n_p, k_p) != (n, k):
        b = torch.nn.functional.pad(b, (0, k_p - k, 0, n_p - n))
    return a, b


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) fp32, the exact int32 sum cast
    once: `torch._int_mm` on the card (on operands padded by
    `pad_for_int_mm`), a float64 product on the CPU."""
    m, n = a.shape[0], b.shape[0]
    if a.device.type == "cpu":
        return (a.double() @ b.double().t()).float()
    if a.device.type != "cuda":
        raise ValueError(f"w8a8: unsupported device {a.device}")
    a_p, b_p = pad_for_int_mm(a, b)
    return torch._int_mm(a_p, b_p.t())[:m, :n].float()


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
