"""K4: causal streaming-softmax attention (prefill and training), and K4b,
its backward.

Replaces `open_flamingo_tpu/ops/flash_attention.py` `flash_attention`:
the forward `_attention_kernel` via `_flash_forward` (with `with_lse`) and
the backward `_flash_dq_kernel` / `_flash_dkv_kernel` via
`_flash_backward`. The CUDA kernels are `csrc/prefill_attention.cu`
`flash_attention_fwd` (an online softmax over staged key tiles; causal
against `q_offset + i`, key pad mask, in-kernel ALiBi, exact zeros for rows
with no valid key, and the per-row logsumexp when asked; bf16 on tensor
cores, FlashAttention-2's forward on `mma.sync` with P.V in fp32 through a
hi/lo bf16 pair, fp32 on CUDA-core FMA) and `csrc/attention_backward.cu`
`flash_attention_bwd_dq` / `_dkv` (FlashAttention-2's split: dq over key
tiles, dk/dv over query tiles, P recomputed from the logsumexp; delta =
rowsum(dO * O) fused into the dq launch; bf16 on tensor cores, `mma.sync`
with dS and P in fp32 through hi/lo bf16 pairs, each walking only the keys
or queries the mask lets through; fp32 on CUDA-core FMA). At the path's
shapes they are bound by bytes on the card (see the sources' notes).
`flash_attention_fma` and `flash_attention_backward_fma` launch the
CUDA-core bodies in either dtype, the kernels the bf16 tensor-core bodies
replaced, as yardsticks for the card's timings; the port never calls them.

`flash_attention` is the entry point. When autograd needs its result
(grad mode on and q, k or v requiring grad) it goes through
`FlashAttentionFn`, which saves the logsumexp and runs the backward;
gradients flow to q, k and v only (pad mask, slopes and q_offset are not
differentiated, as in the JAX package's custom_vjp). CUDA tensors launch
the kernels; CPU tensors run the plain PyTorch versions
`reference_attention` and `reference_attention_backward` (explicit
FlashAttention-2 formulas, not autograd), also inside the Function.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("prefill_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("flash_attention_fwd", "flash_attention_fwd_fma"):
            getattr(lib, fn).argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


def _bwd_kernel():
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.library("attention_backward")
        p, i = ctypes.c_void_p, ctypes.c_int
        for body in ("", "_fma"):
            for part in ("dq", "dkv"):
                fa, mx = getattr(lib, f"flash_attention_bwd_{part}{body}"), getattr(lib, f"masked_xattn_bwd_{part}{body}")
                fa.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
                mx.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, p]
                fa.restype = mx.restype = i
        _bwd_lib = lib
    return _bwd_lib


def _scores(q, k, pad_mask, slopes, q_offset, causal, scale):
    """fp32 logits (BH, Tq, S) with ALiBi, and the boolean mask."""
    tq, s = q.shape[1], k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    k_pos = torch.arange(s, device=q.device)[None, None, :]
    logits = logits + slopes.float()[:, :, None] * (k_pos - (s - 1)).float()
    mask = (pad_mask != 0)[:, None, :]
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)[None, :, None]
        mask = mask & (k_pos <= q_pos)
    return logits, mask


def masked_softmax_v(logits, mask, v, dtype, with_lse):
    """Softmax of `logits` under `mask` times v, with exact zeros for rows
    with no valid key; with_lse also returns the per-row logsumexp (0 for
    those rows)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True).detach()
    m = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p / torch.where(denom == 0.0, 1.0, denom), v.float()).to(dtype)
    if not with_lse:
        return out
    lse = torch.where(denom > 0.0, m + torch.log(denom), 0.0)[..., 0]
    return out, lse


def masked_softmax_v_backward(q, k, v, logits, mask, out, lse, dout, scale):
    """FlashAttention-2's backward from the forward's logsumexp, in torch ops:
    P = exp(s - lse) under the mask, dS = P * (dO V^T - rowsum(dO * O)),
    dq = scale dS K, dk = scale dS^T q, dv = P^T dO."""
    p = torch.exp(logits - lse.float()[..., None]).masked_fill(~mask, 0.0)
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, v.float()) - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, pad_mask, slopes, q_offset, causal=True, scale=1.0, with_lse=False):
    """Plain version, same semantics as the kernel. Shapes as flash_attention;
    with_lse also returns the logsumexp (BH, Tq) fp32."""
    logits, mask = _scores(q, k, pad_mask, slopes, q_offset, causal, scale)
    return masked_softmax_v(logits, mask, v, q.dtype, with_lse)


def reference_attention_backward(q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal=True, scale=1.0):
    """Plain version of K4b: (dq, dk, dv) from the forward's out and lse."""
    logits, mask = _scores(q, k, pad_mask, slopes, q_offset, causal, scale)
    return masked_softmax_v_backward(q, k, v, logits, mask, out, lse, dout, scale)


def check_qkv(q, k, v, name):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share dtype float32 or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if q.shape[-1] > 128:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > 128")


def _check_shapes(q, k, v, pad_mask, slopes):
    bh, tq, d = q.shape
    s = k.shape[1]
    if k.shape != (bh, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad k/v shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if pad_mask.shape != (bh, s) or slopes.shape != (bh, 1):
        raise ValueError("flash_attention: pad_mask must be (BH, S) and slopes (BH, 1)")


def _cuda_operands(q, k, v, pad_mask, slopes, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_qkv(q, k, v, name)
    if pad_mask.device != q.device or slopes.device != q.device:
        raise ValueError(f"{name}: pad_mask/slopes on another device")
    # the kernels read a byte per key, nonzero = valid: a bool or uint8 mask as it is
    if pad_mask.dtype == torch.bool:
        pad = pad_mask.view(torch.uint8)
    else:
        pad = pad_mask if pad_mask.dtype == torch.uint8 else (pad_mask != 0).to(torch.uint8)
    return pad.contiguous(), slopes.to(torch.float32).contiguous()


def _launch_forward(entry, q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse):
    pad, slopes = _cuda_operands(q, k, v, pad_mask, slopes, "flash_attention")
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, tq, dtype=torch.float32, device=q.device) if with_lse else None
    status = getattr(_kernel(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), slopes.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, tq, k.shape[1], d, int(q_offset), int(causal),
        float(scale), _DTYPES[q.dtype], build.current_stream(q.device),
    )
    build.check(status, entry)
    return (out, lse) if with_lse else out


def flash_attention_forward(q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse):
    """The forward on q's device: the kernel for CUDA, the plain version for
    the CPU."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse)
    result = _launch_forward("flash_attention_fwd", q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse)
    flash_attention.launches += 1
    return result


def flash_attention_fma(q, k, v, pad_mask, slopes, q_offset, causal=True, scale=1.0, with_lse=False):
    """The forward's CUDA-core FMA body on CUDA tensors, in fp32 or bf16:
    the yardstick the bf16 tensor-core body replaced. Counts no launch."""
    _check_shapes(q, k, v, pad_mask, slopes)
    return _launch_forward("flash_attention_fwd_fma", q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse)


def _launch_backward(body, q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal, scale):
    """`flash_attention_bwd_dq{body}` then `_dkv{body}` on CUDA tensors."""
    name = "flash_attention_backward" + body
    pad, slopes = _cuda_operands(q, k, v, pad_mask, slopes, name)
    check_grad_operands(q, out, lse, dout, name)
    bh, tq, d = q.shape
    delta = torch.empty(bh, tq, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_kernel()
    common = (bh, tq, k.shape[1], d, int(q_offset), int(causal), float(scale), _DTYPES[q.dtype],
              build.current_stream(q.device))
    build.check(getattr(lib, f"flash_attention_bwd_dq{body}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), slopes.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common), f"flash_attention_bwd_dq{body}")
    build.check(getattr(lib, f"flash_attention_bwd_dkv{body}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(), slopes.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common), f"flash_attention_bwd_dkv{body}")
    return dq, dk, dv


def flash_attention_backward(q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal=True, scale=1.0):
    """K4b: (dq, dk, dv) from the forward's out and lse (BH, Tq) fp32, for
    dout (BH, Tq, D). One call is two launches, dq (which also writes
    delta) then dkv."""
    if q.device.type == "cpu":
        return reference_attention_backward(q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal, scale)
    grads = _launch_backward("", q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal, scale)
    flash_attention_backward.launches += 1
    return grads


def flash_attention_backward_fma(q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal=True, scale=1.0):
    """K4b's CUDA-core FMA body on CUDA tensors, in fp32 or bf16: the
    yardstick the bf16 tensor-core body replaced. Counts no launch."""
    return _launch_backward("_fma", q, k, v, pad_mask, slopes, q_offset, out, lse, dout, causal, scale)


def check_grad_operands(q, out, lse, dout, name):
    """The backward's extra operands: out and dout like q, lse (BH, Tq) fp32,
    all contiguous on q's device."""
    bh, tq = q.shape[:2]
    for t_name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous and match q's shape, dtype and device")
    if lse.shape != (bh, tq) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous (BH, Tq) float32 tensor on q's device")


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention under autograd: the forward keeps its logsumexp, the
    backward is K4b (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, slopes, q_offset, causal, scale):
        out, lse = flash_attention_forward(q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, pad_mask, slopes, out, lse)
        ctx.attrs = (q_offset, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, slopes, out, lse = ctx.saved_tensors
        q_offset, causal, scale = ctx.attrs
        dq, dk, dv = flash_attention_backward(
            q, k, v, pad_mask, slopes, q_offset, out, lse, dout.contiguous(), causal, scale)
        return dq, dk, dv, None, None, None, None, None


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, pad_mask, slopes, q_offset: int, causal: bool = True, scale: float = 1.0):
    """q: (BH, Tq, D); k/v: (BH, S, D); pad_mask: (BH, S) bool or int,
    nonzero = valid; slopes: (BH, 1) fp32 (0 disables ALiBi); q_offset:
    position of the first query in the key axis. Returns (BH, Tq, D),
    differentiable in q, k and v."""
    _check_shapes(q, k, v, pad_mask, slopes)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, pad_mask, slopes, q_offset, causal, scale)
    return flash_attention_forward(q, k, v, pad_mask, slopes, q_offset, causal, scale, with_lse=False)


flash_attention.launches = 0
flash_attention_backward.launches = 0
