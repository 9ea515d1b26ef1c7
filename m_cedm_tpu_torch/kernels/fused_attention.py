"""K4: fp32 softmax attention, softmax(q k^T / sqrt(D)) v, and its backward.

Port of m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel (via `_pallas_fwd`)
and ::_bwd_kernel (via `_pallas_bwd`). CUDA source: csrc/fused_attention.cu,
whose header says what bounds it on an H100 and how its design handles that:
flash-attention tiling on the tensor cores, every product a 3xTF32
mma.sync (each fp32 operand split into two TF32 parts, three TF32 products
summed in fp32, which keeps fp32 accuracy), keys and values (or queries and
cotangents) streamed through shared memory by cp.async. q, k, v are
(N, L, D) with N = batch * heads and any L >= 1; the kernels take D = 64, the
ADM U-Net's head width.

`attention` is a torch.autograd.Function: the CUDA kernels for CUDA tensors,
the plain PyTorch versions for CPU tensors. `attention.launches` counts
forward kernel launches, `attention_bwd.launches` backward ones.

bf16 q, k, v go to the bf16 forward kernel (`_fwd_kernel` on bf16 operands:
upcast, both products and the softmax in fp32, the output rounded once to
bf16); `attention_plain` of bf16 operands is that function. Its backward is
not ported yet (ROADMAP.md) and raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, act_dtype, check,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)
from m_cedm_tpu_torch.kernels.fused_norm import bf16_backward_not_ported

HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32 (attention_reference); bf16
    operands are upcast and the result rounded once to bf16, as _fwd_kernel
    does."""
    if q.dtype == torch.bfloat16:
        return attention_plain(q.float(), k.float(), v.float()).to(q.dtype)
    if q.is_cuda:
        fp32_reference_math()
    scale = 1.0 / math.sqrt(k.shape[-1])
    logits = torch.einsum("nqd,nkd->nqk", q, k * scale)
    return torch.einsum("nqk,nkd->nqd", torch.softmax(logits, dim=-1), v)


def attention_bwd_plain(g, q, k, v) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's formulas (_bwd_kernel): recompute w, then
    dv = w^T g, dl = w * (g v^T - rowsum(g v^T * w)), dq = dl k / sqrt(D),
    dk = dl^T q / sqrt(D)."""
    scale = 1.0 / math.sqrt(k.shape[-1])
    w = torch.softmax(torch.einsum("nqd,nkd->nqk", q, k * scale), dim=-1)
    dv = torch.einsum("nqk,nqd->nkd", w, g)
    dw = torch.einsum("nqd,nkd->nqk", g, v)
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("nqk,nkd->nqd", dl, k) * scale
    dk = torch.einsum("nqk,nqd->nkd", dl, q) * scale
    return dq, dk, dv


def _check_qkv(*tensors):
    n, l, d = tensors[0].shape
    dt = act_dtype(tensors[0])
    for i, t in enumerate(tensors):
        check(t, f"attention operand {i}", (n, l, d), tensors[0].device, dt)
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel takes head width {HEAD_DIM}, got {d}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention kernels need 16-byte aligned operands")
    return n, l, d


def attention_fwd(q, k, v, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 forward kernel on the card; when `lse` (N, L) is given it receives
    each row's log-sum-exp of the scaled logits, which the backward needs."""
    n, l, d = _check_qkv(q, k, v)
    if lse is not None:
        check(lse, "lse", (n, l), q.device)
    out = torch.empty_like(q)
    name = "mc_attention_fwd" + ("_bf16" if q.dtype == torch.bfloat16 else "")
    fn = _build.bind("fused_attention", name, [P, P, P, P, P, I, I, I, F, P])
    raise_on_error(fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), n, l, d,
                      1.0 / math.sqrt(d), stream()), name)
    attention.launches += 1
    return out


def attention_bwd(g, q, k, v, o, lse) -> Tuple[torch.Tensor, ...]:
    """K4 backward kernels on the card: (dq, dk, dv) from the output
    cotangent g, the operands, and the forward's output o and per-row
    log-sum-exp lse (N, L)."""
    n, l, d = _check_qkv(g, q, k, v, o)
    check(lse, "lse", (n, l), q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    fn = _build.bind("fused_attention", "mc_attention_bwd",
                     [P] * 10 + [I, I, I, F, P])
    raise_on_error(fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(g), ptr(lse),
                      ptr(delta), ptr(dq), ptr(dk), ptr(dv), n, l, d,
                      1.0 / math.sqrt(d), stream()), "mc_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if on_cpu(q):
            out, lse = attention_plain(q, k, v), None
        else:
            lse = q.new_empty(q.shape[:2]) if any(ctx.needs_input_grad) else None
            out = attention_fwd(q, k, v, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.dtype == torch.bfloat16:
            raise bf16_backward_not_ported("K4")
        g = g.contiguous()
        if on_cpu(g):
            return attention_bwd_plain(g, q, k, v)
        return attention_bwd(g, q, k, v, out, lse)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: fused fp32 attention; never forms the (L, L) matrix on the card."""
    return _Attention.apply(q, k, v)


attention.launches = 0
