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
bf16); `attention_plain` of bf16 operands is that function. The backward has
a bf16 instance too (`_bwd_kernel` on bf16 operands: upcast, every product
and the softmax in fp32, dq, dk and dv rounded once to bf16;
`attention_bwd_plain` of bf16 operands). Its row term delta = rowsum(g * o)
must be JAX's sum(dw * w), the cotangent against the fp32 output: so a
forward that needs gradients also writes its output in fp32 (`o32`, 4 MB a
call at the flagship's shape), and the backward reads that one, not the
rounded bf16 output: sum_k (g v^T)_ik w_ik = g_i . (w v)_i.

The bf16 kernels run every product on wgmma with bf16 operands: q k^T and
g v^T as they are (exact products), and each product with an fp32 operand
(P V, P^T g, dS k, dS^T q) as three bf16 products, P or dS split in three
bf16 pieces that sum back to it exactly (`split_bf16x3`, the kernels'
`split3`; tests/test_torch_bf16_split.py emulates their order on the CPU).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, act_dtype, check,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)

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
    dk = dl^T q / sqrt(D). bf16 operands are upcast and dq, dk, dv rounded
    once to bf16, as _bwd_kernel does."""
    if q.dtype == torch.bfloat16:
        grads = attention_bwd_plain(g.float(), q.float(), k.float(), v.float())
        return tuple(t.to(q.dtype) for t in grads)
    if q.is_cuda:
        fp32_reference_math()
    scale = 1.0 / math.sqrt(k.shape[-1])
    w = torch.softmax(torch.einsum("nqd,nkd->nqk", q, k * scale), dim=-1)
    dv = torch.einsum("nqk,nqd->nkd", w, g)
    dw = torch.einsum("nqd,nkd->nqk", g, v)
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("nqk,nkd->nqd", dl, k) * scale
    dk = torch.einsum("nqk,nqd->nkd", dl, q) * scale
    return dq, dk, dv


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 kernels' split of an fp32 P or dS: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest (ties to
    even, as cvt.rn.bf16x2.f32). A rounding leaves at most half an ulp of the
    piece before, which fits in the 8 bits of the next, and bf16 has fp32's
    exponent range: hi + mid + lo == x in fp32, exactly."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


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


def attention_fwd(q, k, v, lse: Optional[torch.Tensor] = None,
                  o32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 forward kernel on the card; when `lse` (N, L) is given it receives
    each row's log-sum-exp of the scaled logits, which the backward needs.
    bf16 operands: `o32` (N, L, D) fp32, when given, receives the output
    before its rounding (the bf16 backward's delta)."""
    n, l, d = _check_qkv(q, k, v)
    if lse is not None:
        check(lse, "lse", (n, l), q.device)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        if o32 is not None:
            check(o32, "o32", (n, l, d), q.device)
        fn = _build.bind("fused_attention", "mc_attention_fwd_bf16",
                         [P, P, P, P, P, P, I, I, I, F, P])
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(o32), ptr(lse), n, l, d,
                1.0 / math.sqrt(d), stream())
        raise_on_error(rc, "mc_attention_fwd_bf16")
    else:
        fn = _build.bind("fused_attention", "mc_attention_fwd",
                         [P, P, P, P, P, I, I, I, F, P])
        raise_on_error(fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), n, l, d,
                          1.0 / math.sqrt(d), stream()), "mc_attention_fwd")
    attention.launches += 1
    return out


def attention_bwd(g, q, k, v, o, lse) -> Tuple[torch.Tensor, ...]:
    """K4 backward kernels on the card: (dq, dk, dv) from the output
    cotangent g, the operands, and the forward's output o and per-row
    log-sum-exp lse (N, L). bf16 g, q, k, v take the bf16 instance, with o
    the forward's fp32 output (`o32`); dq, dk, dv are then bf16."""
    n, l, d = _check_qkv(g, q, k, v)
    check(o, "o", (n, l, d), q.device)
    check(lse, "lse", (n, l), q.device)
    if o.data_ptr() % 16:
        raise ValueError("attention kernels need 16-byte aligned operands")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    name = "mc_attention_bwd" + ("_bf16" if q.dtype == torch.bfloat16 else "")
    fn = _build.bind("fused_attention", name, [P] * 10 + [I, I, I, F, P])
    raise_on_error(fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(g), ptr(lse),
                      ptr(delta), ptr(dq), ptr(dk), ptr(dv), n, l, d,
                      1.0 / math.sqrt(d), stream()), name)
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if on_cpu(q):
            out, lse, o_saved = attention_plain(q, k, v), None, None
        else:
            grad = any(ctx.needs_input_grad)
            lse = q.new_empty(q.shape[:2], dtype=torch.float32) if grad else None
            # bf16: the backward's delta comes from the unrounded output
            o32 = (torch.empty(q.shape, device=q.device, dtype=torch.float32)
                   if grad and q.dtype == torch.bfloat16 else None)
            out = attention_fwd(q, k, v, lse, o32)
            o_saved = out if o32 is None else o32
        ctx.save_for_backward(q, k, v, o_saved, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if on_cpu(g):
            return attention_bwd_plain(g, q, k, v)
        return attention_bwd(g, q, k, v, out, lse)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: fused fp32 attention; never forms the (L, L) matrix on the card."""
    return _Attention.apply(q, k, v)


attention.launches = 0
