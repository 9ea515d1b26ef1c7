"""K4: fp32 softmax attention forward, softmax(q k^T / sqrt(D)) v.

Port of m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel (via
`_pallas_fwd`). CUDA source: csrc/fused_attention.cu, whose header says what
bounds it on an H100 and how its design handles that. q, k, v are (N, L, D)
with N = batch * heads; the kernel takes D = 64, the ADM U-Net's head width.

`attention` runs the CUDA kernel for CUDA tensors and the plain PyTorch
version for CPU tensors, and counts kernel launches in `.launches`.
"""
from __future__ import annotations

import math

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check, forward_only,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)

HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in fp32 (attention_reference)."""
    if q.is_cuda:
        fp32_reference_math()
    scale = 1.0 / math.sqrt(k.shape[-1])
    logits = torch.einsum("nqd,nkd->nqk", q, k * scale)
    return torch.einsum("nqk,nkd->nqd", torch.softmax(logits, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4: fused fp32 attention; never forms the (L, L) matrix on the card."""
    if on_cpu(q):
        return attention_plain(q, k, v)
    n, l, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(t, name, (n, l, d), q.device)
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel takes head width {HEAD_DIM}, got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention kernel needs 16-byte aligned q, k, v")
    forward_only(q, k, v)
    out = torch.empty_like(q)
    fn = _build.bind("fused_attention", "mc_attention_fwd", [P, P, P, P, I, I, I, F, P])
    raise_on_error(fn(ptr(q), ptr(k), ptr(v), ptr(out), n, l, d,
                      1.0 / math.sqrt(d), stream()), "mc_attention_fwd")
    attention.launches += 1
    return out


attention.launches = 0
