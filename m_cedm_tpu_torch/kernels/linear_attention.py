"""K5 kv_dots and K6 apply_dots: the two products of the OFormer's Galerkin
linear attention, q (k^T v) / n, and their backward.

Port of m_cedm_tpu/pallas/linear_attention.py::_kv_kernel (via `_kv_pallas`)
and ::_apply_kernel (via `_apply_pallas`). CUDA source:
csrc/linear_attention.cu, whose header says what bounds them on an H100 and
how their design handles that.

  kv_dots(k, v)        (BH, N, D) x (BH, N, E) -> fp32 (BH, D, E) = sum_n k_n^T v_n
  apply_dots(q, dots)  (BH, N, D) x (BH, D, E) -> (BH, N, E) = q @ dots

The kernels take any N and any D, E up to 128, fp32, contiguous. Each wrapper
is a torch.autograd.Function whose backward is made of the two primitives, as
the JAX custom VJPs are:

  kv_dots:     dk = apply_dots(v, g^T),     dv = apply_dots(k, g)
  apply_dots:  dq = apply_dots(g, dots^T),  ddots = kv_dots(q, g)

so a train step launches no other kernel for its attention. On CPU tensors
forward and backward run the plain versions (the einsums of the JAX package's
`_kv_reference` and `_apply_reference`). `kv_dots.launches` and
`apply_dots.launches` count every launch of each kernel, forward or backward.
"""
from __future__ import annotations

import math

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (I, P, check, fp32_reference_math,
                                              on_cpu, ptr, raise_on_error,
                                              stream)

MAX_WIDTH = 128
_CHUNK = 64  # rows per shared-memory stage of the kv_dots kernel


def kv_dots_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_n k[:, n]^T v[:, n] in fp32 (_kv_reference)."""
    if k.is_cuda:
        fp32_reference_math()
    return torch.einsum("bnd,bne->bde", k.float(), v.float())


def apply_dots_plain(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    """q @ dots, the factor cast to q's type first (_apply_reference)."""
    if q.is_cuda:
        fp32_reference_math()
    return torch.einsum("bnd,bde->bne", q, dots.to(q.dtype))


def _check(a, a_name, b, b_name, b_shape):
    """a is (BH, N, D); b must have b_shape; both fp32, contiguous, aligned."""
    if a.dim() != 3:
        raise ValueError(f"{a_name} must be (BH, N, D), got shape {tuple(a.shape)}")
    check(a, a_name, a.shape, a.device)
    check(b, b_name, b_shape, a.device)
    widths = (a.shape[2], b_shape[-1])
    if not all(1 <= w <= MAX_WIDTH for w in widths):
        raise ValueError(f"linear-attention kernels take widths up to {MAX_WIDTH}, "
                         f"got {widths}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("linear-attention kernels need 16-byte aligned operands")


def _splits(bh: int, n: int, device) -> int:
    """Blocks per head-batch for kv_dots: about one per SM in all (a block
    takes an SM's shared memory), and at least 128 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms // bh, math.ceil(n / 128)))


def _kv_dots_kernel(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    bh, n, d = k.shape
    e = v.shape[2]
    _check(k, "k", v, "v", (bh, n, e))
    out = k.new_empty(bh, d, e)
    splits = _splits(bh, n, k.device)
    rows = math.ceil(math.ceil(n / splits) / _CHUNK) * _CHUNK
    part = k.new_empty(bh, splits, d, e) if splits > 1 else None
    fn = _build.bind("linear_attention", "mc_kv_dots", [P] * 4 + [I] * 6 + [P])
    raise_on_error(fn(ptr(k), ptr(v), ptr(out), ptr(part), bh, n, d, e, splits,
                      rows, stream()), "mc_kv_dots")
    kv_dots.launches += 1
    return out


def _apply_dots_kernel(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    bh, n, d = q.shape
    e = dots.shape[2]
    _check(q, "q", dots, "dots", (bh, d, e))
    out = q.new_empty(bh, n, e)
    fn = _build.bind("linear_attention", "mc_apply_dots", [P] * 3 + [I] * 4 + [P])
    raise_on_error(fn(ptr(q), ptr(dots), ptr(out), bh, n, d, e, stream()),
                   "mc_apply_dots")
    apply_dots.launches += 1
    return out


def _kv(k, v):
    return kv_dots_plain(k, v) if on_cpu(k) else _kv_dots_kernel(k, v)


def _apply(q, dots):
    return apply_dots_plain(q, dots) if on_cpu(q) else _apply_dots_kernel(q, dots)


class _KvDots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v):
        ctx.save_for_backward(k, v)
        return _kv(k, v)

    @staticmethod
    def backward(ctx, g):
        k, v = ctx.saved_tensors
        need_k, need_v = ctx.needs_input_grad
        dk = _apply(v, g.transpose(1, 2).contiguous()) if need_k else None
        dv = _apply(k, g.contiguous()) if need_v else None
        return dk, dv


class _ApplyDots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, dots):
        ctx.save_for_backward(q, dots)
        return _apply(q, dots)

    @staticmethod
    def backward(ctx, g):
        q, dots = ctx.saved_tensors
        need_q, need_dots = ctx.needs_input_grad
        g = g.contiguous()
        dq = _apply(g, dots.transpose(1, 2).contiguous()) if need_q else None
        ddots = _kv(q, g) if need_dots else None
        return dq, ddots


def kv_dots(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5: fp32 (BH, D, E) = sum_n k[:, n]^T v[:, n]."""
    return _KvDots.apply(k, v)


def apply_dots(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    """K6: (BH, N, E) = q @ dots, the (D, E) factor resident per block."""
    return _ApplyDots.apply(q, dots)


kv_dots.launches = 0
apply_dots.launches = 0
