"""K5 kv_dots and K6 apply_dots: the two products of the OFormer's Galerkin
linear attention, q (k^T v) / n, and their backward.

Port of m_cedm_tpu/pallas/linear_attention.py::_kv_kernel (via `_kv_pallas`)
and ::_apply_kernel (via `_apply_pallas`). CUDA source:
csrc/linear_attention.cu, whose header says what bounds them on an H100 and
how their design handles that.

  kv_dots(k, v)        (BH, N, D) x (BH, N, E) -> fp32 (BH, D, E) = sum_n k_n^T v_n
  apply_dots(q, dots)  (BH, N, D) x (BH, D, E) -> (BH, N, E) = q @ dots

The kernels take any N and any D, E up to 128, contiguous, 16-byte aligned,
in two instances:

  fp32   k, v, q and the factor fp32; out fp32 (3xTF32 products)
  bf16   kv_dots: bf16 k, v into an fp32 out; apply_dots: bf16 q, an fp32 or
         bf16 factor rounded to bf16 as it is loaded, out rounded once to
         bf16 from fp32 sums (bf16 products, as `_apply_kernel` runs on
         bf16 operands)

The bf16 instance takes one of two routes, by shape alone (`tma_route`):
where D and E are multiples of 8 (rows of whole 16-byte units, which TMA
describes), the kernels on TMA and wgmma: `mc_kv_dots_bf16_tma`, one
thread-block cluster of `kv_cluster` blocks a head-batch (from the shape and
the clusters the card holds at once) whose partials are summed in rank
order over distributed shared memory, one launch and no workspace, and
`mc_apply_dots_bf16_tma`, persistent blocks over all SMs. Other widths take
the bf16 mma.sync kernels: `mc_kv_dots_bf16`, which splits N by `_splits`
into a workspace and a second launch, and `mc_apply_dots_bf16`. Either
counts as one launch a call.

Any other mix of dtypes raises. Each wrapper is a torch.autograd.Function
whose backward is made of the two primitives, with the dtypes of the JAX
custom VJPs:

  kv_dots:     dk = apply_dots(v, g^T),     dv = apply_dots(k, g)
  apply_dots:  dq = apply_dots(g, dots^T),  ddots = kv_dots(q, g)

(in bf16: g fp32 and dk, dv bf16 for kv_dots; g bf16, dq bf16 and ddots
fp32 for apply_dots), so a train step launches no other kernel for its
attention. On CPU tensors forward and backward run the plain versions (the
einsums of the JAX package's `_kv_reference` and `_apply_reference`).
`kv_dots.launches` and `apply_dots.launches` count every launch of the fp32
kernels, forward or backward; `kv_dots.launches_bf16` and
`apply_dots.launches_bf16` those of the bf16 instances.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (ACT_DTYPES, I, P, act_dtype, check,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)

MAX_WIDTH = 128
_CHUNK = 64  # rows per shared-memory stage of the kv_dots kernel
# the bf16 kv_dots on TMA (csrc/linear_attention.cu's kKvTmaCluster,
# kKvTmaMinRows, kKvTmaRows): blocks a head-batch at most (the portable
# cluster size), tokens a block at least, tokens a stage
KV_CLUSTER_MAX = 8
KV_MIN_ROWS = 256
KV_STAGE_ROWS = 64


def kv_dots_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_n k[:, n]^T v[:, n] in fp32 (_kv_reference): bf16 operands are
    upcast exactly, so their products and sums are fp32's."""
    if k.is_cuda:
        fp32_reference_math()
    return torch.einsum("bnd,bne->bde", k.float(), v.float())


def apply_dots_plain(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    """q @ dots, the factor cast to q's type first (_apply_reference): the
    product of the fp32 upcasts, rounded once to q's type (bf16), as
    `_apply_kernel` accumulates in fp32: no bf16 matmul whose rounding
    would follow cuBLAS's reduced-precision-reduction switch."""
    if q.is_cuda:
        fp32_reference_math()
    return torch.bmm(q.float(), dots.to(q.dtype).float()).to(q.dtype)


def _check(a, a_name, b, b_name, b_shape, b_dtypes=None):
    """a is (BH, N, D), fp32 or bf16; b must have b_shape and a's dtype, or
    one of `b_dtypes`; both contiguous and 16-byte aligned."""
    if a.dim() != 3:
        raise ValueError(f"{a_name} must be (BH, N, D), got shape {tuple(a.shape)}")
    dtype = act_dtype(a)
    check(a, a_name, a.shape, a.device, dtype)
    b_dtype = b.dtype if b_dtypes and b.dtype in b_dtypes else dtype
    check(b, b_name, b_shape, a.device, b_dtype)
    widths = (a.shape[2], b_shape[-1])
    if not all(1 <= w <= MAX_WIDTH for w in widths):
        raise ValueError(f"linear-attention kernels take widths up to {MAX_WIDTH}, "
                         f"got {widths}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("linear-attention kernels need 16-byte aligned operands")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(bh: int, n: int, device) -> int:
    """Blocks per head-batch for the fp32 kv_dots and the bf16 one on
    mma.sync: about one per SM in all (a block takes an SM's shared
    memory), and at least 128 rows each."""
    return max(1, min(_sm_count(device.index) // bh, math.ceil(n / 128)))


def tma_route(d: int, e: int) -> bool:
    """The bf16 kernels' route, by shape alone: TMA describes rows of whole
    16-byte units, widths that are multiples of 8 (`_check` holds every
    base 16-byte aligned). Other widths take the bf16 mma.sync kernels."""
    return d % 8 == 0 and e % 8 == 0


def kv_cluster(bh: int, n: int, active) -> int:
    """Blocks a head-batch of the bf16 kv_dots on TMA, one cluster: the
    largest power of two up to KV_CLUSTER_MAX whose bh clusters the card
    holds at once (`active[c - 1]` clusters of c blocks, as
    cudaOccupancyMaxActiveClusters reports them: one block an SM, so the
    grid runs in one wave) with KV_MIN_ROWS tokens a block, or 1. On an
    H100 (15 clusters of 8, 30 of 4, 66 of 2): 4 at BH 16, 2 at BH 64."""
    c = KV_CLUSTER_MAX
    while c > 1 and (bh > active[c - 1] or c * KV_MIN_ROWS > n):
        c //= 2
    return c


@functools.lru_cache(maxsize=None)
def _active_clusters(index: int) -> tuple:
    """Clusters of 1 .. KV_CLUSTER_MAX blocks of the bf16 kv_dots on TMA
    that card `index` holds at once."""
    fn = _build.bind("linear_attention", "mc_kv_dots_bf16_tma_clusters", [I, P])
    got, out = ctypes.c_int(0), []
    with torch.cuda.device(index):
        for c in range(1, KV_CLUSTER_MAX + 1):
            raise_on_error(fn(c, ctypes.addressof(got)), "mc_kv_dots_bf16_tma_clusters")
            out.append(got.value)
    return tuple(out)


def kv_cluster_rows(n: int, ranks: int) -> int:
    """Tokens a cluster rank takes (the kernel's kv_tma_rows): whole stages,
    ranks * rows >= n; rank r sums tokens r * rows .. min(n, (r + 1) rows)."""
    return math.ceil(math.ceil(n / ranks) / KV_STAGE_ROWS) * KV_STAGE_ROWS


def _kv_dots_kernel(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5's fp32 or bf16 instance, by k's dtype; v of the same, out fp32."""
    bh, n, d = k.shape
    e = v.shape[2]
    _check(k, "k", v, "v", (bh, n, e))
    out = k.new_empty(bh, d, e, dtype=torch.float32)
    if k.dtype == torch.bfloat16 and tma_route(d, e):
        fn = _build.bind("linear_attention", "mc_kv_dots_bf16_tma", [P] * 3 + [I] * 5 + [P])
        raise_on_error(fn(ptr(k), ptr(v), ptr(out), bh, n, d, e,
                          kv_cluster(bh, n, _active_clusters(k.device.index)), stream()),
                       "mc_kv_dots_bf16_tma")
        kv_dots.launches_bf16 += 1
        return out
    splits = _splits(bh, n, k.device)
    rows = math.ceil(math.ceil(n / splits) / _CHUNK) * _CHUNK
    part = out.new_empty(bh, splits, d, e) if splits > 1 else None
    bf16 = k.dtype == torch.bfloat16
    name = "mc_kv_dots_bf16" if bf16 else "mc_kv_dots"
    fn = _build.bind("linear_attention", name, [P] * 4 + [I] * 6 + [P])
    raise_on_error(fn(ptr(k), ptr(v), ptr(out), ptr(part), bh, n, d, e, splits,
                      rows, stream()), name)
    if bf16:
        kv_dots.launches_bf16 += 1
    else:
        kv_dots.launches += 1
    return out


def _apply_dots_kernel(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    """K6's fp32 instance (q, dots, out fp32) or its bf16 one (q bf16, dots
    fp32 or bf16, out bf16), by q's dtype."""
    bh, n, d = q.shape
    e = dots.shape[2]
    bf16 = q.dtype == torch.bfloat16
    _check(q, "q", dots, "dots", (bh, d, e), ACT_DTYPES if bf16 else None)
    out = q.new_empty(bh, n, e)
    if bf16:
        name = "mc_apply_dots_bf16_tma" if tma_route(d, e) else "mc_apply_dots_bf16"
        fn = _build.bind("linear_attention", name, [P, P, I, P] + [I] * 4 + [P])
        rc = fn(ptr(q), ptr(dots), int(dots.dtype == torch.bfloat16), ptr(out), bh, n,
                d, e, stream())
        raise_on_error(rc, name)
        apply_dots.launches_bf16 += 1
        return out
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
        ddots = _kv(q, g).to(dots.dtype) if need_dots else None
        return dq, ddots


def kv_dots(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5: fp32 (BH, D, E) = sum_n k[:, n]^T v[:, n]."""
    return _KvDots.apply(k, v)


def apply_dots(q: torch.Tensor, dots: torch.Tensor) -> torch.Tensor:
    """K6: (BH, N, E) = q @ dots, the (D, E) factor resident per block."""
    return _ApplyDots.apply(q, dots)


kv_dots.launches = 0
apply_dots.launches = 0
kv_dots.launches_bf16 = 0
apply_dots.launches_bf16 = 0
