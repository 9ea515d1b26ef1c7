"""K2 and K3: GroupNorm (+FiLM) + SiLU + conv3x3 with the residual-block tail.

Port of m_cedm_tpu/pallas/fused_norm_conv.py, unpaired math only:

  K2 `gn_silu_conv`     <- `_gnsc_kernel` (via `_pallas_gnsc`, and the paired
                           `_pallas_gnsc_paired` / `fused_block_paired`)
       conv3x3_same(silu(gn(x) * gamma + beta)) + bias
         [+ residual]                         identity skip
         [+ upsample2x_nearest(residual)]     identity_up (res_up=True)
         [+ residual @ skip_w + skip_b]       1x1 projection skip
       gamma=None selects the linear mode (act=False): a plain conv3x3.
  K3 `gn_silu_up_conv`  <- `_gnsc_up_kernel` (and the paired
                           `_gnsc_up_pair_kernel`, which also emits stats)
       conv3x3_same(upsample2x_nearest(silu(gn(x) * gamma + beta))) + bias

Both can take chained input statistics (`stats`, per-(B, C) sums of x) and
emit the output's per-(B, O) sums (`emit_stats`). CUDA source:
csrc/fused_norm_conv.cu, whose header says what bounds it on an H100 and how
its design handles that. Layouts are NHWC; conv weights are HWIO (3, 3, C, O),
the 1x1 skip weight (C_res, O).

Backward, in every mode: `gn_silu_conv_bwd` <- `_gnsc_bwd_kernel_a` (via
`_pallas_gnsc_bwd`, `_block_bwd`, and the paired `_pallas_gnsc_bwd_paired`,
`_blockp_bwd`) then `_dx_from_da`; `gn_silu_up_conv_bwd` <-
`_up_pair_bwd_kernel` (via `_pallas_up_pair_bwd`). CUDA source:
csrc/fused_norm_conv_bwd.cu: a dgrad and a wgrad kernel, both in 3xTF32 on
the tensor cores like the forward, whose per-block partials of dW, dbias,
dgamma and dbeta are added in a fixed order (the backward repeats bit for
bit). The backward uses
the statistics its forward used (chained or from K1's pass 1); emitted
statistics are not differentiable and chained ones take a zero cotangent,
as in the JAX package (fused_norm_conv.py:1983-1987).

K2's linear mode with no residual and few channels (C <= 8 or O <= 8: the
U-Net's conv_in and out conv) goes to the narrow-channel kernel instead
(`narrow_route`; csrc/narrow_conv.cu), and its backward, at O <= 8, to the
narrow backward kernels (`narrow_bwd_route`); conv_in's backward (no input
gradient) stays on K2's wgrad kernel.

Both wrappers are torch.autograd.Functions: CUDA kernels for CUDA tensors,
forward and backward; the plain PyTorch versions for CPU tensors (the
backward's plain version is `*_bwd_plain`). `.launches` counts the forward
kernels, `gn_silu_conv_bwd.launches` and `gn_silu_up_conv_bwd.launches` the
backward ones; `narrow_conv.launches` and `narrow_conv_bwd.launches` those of
the narrow route (`gn_silu_conv.launches` counts gnsc_kernel only).

bf16: K2, K3 and the narrow conv have bf16 kernels (gnsc_bf16_kernel; the
narrow convs' narrow_c_bf16_kernel and narrow_o_bf16_kernel, persistent
blocks on bf16 mma.sync whose launch plan `narrow_bf16_plan` mirrors),
which the wrappers launch for bf16 activations; x, w, the residual and the
skip weight are then bf16, and bias, skip bias, gamma, beta and the
statistics fp32. They round where the Pallas
kernel rounds on a bf16 network: the activation (GroupNorm and SiLU in fp32)
once to bf16 before the product, bf16 products summed in fp32, bias and
residual added in fp32, statistics emitted from the fp32 sums, the output
rounded once. `gn_silu_conv_plain`, `gn_silu_up_conv_plain` and
`narrow_conv_plain` of bf16 operands are that function; they use chained
statistics, as the kernels do.

The backward has bf16 kernels too (x, g, w, the residual and the skip
weight bf16; dW, dbias, dgamma, dbeta fp32), written for Hopper
(csrc/fused_norm_conv_bwd.cu: wgrad_bf16_kernel, dgrad_bf16_kernel and the
dx pass gn_dx_kernel, `gn_dx`, with its own launch counter; conv_in's wgrad
at C <= 8 wgrad_narrow_bf16_kernel, on wgmma), rounding where
the Pallas backward rounds on a bf16 network. K2 (_bwd_phase_a): the
activation recomputed in fp32 and rounded to bf16 before the product; dW,
dbias and the conv input's cotangent ds sums of bf16 products in fp32; da =
ds * silu' in fp32, dgamma and dbeta summed from it, da stored rounded to
bf16; dx from the upcast bf16 da in fp32 (_dx_from_da), rounded once. The
linear mode's da is ds rounded to bf16. K3 (_up_pair_bwd_kernel): ds stays
fp32 through the 2 x 2 fold (in dgrad's epilogue) and the low-res tail (da =
ds_low * silu' in the same epilogue, then the dx pass); dx rounded once.
`gn_silu_conv_bwd_plain`, `gn_silu_up_conv_bwd_plain` and
`narrow_conv_bwd_plain` of bf16 operands are that function, with the
statistics the forward used (the activation there in _act_from_x's form,
((x - mean) * rstd) * gamma + beta; K3's in the folded form, as
_up_pair_bwd_kernel writes it); `gn_dx_plain` is the dx pass's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as Fn

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, act_dtype, check,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)
from m_cedm_tpu_torch.kernels.fused_norm import (channel_stats,
                                                 channel_stats_plain, dx_from_da,
                                                 gn_silu_bf16_plain, gn_silu_plain,
                                                 group_mean_rstd,
                                                 group_mean_rstd_from_sums,
                                                 silu_grad)

Stats = Tuple[torch.Tensor, torch.Tensor]
Out = Union[torch.Tensor, Tuple[torch.Tensor, Stats]]
_MAX_C = 512
NARROW = 8  # csrc/narrow_conv.cu takes C <= 8 (narrow C) or O <= 8 (narrow O)
# the bf16 narrow kernels' plan (csrc/narrow_conv.cu's constexprs): narrow O
# walks 16 x 32 pixel tiles with NARROW_O_BLOCKS_PER_SM persistent blocks an
# SM; narrow C 8 x 16 tiles with NARROW_C_BLOCKS_PER_SM an SM at C <= 4 and
# NARROW_C_BLOCKS_PER_SM_WIDE above, shared among the 64-output chunks
NARROW_O_TILE, NARROW_C_TILE, NARROW_C_OUT = (16, 32), (8, 16), 64
NARROW_O_BLOCKS_PER_SM, NARROW_C_BLOCKS_PER_SM, NARROW_C_BLOCKS_PER_SM_WIDE = 2, 4, 2
_RES_NONE, _RES_IDENTITY, _RES_IDENTITY_UP, _RES_PROJ = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """SAME zero-padded 3x3 conv; x NHWC, w HWIO."""
    if x.is_cuda:
        fp32_reference_math()
    y = Fn.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _act_plain(x, gamma, beta, num_groups, eps):
    if gamma is None:
        return x
    b, h, w, c = x.shape
    return gn_silu_plain(x.reshape(b, h * w, c), gamma, beta, num_groups,
                         eps).reshape(x.shape)


def _out_stats_plain(out: torch.Tensor) -> Stats:
    return out.sum(dim=(1, 2)), (out * out).sum(dim=(1, 2))


def gn_silu_conv_plain(x, gamma, beta, w, bias, num_groups: int = 0,
                       eps: float = 1e-5, *, stats=None, residual=None,
                       res_up: bool = False, skip_w=None, skip_b=None,
                       emit_stats: bool = False) -> Out:
    """Reference of `gn_silu_conv` (gn_silu_conv_block_reference plus the
    identity_up and linear modes). Chained `stats` are ignored and the
    emitted ones recomputed from the output, as the JAX reference does.
    bf16 operands take the bf16 kernel's function (module docstring)."""
    if x.dtype == torch.bfloat16:
        return _gn_silu_conv_bf16_plain(x, gamma, beta, w, bias, num_groups, eps,
                                        stats, residual, res_up, skip_w, skip_b,
                                        emit_stats)
    del stats
    out = conv3x3_plain(_act_plain(x, gamma, beta, num_groups, eps), w, bias)
    if residual is not None:
        if skip_w is not None:
            if x.is_cuda:
                fp32_reference_math()
            proj = residual @ skip_w
            out = out + (proj + skip_b if skip_b is not None else proj)
        elif res_up:
            out = out + upsample2x_nearest(residual)
        else:
            out = out + residual
    return (out, _out_stats_plain(out)) if emit_stats else out


def gn_silu_up_conv_plain(x, gamma, beta, w, bias, num_groups: int,
                          eps: float = 1e-5, *, stats=None,
                          emit_stats: bool = False) -> Out:
    """Reference of `gn_silu_up_conv` (gn_silu_up_conv_reference); bf16
    operands take the bf16 kernel's function."""
    if x.dtype == torch.bfloat16:
        a = upsample2x_nearest(_act_bf16(x, gamma, beta, num_groups, eps, stats))
        return _round_out(conv3x3_plain(a.float(), w.float(), bias), emit_stats)
    del stats
    y = upsample2x_nearest(_act_plain(x, gamma, beta, num_groups, eps))
    out = conv3x3_plain(y, w, bias)
    return (out, _out_stats_plain(out)) if emit_stats else out


def _act_bf16(x, gamma, beta, num_groups, eps, stats):
    """What a bf16 kernel feeds its products: K1's bf16 function (GroupNorm
    and SiLU in fp32 from fp32 sums, chained or of x) rounded once, or x
    itself in the linear mode."""
    if gamma is None:
        return x
    b, h, w, c = x.shape
    return gn_silu_bf16_plain(x.reshape(b, h * w, c), gamma, beta, num_groups,
                              eps, stats).reshape(x.shape)


def _round_out(acc, emit_stats):
    """The fp32 sums rounded once to bf16; the statistics from the fp32 sums."""
    out = acc.to(torch.bfloat16)
    return (out, _out_stats_plain(acc)) if emit_stats else out


def _gn_silu_conv_bf16_plain(x, gamma, beta, w, bias, num_groups, eps, stats,
                             residual, res_up, skip_w, skip_b, emit_stats):
    """gnsc_bf16_kernel's function: bf16 products (exact in fp32) summed in
    fp32, the fp32 bias and the upcast residual (or its projection, bf16
    products summed in fp32, plus the fp32 skip bias) added in fp32."""
    a = _act_bf16(x, gamma, beta, num_groups, eps, stats)
    acc = conv3x3_plain(a.float(), w.float(), bias)
    if residual is not None:
        r = residual.float()
        if skip_w is not None:
            if x.is_cuda:
                fp32_reference_math()
            proj = r @ skip_w.float()
            acc = acc + (proj + skip_b if skip_b is not None else proj)
        elif res_up:
            acc = acc + upsample2x_nearest(r)
        else:
            acc = acc + r
    return _round_out(acc, emit_stats)


# ---------------------------------------------------------------------------
# Plain versions of the backward kernels (the CPU backward)
# ---------------------------------------------------------------------------

def _act_grad_plain(x, gamma, beta, num_groups, eps):
    """(silu(a), silu'(a), mean, rstd) for NHWC x, a = xhat * gamma + beta,
    with the plain forward's statistics."""
    b, h, w, c = x.shape
    mean, rstd = group_mean_rstd(x.reshape(b, h * w, c), num_groups, eps)
    a = ((x - mean[:, None, None]) * rstd[:, None, None] * gamma[:, None, None]
         + beta[:, None, None])
    return a * torch.sigmoid(a), silu_grad(a), mean, rstd


def conv3x3_wgrad_plain(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, C, O) of a SAME 3x3 conv: per tap, the conv input shifted by
    the tap contracted with g over every pixel (`dW[tap] += s^T gs`)."""
    _, h, w, _ = s.shape
    sp = Fn.pad(s, (0, 0, 1, 1, 1, 1))
    return torch.stack([torch.stack([
        torch.einsum("bhwc,bhwo->co", sp[:, dr:dr + h, dc:dc + w], g)
        for dc in range(3)]) for dr in range(3)])


def conv3x3_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv input's cotangent conv3x3^T(g): the mirrored taps of the zero
    padded cotangent against the transposed weights (`ds += gs @ W[tap]^T`)."""
    _, h, wd, _ = g.shape
    gp = Fn.pad(g, (0, 0, 1, 1, 1, 1))
    return sum(torch.einsum("bhwo,co->bhwc",
                            gp[:, 2 - dr:2 - dr + h, 2 - dc:2 - dc + wd], w[dr, dc])
               for dr in range(3) for dc in range(3))


def _fold2x2(t: torch.Tensor) -> torch.Tensor:
    """Cotangent of the nearest 2x upsample: each low-res cell gets the sum of
    its four high-res copies."""
    b, h, w, c = t.shape
    return t.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def _residual_grad(g, residual, res_up, skip_w):
    """dres of the block tail; plain PyTorch on either device, as in the JAX
    package (the proj mode's g @ skip_w^T is one XLA matmul there). bf16: the
    products and the fold in fp32, one rounding to bf16 (upcast operands, so
    no reduced-precision reduction of the library applies); identity's dres
    is g itself."""
    if residual is None:
        return None
    if g.dtype == torch.bfloat16 and (res_up or skip_w is not None):
        return _residual_grad(g.float(), residual, res_up,
                              None if skip_w is None else skip_w.float()).to(g.dtype)
    if skip_w is not None:
        return g @ skip_w.t()
    return _fold2x2(g) if res_up else g


def gn_silu_conv_bwd_plain(g, x, gamma, beta, w, num_groups: int = 0,
                           eps: float = 1e-5, residual=None, res_up: bool = False,
                           skip_w=None, stats: Optional[Stats] = None):
    """The K2 backward kernels' formulas (_gnsc_bwd_kernel_a, then
    _dx_from_da) with the plain forward's statistics. Returns (dx, dgamma,
    dbeta, dw, dbias, dres, dskip_w); None where the mode has no such input.
    dskip_b, where there is one, equals dbias. bf16 operands take the bf16
    kernels' function (module docstring), with the forward's `stats`."""
    if x.dtype == torch.bfloat16:
        return _gn_silu_conv_bwd_bf16_plain(g, x, gamma, beta, w, num_groups, eps,
                                            residual, res_up, skip_w, stats)
    b, h, wd, c = x.shape
    if gamma is None:  # linear mode: the conv input is x itself
        s, dsilu = x, None
    else:
        s, dsilu, mean, rstd = _act_grad_plain(x, gamma, beta, num_groups, eps)
    dw = conv3x3_wgrad_plain(s, g)
    dbias = g.sum(dim=(0, 1, 2))
    ds = conv3x3_dgrad_plain(g, w)
    dgamma = dbeta = None
    if dsilu is None:
        dx = ds
    else:
        da = ds * dsilu
        xhat = (x - mean[:, None, None]) * rstd[:, None, None]
        dgamma, dbeta = (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))
        dx = dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups)
    dskip_w = (torch.einsum("bhwr,bhwo->ro", residual, g)
               if skip_w is not None else None)
    return (dx, dgamma, dbeta, dw, dbias,
            _residual_grad(g, residual, res_up, skip_w), dskip_w)


def _mean_rstd_bf16(x, num_groups, eps, stats):
    """Per-(B, C) mean and rstd of NHWC x from the forward's fp32 `stats`
    (the channel sums of the upcast x when None), as the kernels fold them."""
    b, h, wd, c = x.shape
    if stats is None:
        stats = channel_stats_plain(x.reshape(b, h * wd, c))
    return group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)


def _gn_silu_conv_bwd_bf16_plain(g, x, gamma, beta, w, num_groups, eps,
                                 residual, res_up, skip_w, stats):
    """The bf16 K2 backward's function: the activation rounded to bf16 before
    the products, bf16 products summed in fp32, da = ds * silu' in fp32 with
    dgamma and dbeta from it, da rounded to bf16, dx from the upcast da in
    fp32 rounded once (the linear mode's dx is ds rounded)."""
    gf = g.float()
    if gamma is None:
        s = x.float()
    else:
        mean, rstd = _mean_rstd_bf16(x, num_groups, eps, stats)
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        a = xhat * gamma[:, None, None] + beta[:, None, None]
        s = (a * torch.sigmoid(a)).to(torch.bfloat16).float()
    dw = conv3x3_wgrad_plain(s, gf)
    dbias = gf.sum(dim=(0, 1, 2))
    ds = conv3x3_dgrad_plain(gf, w.float())
    dgamma = dbeta = None
    if gamma is None:
        dx = ds.to(x.dtype)
    else:
        da = ds * silu_grad(a)
        dgamma, dbeta = (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))
        dx = dx_from_da(x.float(), da.to(x.dtype).float(), gamma, dgamma, dbeta,
                        mean, rstd, num_groups).to(x.dtype)
    dskip_w = (torch.einsum("bhwr,bhwo->ro", residual.float(), gf)
               if skip_w is not None else None)
    return (dx, dgamma, dbeta, dw, dbias,
            _residual_grad(g, residual, res_up, skip_w), dskip_w)


def _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups):
    """GroupNorm / SiLU backward at low resolution from the folded conv-input
    cotangent (`_pallas_up_pair_bwd`'s XLA tail): (dx, dgamma, dbeta)."""
    xhat = (x - mean[:, None, None]) * rstd[:, None, None]
    a = xhat * gamma[:, None, None] + beta[:, None, None]
    da = ds_low * silu_grad(a)
    dgamma, dbeta = (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))
    return dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups), dgamma, dbeta


def gn_silu_up_conv_bwd_plain(g, x, gamma, beta, w, num_groups: int,
                              eps: float = 1e-5, stats: Optional[Stats] = None):
    """The K3 backward kernel's formulas (_up_pair_bwd_kernel and its XLA
    tail) with the plain forward's statistics: (dx, dgamma, dbeta, dw, dbias).
    x is low-res (B, h, w, C), g high-res (B, 2h, 2w, O). bf16 operands take
    the bf16 kernel's function (module docstring), with the forward's
    `stats`."""
    if x.dtype == torch.bfloat16:
        mean, rstd = _mean_rstd_bf16(x, num_groups, eps, stats)
        a_ = (gamma * rstd)[:, None, None]
        y = x.float() * a_ + (beta - gamma * rstd * mean)[:, None, None]
        s = (y * torch.sigmoid(y)).to(torch.bfloat16).float()
        gf = g.float()
        dw = conv3x3_wgrad_plain(upsample2x_nearest(s), gf)
        ds_low = _fold2x2(conv3x3_dgrad_plain(gf, w.float()))
        dx, dgamma, dbeta = _up_tail_bwd(ds_low, x.float(), gamma, beta, mean, rstd,
                                         num_groups)
        return dx.to(x.dtype), dgamma, dbeta, dw, gf.sum(dim=(0, 1, 2))
    s, _, mean, rstd = _act_grad_plain(x, gamma, beta, num_groups, eps)
    dw = conv3x3_wgrad_plain(upsample2x_nearest(s), g)
    ds_low = _fold2x2(conv3x3_dgrad_plain(g, w))
    return _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups) + (
        dw, g.sum(dim=(0, 1, 2)))


def narrow_conv_plain(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor], emit_stats: bool = False) -> Out:
    """Reference of the narrow-channel kernel: conv3x3_same(x) + bias, and
    with emit_stats the output's per-(B, O) sums and sums of squares. bf16
    operands: fp32 products and sums, the statistics of the fp32 result, one
    rounding to bf16."""
    if x.dtype == torch.bfloat16:
        return _round_out(conv3x3_plain(x.float(), w.float(), bias), emit_stats)
    out = conv3x3_plain(x, w, bias)
    return (out, _out_stats_plain(out)) if emit_stats else out


def narrow_conv_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          need_dx: bool = True):
    """The narrow backward kernels' formulas: (dx or None, dw, dbias). bf16
    operands: bf16 products summed in fp32, dx rounded once to bf16 (the
    Pallas K2 backward's linear mode)."""
    if x.dtype == torch.bfloat16:
        dx, dw, dbias = narrow_conv_bwd_plain(g.float(), x.float(), w.float(), need_dx)
        return None if dx is None else dx.to(x.dtype), dw, dbias
    dx = conv3x3_dgrad_plain(g, w) if need_dx else None
    return dx, conv3x3_wgrad_plain(x, g), g.sum(dim=(0, 1, 2))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def narrow_route(c: int, o: int, act: bool, residual: bool) -> bool:
    """Whether K2 sends a call to the narrow-channel kernel: the linear mode
    (no norm) with no residual tail and C <= 8 or O <= 8, i.e. the U-Net's
    conv_in and out conv. The down blocks' conv0 (64 -> 64) and every
    activated or residual call stay on gnsc_kernel."""
    return not act and not residual and (c <= NARROW or o <= NARROW)


def narrow_bwd_route(c: int, o: int, act: bool, residual: bool) -> bool:
    """Whether the backward of a K2 call goes to the narrow backward
    kernels: the narrow route at O <= 8 (the out conv). conv_in's backward
    (C <= 8, O = 64, no input gradient) stays on K2's wgrad kernel."""
    return narrow_route(c, o, act, residual) and o <= NARROW


def narrow_bf16_plan(b: int, h: int, w: int, c: int, o: int,
                     sms: int) -> Tuple[int, int, int, int]:
    """(kernel: 0 narrow O, 1 narrow C; tiles an image; grid x, the
    persistent blocks; grid y, the 64-output chunks) of the bf16 narrow conv
    on `sms` SMs, as csrc/narrow_conv.cu's bf16_plan: at most the blocks an
    SM times `sms` in all (narrow C's statistics take a cooperative launch).
    Block x of chunk y takes items x, x + grid x, ... of the b * tiles
    (image, tile) items, tile t at rows (t // tiles_w) th, columns (t %
    tiles_w) tw."""
    if o <= NARROW:
        th, tw = NARROW_O_TILE
        tiles = -(-h // th) * -(-w // tw)
        return 0, tiles, min(b * tiles, NARROW_O_BLOCKS_PER_SM * sms), 1
    th, tw = NARROW_C_TILE
    tiles, chunks = -(-h // th) * -(-w // tw), -(-o // NARROW_C_OUT)
    bps = NARROW_C_BLOCKS_PER_SM if c + c % 2 <= 4 else NARROW_C_BLOCKS_PER_SM_WIDE
    return 1, tiles, min(b * tiles, max(1, bps * sms // chunks)), chunks


def _check_narrow(x, w, bias):
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dt = act_dtype(x)
    check(x, "x", (b, h, wd, c), x.device, dt)
    check(w, "w", (3, 3, c, o), x.device, dt)
    if bias is not None:
        check(bias, "bias", (o,), x.device)
    if not narrow_route(c, o, False, False) or max(c, o) > _MAX_C:
        raise ValueError(f"the narrow conv takes C <= {NARROW} or O <= {NARROW} "
                         f"(the other at most {_MAX_C}), got C {c}, O {o}")
    return b, h, wd, c, o


def _narrow_conv_kernel(x, w, bias, emit_stats):
    """Narrow-channel conv launch: out, or (out, (sums, sumsq))."""
    b, h, wd, c, o = _check_narrow(x, w, bias)
    out = torch.empty((b, h, wd, o), device=x.device, dtype=x.dtype)
    ostats = part = None
    if emit_stats:  # the output's channel sums, then its sums of squares
        ostats = torch.empty((2, b, o), device=x.device, dtype=torch.float32)
        # the narrow-O tiles, or the narrow-C kernel's of this dtype (1 fp32, 3 bf16)
        which = 0 if o <= NARROW else 3 if x.dtype == torch.bfloat16 else 1
        tiles = _build.bind("narrow_conv", "mc_narrow_conv_tiles", [I] * 3)(h, wd, which)
        part = torch.empty((2, b, tiles, o), device=x.device, dtype=torch.float32)
    name = "mc_narrow_conv" + ("_bf16" if x.dtype == torch.bfloat16 else "")
    fn = _build.bind("narrow_conv", name, [P] * 6 + [I] * 5 + [P])
    raise_on_error(fn(ptr(x), ptr(w), ptr(bias), ptr(out), ptr(ostats), ptr(part),
                      b, h, wd, c, o, stream()), name)
    narrow_conv.launches += 1
    return (out, (ostats[0], ostats[1])) if emit_stats else out


_NARROW_WGRAD_BLOCKS = 4 * 132  # about four narrow wgrad blocks per SM of an H100


def narrow_conv_bwd(g, x, w, need_dx: bool = True):
    """The narrow backward kernels on the card (O <= 8): (dx or None, dw,
    dbias). dgrad and wgrad write every entry once and wgrad's per-run
    partials are added in a fixed order, so the result repeats bit for bit.
    bf16 g, x, w take the bf16 instances (dx bf16; dw, dbias fp32)."""
    b, h, wd, c, o = _check_narrow(x, w, None)
    check(g, "g", (b, h, wd, o), x.device, x.dtype)
    if o > NARROW:
        raise ValueError(f"the narrow backward takes O <= {NARROW}, got {o}")
    dev = x.device
    dx = torch.empty_like(x) if need_dx else None
    nw = 9 * c * o
    dwb = torch.empty((nw + o,), device=dev, dtype=torch.float32)  # dW, then dbias
    tiles = _build.bind("narrow_conv", "mc_narrow_conv_tiles", [I] * 3)(h, wd, 2)
    runs = min(tiles, -(-_NARROW_WGRAD_BLOCKS // b))
    part = torch.empty((b * runs, nw + o), device=dev, dtype=torch.float32)
    name = "mc_narrow_conv_bwd" + ("_bf16" if x.dtype == torch.bfloat16 else "")
    fn = _build.bind("narrow_conv", name, [P] * 6 + [I] * 6 + [P])
    raise_on_error(fn(ptr(g), ptr(x), ptr(w), ptr(dx), ptr(dwb), ptr(part),
                      b, h, wd, c, o, runs, stream()), name)
    narrow_conv_bwd.launches += 1
    return dx, dwb[:nw].view(3, 3, c, o), dwb[nw:]


narrow_conv_bwd.launches = 0


def _norm_inputs(x, gamma, beta, num_groups, stats):
    """Folded modulation and input statistics for an activated input."""
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    check(gamma, "gamma", (b, c), x.device)
    check(beta, "beta", (b, c), x.device)
    sums, sumsq = (stats if stats is not None
                   else channel_stats(x.reshape(b, h * w, c)))
    check(sums, "sums", (b, c), x.device)
    check(sumsq, "sumsq", (b, c), x.device)
    return sums, sumsq


def _emit_buffers(emit_stats, b, o, device):
    if not emit_stats:
        return None, None
    sums = torch.zeros((b, o), device=device, dtype=torch.float32)
    return sums, torch.zeros_like(sums)


def _gn_silu_conv_kernel(x, gamma, beta, w, bias, num_groups, eps, stats,
                         residual, res_up, skip_w, skip_b, emit_stats):
    """K2 forward launch; returns (out or (out, out_stats), input stats)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    dt = act_dtype(x)
    check(x, "x", (b, h, wd, c), dev, dt)
    check(w, "w", (3, 3, c, o), dev, dt)
    if bias is not None:
        check(bias, "bias", (o,), dev)
    if c > _MAX_C:
        raise ValueError(f"gn_silu_conv takes at most {_MAX_C} input channels")
    act = gamma is not None
    sums = sumsq = None
    if act:
        sums, sumsq = _norm_inputs(x, gamma, beta, num_groups, stats)
    cr, res_mode = 0, _RES_NONE
    if residual is not None:
        if skip_w is not None:
            cr, res_mode = residual.shape[-1], _RES_PROJ
            check(residual, "residual", (b, h, wd, cr), dev, dt)
            check(skip_w, "skip_w", (cr, o), dev, dt)
            if skip_b is not None:
                check(skip_b, "skip_b", (o,), dev)
        elif res_up:
            res_mode = _RES_IDENTITY_UP
            check(residual, "residual", (b, h // 2, wd // 2, o), dev, dt)
            if h % 2 or wd % 2:
                raise ValueError("res_up needs an even output height and width")
        else:
            res_mode = _RES_IDENTITY
            check(residual, "residual", (b, h, wd, o), dev, dt)
    out = torch.empty((b, h, wd, o), device=dev, dtype=dt)
    osums, osumsq = _emit_buffers(emit_stats, b, o, dev)
    name = "mc_gn_silu_conv" + ("_bf16" if dt == torch.bfloat16 else "")
    fn = _build.bind("fused_norm_conv", name, [P] * 13 + [I] * 7 + [F, I, I, P])
    rc = fn(ptr(x), ptr(w), ptr(bias), ptr(gamma), ptr(beta), ptr(sums),
            ptr(sumsq), ptr(residual), ptr(skip_w), ptr(skip_b), ptr(out),
            ptr(osums), ptr(osumsq), b, h, wd, c, o, cr, max(num_groups, 1),
            eps, int(act), res_mode, stream())
    raise_on_error(rc, name)
    gn_silu_conv.launches += 1
    return ((out, (osums, osumsq)) if emit_stats else out), (sums, sumsq)


def _gn_silu_up_conv_kernel(x, gamma, beta, w, bias, num_groups, eps, stats,
                            emit_stats):
    """K3 forward launch; returns (out or (out, out_stats), input stats)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    dt = act_dtype(x)
    check(x, "x", (b, h, wd, c), dev, dt)
    check(w, "w", (3, 3, c, o), dev, dt)
    if bias is not None:
        check(bias, "bias", (o,), dev)
    if c > _MAX_C:
        raise ValueError(f"gn_silu_up_conv takes at most {_MAX_C} input channels")
    sums, sumsq = _norm_inputs(x, gamma, beta, num_groups, stats)
    out = torch.empty((b, 2 * h, 2 * wd, o), device=dev, dtype=dt)
    osums, osumsq = _emit_buffers(emit_stats, b, o, dev)
    name = "mc_gn_silu_up_conv" + ("_bf16" if dt == torch.bfloat16 else "")
    fn = _build.bind("fused_norm_conv", name, [P] * 10 + [I] * 6 + [F, P])
    rc = fn(ptr(x), ptr(w), ptr(bias), ptr(gamma), ptr(beta), ptr(sums),
            ptr(sumsq), ptr(out), ptr(osums), ptr(osumsq), b, 2 * h, 2 * wd, c,
            o, num_groups, eps, stream())
    raise_on_error(rc, name)
    gn_silu_up_conv.launches += 1
    return ((out, (osums, osumsq)) if emit_stats else out), (sums, sumsq)


_BLOCKS_PER_SM = 2  # the fp32 wgrad kernel's occupancy (csrc/fused_norm_conv_bwd.cu)


@functools.lru_cache(maxsize=None)
def _dgrad_tiles(h: int, wd: int) -> int:
    """Pixel tiles per image of the dgrad kernel (its scratch's rows)."""
    return _build.bind("fused_norm_conv_bwd", "mc_conv_bwd_tiles", [I] * 3)(h, wd, 0)


@functools.lru_cache(maxsize=None)
def _wgrad_runs(b, h, wd, c, o, taps, up, device) -> int:
    """Pixel-tile runs per image of the fp32 wgrad kernel: about one wave of
    blocks at two an SM, at most one tile a run (the kernel's own rule)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _build.bind("fused_norm_conv_bwd", "mc_conv_wgrad_runs", [I] * 8)(
        b, h, wd, c, o, taps, int(up), _BLOCKS_PER_SM * sms)


@functools.lru_cache(maxsize=None)
def _bf16_bwd_plan(which: int, up: bool, b: int, h: int, wd: int, c: int, o: int,
                  taps: int, device) -> Tuple[int, int, int, int, int]:
    """The bf16 backward kernels' launch plan (mc_conv_bwd_bf16_plan; which 0
    dgrad, 1 wgrad; h, wd the cotangent's): (tile rows, weights resident,
    blocks, dynamic shared memory bytes, rows of the partials' scratch); the
    narrow wgrad (C <= 8) gives (0, 0, blocks, shared memory, blocks along
    the pixels). `device` keys the cache: the plan fills the card's SMs."""
    out = (ctypes.c_int * 5)()
    name = "mc_conv_bwd_bf16_plan"
    raise_on_error(_build.bind("fused_norm_conv_bwd", name, [I] * 8 + [P])(
        which, int(up), b, h, wd, c, o, taps, out), name)
    return tuple(out)


def _wgrad(x, g, gamma, beta, stats, num_groups, eps, taps, up, with_bias):
    """Launch the wgrad kernel and its fixed-order reduce: (dw (3, 3, C, O),
    or (C, O) for one tap, and dbias (O,) or None). x (B, Hin, Win, C), g
    (B, H, W, O) at the output size. Per-run partials go to a scratch that
    the reduce adds in a fixed order, so the result repeats bit for bit.
    bf16 x and g take the bf16 kernels (dw, dbias fp32; at C <= 8 the narrow
    one on wgmma), whose scratch has a row a persistent block along the
    pixels (_bf16_bwd_plan)."""
    b, h, wd, o = g.shape
    c = x.shape[-1]
    bf = x.dtype == torch.bfloat16
    if bf:
        runs = rows = _bf16_bwd_plan(1, up, b, h, wd, c, o, taps, x.device)[4]
    else:
        runs = _wgrad_runs(b, h, wd, c, o, taps, up, x.device)
        rows = b * runs
    nw = taps * c * o
    k = nw + (o if with_bias else 0)
    dwb = torch.empty((k,), device=x.device, dtype=torch.float32)
    part = torch.empty((rows, k), device=x.device, dtype=torch.float32)
    sums, sumsq = stats if stats is not None else (None, None)
    name = "mc_conv_wgrad" + ("_bf16" if bf else "")
    fn = _build.bind("fused_norm_conv_bwd", name, [P] * 8 + [I] * 6 + [F] + [I] * 5 + [P])
    raise_on_error(fn(ptr(x), ptr(g), ptr(gamma), ptr(beta), ptr(sums),
                      ptr(sumsq), ptr(dwb), ptr(part), b, h, wd, c, o,
                      max(num_groups, 1), eps, int(gamma is not None), taps,
                      int(up), int(with_bias), runs, stream()), name)
    dw = dwb[:nw].view((3, 3, c, o) if taps == 9 else (c, o))
    return dw, (dwb[nw:] if with_bias else None)


_DGRAD_LINEAR, _DGRAD_ACT, _DGRAD_UP_FOLD = 0, 1, 2


def _dgrad(g, w, x, gamma, beta, stats, num_groups, eps, mode, out):
    """Launch the dgrad kernel (modes in csrc/fused_norm_conv_bwd.cu) into
    `out`; where it emits (dgamma, dbeta) also the fixed-order reduce of its
    partials, returning them as one (2, B, C) tensor (else None): the act
    mode, and bf16's up-fold mode. bf16 g and w take the bf16 kernel: `out`
    bf16 in the linear and act modes (da rounded once); in the up-fold mode
    the low-res da (B, H / 2, W / 2, C) in fp32 (fp32's: the column-folded
    ds (B, H, W / 2, C), no statistics)."""
    b, h, wd, o = g.shape
    c = w.shape[2]
    bf = g.dtype == torch.bfloat16
    sums, sumsq = stats if stats is not None else (None, None)
    dstats = part = None
    if mode == _DGRAD_ACT or (bf and mode == _DGRAD_UP_FOLD):
        rows = (_bf16_bwd_plan(0, mode == _DGRAD_UP_FOLD, b, h, wd, c, o, 9, g.device)[4]
                if bf else _dgrad_tiles(h, wd))
        dstats = torch.empty((2, b, c), device=g.device, dtype=torch.float32)
        part = torch.empty((2, b, rows, c), device=g.device, dtype=torch.float32)
    name = "mc_conv_dgrad" + ("_bf16" if bf else "")
    fn = _build.bind("fused_norm_conv_bwd", name, [P] * 10 + [I] * 6 + [F, I, P])
    raise_on_error(fn(ptr(g), ptr(w), ptr(x), ptr(gamma), ptr(beta), ptr(sums),
                      ptr(sumsq), ptr(out), ptr(dstats), ptr(part), b, h, wd,
                      c, o, max(num_groups, 1), eps, mode, stream()), name)
    return dstats


def gn_dx_plain(x, da, gamma, dstats, stats: Stats, num_groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """The dx pass's function (`_dx_from_da`, rounded once to x's dtype):
    the GroupNorm input gradient of x (B, ..., C) from the cotangent da of
    the affine output (bf16, or fp32 as K3's low-res tail keeps it), dstats
    (2, B, C) = (dgamma, dbeta) and the forward's channel sums `stats`, in
    fp32 (`dx_from_da`)."""
    b, c = gamma.shape
    mean, rstd = group_mean_rstd_from_sums(*stats, x.numel() // (b * c), num_groups, eps)
    return dx_from_da(x.float(), da.float(), gamma, dstats[0], dstats[1], mean, rstd,
                      num_groups).to(x.dtype)


def gn_dx(x, da, gamma, dstats, stats: Stats, num_groups: int,
          eps: float = 1e-5) -> torch.Tensor:
    """The dx pass of the bf16 K2 / K3 backward (`gn_dx_plain`'s function) as
    one kernel on the card (csrc/fused_norm_conv_bwd.cu::gn_dx_kernel): x
    bf16, da bf16 or fp32 of x's shape, dstats (2, B, C), gamma and the
    statistics fp32; dx bf16. The plain version for CPU tensors; other
    dtypes raise."""
    if on_cpu(x):
        return gn_dx_plain(x, da, gamma, dstats, stats, num_groups, eps)
    b, c = gamma.shape
    dev = x.device
    if x.dtype != torch.bfloat16 or da.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the dx kernel takes bf16 x and bf16 or fp32 da, got {x.dtype} "
                         f"and {da.dtype}")
    check(x, "x", x.shape, dev, torch.bfloat16)
    if x.shape[0] != b or x.shape[-1] != c:
        raise ValueError(f"x {tuple(x.shape)} does not match gamma {tuple(gamma.shape)}")
    check(da, "da", x.shape, dev, da.dtype)
    check(gamma, "gamma", (b, c), dev)
    check(dstats, "dstats", (2, b, c), dev)
    for t, name in zip(stats, ("sums", "sumsq")):
        check(t, name, (b, c), dev)
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    dx = torch.empty_like(x)
    fn = _build.bind("fused_norm_conv_bwd", "mc_gn_dx_bf16", [P] * 7 + [I] * 4 + [F, I, P])
    raise_on_error(fn(ptr(x), ptr(da), ptr(gamma), ptr(dstats), ptr(stats[0]), ptr(stats[1]),
                      ptr(dx), b, x.numel() // (b * c), c, num_groups, eps,
                      int(da.dtype == torch.float32), stream()), "mc_gn_dx_bf16")
    gn_dx.launches += 1
    return dx


gn_dx.launches = 0


def gn_silu_conv_bwd(g, x, gamma, beta, w, stats: Optional[Stats],
                     num_groups: int = 0, eps: float = 1e-5, residual=None,
                     res_up: bool = False, skip_w=None, need_da: bool = True):
    """K2 backward kernels on the card, with `stats` the (sums, sumsq) the
    forward used (None in the linear mode). Returns what
    `gn_silu_conv_bwd_plain` returns; dx (and dgamma, dbeta) are None when
    `need_da` is False, which skips the dgrad kernel. bf16 operands take the
    bf16 instances (dx and dres bf16)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    dt = act_dtype(x)
    check(g, "g", (b, h, wd, o), dev, dt)
    check(x, "x", (b, h, wd, c), dev, dt)
    check(w, "w", (3, 3, c, o), dev, dt)
    if skip_w is not None:
        cr = residual.shape[-1]
        check(residual, "residual", (b, h, wd, cr), dev, dt)
        check(skip_w, "skip_w", (cr, o), dev, dt)
    act = gamma is not None
    if act:
        _norm_inputs(x, gamma, beta, num_groups, stats)
    dw, dbias = _wgrad(x, g, gamma, beta, stats, num_groups, eps, 9, False, True)
    dx = dgamma = dbeta = None
    if need_da:
        da = torch.empty_like(x)
        dstats = _dgrad(g, w, x, gamma, beta, stats, num_groups, eps,
                        _DGRAD_ACT if act else _DGRAD_LINEAR, da)
        dx = da
        if act:
            dgamma, dbeta = dstats[0], dstats[1]
            if dt == torch.bfloat16:
                dx = gn_dx(x, da, gamma, dstats, stats, num_groups, eps)
            else:
                mean, rstd = group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)
                dx = dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups)
    dskip_w = None
    if skip_w is not None:
        dskip_w = _wgrad(residual, g, None, None, None, 0, eps, 1, False, False)[0]
    gn_silu_conv_bwd.launches += 1
    return (dx, dgamma, dbeta, dw, dbias,
            _residual_grad(g, residual, res_up, skip_w), dskip_w)


gn_silu_conv_bwd.launches = 0


def gn_silu_up_conv_bwd(g, x, gamma, beta, w, stats: Stats, num_groups: int,
                        eps: float = 1e-5):
    """K3 backward kernels on the card: (dx, dgamma, dbeta, dw, dbias). x is
    low-res (B, h, w, C), g high-res (B, 2h, 2w, O). bf16 operands take the
    bf16 instances (dx bf16)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    dt = act_dtype(x)
    check(g, "g", (b, 2 * h, 2 * wd, o), dev, dt)
    check(x, "x", (b, h, wd, c), dev, dt)
    check(w, "w", (3, 3, c, o), dev, dt)
    _norm_inputs(x, gamma, beta, num_groups, stats)
    dw, dbias = _wgrad(x, g, gamma, beta, stats, num_groups, eps, 9, True, True)
    gn_silu_up_conv_bwd.launches += 1
    if dt == torch.bfloat16:
        # dgrad folds the 2 x 2 block of each low-res pixel and forms the
        # fp32 da there with (dgamma, dbeta); the dx kernel rounds dx once
        da = torch.empty(x.shape, device=dev, dtype=torch.float32)
        dstats = _dgrad(g, w, x, gamma, beta, stats, num_groups, eps, _DGRAD_UP_FOLD, da)
        dx = gn_dx(x, da, gamma, dstats, stats, num_groups, eps)
        return dx, dstats[0], dstats[1], dw, dbias
    ds = torch.empty((b, 2 * h, wd, c), device=dev, dtype=torch.float32)
    _dgrad(g, w, None, None, None, None, num_groups, eps, _DGRAD_UP_FOLD, ds)
    # the row pair of each low-res pixel, then GroupNorm / SiLU at low res
    ds_low = ds.reshape(b, h, 2, wd, c).sum(dim=2)
    mean, rstd = group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)
    return _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups) + (dw, dbias)


gn_silu_up_conv_bwd.launches = 0


class _GnSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, sums, sumsq, residual, skip_w,
                skip_b, num_groups, eps, res_up, emit_stats):
        stats = None if sums is None else (sums, sumsq)
        route = (x.shape[-1], w.shape[-1], gamma is not None, residual is not None)
        used = (None, None)
        if narrow_route(*route):
            out = (narrow_conv_plain if on_cpu(x) else _narrow_conv_kernel)(
                x, w, bias, emit_stats)
        elif on_cpu(x):
            out = gn_silu_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                                     stats=stats, residual=residual, res_up=res_up,
                                     skip_w=skip_w, skip_b=skip_b,
                                     emit_stats=emit_stats)
            if stats is not None:  # the bf16 backward uses the forward's
                used = stats
        else:
            out, used = _gn_silu_conv_kernel(x, gamma, beta, w, bias, num_groups,
                                             eps, stats, residual, res_up,
                                             skip_w, skip_b, emit_stats)
        ctx.save_for_backward(x, gamma, beta, w, residual, skip_w, *used)
        ctx.cfg = (num_groups, eps, res_up, bias is not None, skip_b is not None,
                   narrow_bwd_route(*route))
        if not emit_stats:
            return out
        out, (osums, osumsq) = out
        ctx.mark_non_differentiable(osums, osumsq)
        return out, osums, osumsq

    @staticmethod
    def backward(ctx, g, *unused_stats_grads):
        num_groups, eps, res_up, has_bias, has_skip_b, narrow = ctx.cfg
        x, gamma, beta, w, residual, skip_w, sums, sumsq = ctx.saved_tensors
        g = g.contiguous()
        stats = None if sums is None else (sums, sumsq)
        if narrow:
            dx, dw, dbias = (narrow_conv_bwd_plain if on_cpu(g) else narrow_conv_bwd)(
                g, x, w, ctx.needs_input_grad[0])
            grads = (dx, None, None, dw, dbias, None, None)
        elif on_cpu(g):
            grads = gn_silu_conv_bwd_plain(g, x, gamma, beta, w, num_groups, eps,
                                           residual, res_up, skip_w, stats)
        else:
            need_da = any(ctx.needs_input_grad[:3])
            grads = gn_silu_conv_bwd(g, x, gamma, beta, w, stats, num_groups,
                                     eps, residual, res_up, skip_w, need_da)
        dx, dgamma, dbeta, dw, dbias, dres, dskip_w = grads
        # chained input statistics take a zero cotangent: the dx identities
        # already hold the statistics' dependence on x
        return (dx, dgamma, dbeta, dw, dbias if has_bias else None, None, None,
                dres, dskip_w, dbias if has_skip_b else None,
                None, None, None, None)


class _GnSiluUpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, sums, sumsq, num_groups, eps,
                emit_stats):
        stats = None if sums is None else (sums, sumsq)
        if on_cpu(x):
            out = gn_silu_up_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                                        stats=stats, emit_stats=emit_stats)
            used = (None, None) if stats is None else stats
        else:
            out, used = _gn_silu_up_conv_kernel(x, gamma, beta, w, bias,
                                                num_groups, eps, stats, emit_stats)
        ctx.save_for_backward(x, gamma, beta, w, *used)
        ctx.cfg = (num_groups, eps, bias is not None)
        if not emit_stats:
            return out
        out, (osums, osumsq) = out
        ctx.mark_non_differentiable(osums, osumsq)
        return out, osums, osumsq

    @staticmethod
    def backward(ctx, g, *unused_stats_grads):
        num_groups, eps, has_bias = ctx.cfg
        x, gamma, beta, w, sums, sumsq = ctx.saved_tensors
        g = g.contiguous()
        if on_cpu(g):
            grads = gn_silu_up_conv_bwd_plain(g, x, gamma, beta, w, num_groups, eps,
                                              None if sums is None else (sums, sumsq))
        else:
            grads = gn_silu_up_conv_bwd(g, x, gamma, beta, w, (sums, sumsq),
                                        num_groups, eps)
        dx, dgamma, dbeta, dw, dbias = grads
        return (dx, dgamma, dbeta, dw, dbias if has_bias else None, None, None,
                None, None, None)


def _apply_emit(out, emit_stats):
    return (out[0], (out[1], out[2])) if emit_stats else out


def gn_silu_conv(x, gamma, beta, w, bias, num_groups: int = 0,
                 eps: float = 1e-5, *, stats: Optional[Stats] = None,
                 residual=None, res_up: bool = False, skip_w=None, skip_b=None,
                 emit_stats: bool = False) -> Out:
    """K2: the fused norm + SiLU + conv3x3 block tail (module docstring).

    x (B, H, W, C); gamma/beta (B, C) or None for the linear mode; w
    (3, 3, C, O); bias (O,) or None. residual: (B, H, W, O) identity,
    (B, H/2, W/2, O) with res_up, or (B, H, W, C_res) with skip_w (C_res, O)
    and skip_b (O,) or None. Returns out, or (out, (sums, sumsq)) of out's
    channels when emit_stats (not differentiable)."""
    sums, sumsq = stats if stats is not None else (None, None)
    return _apply_emit(_GnSiluConv.apply(x, gamma, beta, w, bias, sums, sumsq,
                                         residual, skip_w, skip_b, num_groups,
                                         eps, res_up, emit_stats), emit_stats)


gn_silu_conv.launches = 0


def narrow_conv(x, w, bias, emit_stats: bool = False) -> Out:
    """K2's linear mode at C <= 8 or O <= 8 (conv_in, the out conv):
    conv3x3_same(x) + bias through the narrow-channel kernel, as
    `gn_silu_conv(x, None, None, w, bias)` routes it; raises on other
    widths."""
    if not narrow_route(x.shape[-1], w.shape[-1], False, False):
        raise ValueError(f"the narrow conv takes C <= {NARROW} or O <= {NARROW}, "
                         f"got C {x.shape[-1]}, O {w.shape[-1]}")
    return gn_silu_conv(x, None, None, w, bias, emit_stats=emit_stats)


narrow_conv.launches = 0


def gn_silu_up_conv(x, gamma, beta, w, bias, num_groups: int,
                    eps: float = 1e-5, *, stats: Optional[Stats] = None,
                    emit_stats: bool = False) -> Out:
    """K3: conv3x3_same(upsample2x_nearest(silu(gn(x) * gamma + beta))) + bias.

    x (B, h, w, C) at LOW resolution; output (B, 2h, 2w, O). `stats` are the
    low-res x's channel sums (nearest upsampling keeps the group statistics)."""
    sums, sumsq = stats if stats is not None else (None, None)
    return _apply_emit(_GnSiluUpConv.apply(x, gamma, beta, w, bias, sums, sumsq,
                                           num_groups, eps, emit_stats),
                       emit_stats)


gn_silu_up_conv.launches = 0
