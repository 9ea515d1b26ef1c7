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

Each wrapper runs its CUDA kernel for CUDA tensors and its plain PyTorch
version for CPU tensors, and counts kernel launches in `.launches`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as Fn

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check, forward_only,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)
from m_cedm_tpu_torch.kernels.fused_norm import channel_stats, gn_silu_plain

Stats = Tuple[torch.Tensor, torch.Tensor]
Out = Union[torch.Tensor, Tuple[torch.Tensor, Stats]]
_MAX_C = 512
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
    emitted ones recomputed from the output, as the JAX reference does."""
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
    """Reference of `gn_silu_up_conv` (gn_silu_up_conv_reference)."""
    del stats
    y = upsample2x_nearest(_act_plain(x, gamma, beta, num_groups, eps))
    out = conv3x3_plain(y, w, bias)
    return (out, _out_stats_plain(out)) if emit_stats else out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

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


def gn_silu_conv(x, gamma, beta, w, bias, num_groups: int = 0,
                 eps: float = 1e-5, *, stats: Optional[Stats] = None,
                 residual=None, res_up: bool = False, skip_w=None, skip_b=None,
                 emit_stats: bool = False) -> Out:
    """K2: the fused norm + SiLU + conv3x3 block tail (module docstring).

    x (B, H, W, C); gamma/beta (B, C) or None for the linear mode; w
    (3, 3, C, O); bias (O,) or None. residual: (B, H, W, O) identity,
    (B, H/2, W/2, O) with res_up, or (B, H, W, C_res) with skip_w (C_res, O)
    and skip_b (O,) or None. Returns out, or (out, (sums, sumsq)) of out's
    channels when emit_stats."""
    if on_cpu(x):
        return gn_silu_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                                  residual=residual, res_up=res_up,
                                  skip_w=skip_w, skip_b=skip_b,
                                  emit_stats=emit_stats)
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
    if bias is not None:
        check(bias, "bias", (o,), dev)
    if c > _MAX_C:
        raise ValueError(f"gn_silu_conv takes at most {_MAX_C} input channels")
    forward_only(x, gamma, beta, w, bias, residual, skip_w, skip_b)
    act = gamma is not None
    sums = sumsq = None
    if act:
        sums, sumsq = _norm_inputs(x, gamma, beta, num_groups, stats)
    cr, res_mode = 0, _RES_NONE
    if residual is not None:
        if skip_w is not None:
            cr, res_mode = residual.shape[-1], _RES_PROJ
            check(residual, "residual", (b, h, wd, cr), dev)
            check(skip_w, "skip_w", (cr, o), dev)
            if skip_b is not None:
                check(skip_b, "skip_b", (o,), dev)
        elif res_up:
            res_mode = _RES_IDENTITY_UP
            check(residual, "residual", (b, h // 2, wd // 2, o), dev)
            if h % 2 or wd % 2:
                raise ValueError("res_up needs an even output height and width")
        else:
            res_mode = _RES_IDENTITY
            check(residual, "residual", (b, h, wd, o), dev)
    out = torch.empty((b, h, wd, o), device=dev, dtype=torch.float32)
    osums, osumsq = _emit_buffers(emit_stats, b, o, dev)
    fn = _build.bind("fused_norm_conv", "mc_gn_silu_conv",
                     [P] * 13 + [I] * 7 + [F, I, I, P])
    rc = fn(ptr(x), ptr(w), ptr(bias), ptr(gamma), ptr(beta), ptr(sums),
            ptr(sumsq), ptr(residual), ptr(skip_w), ptr(skip_b), ptr(out),
            ptr(osums), ptr(osumsq), b, h, wd, c, o, cr, max(num_groups, 1),
            eps, int(act), res_mode, stream())
    raise_on_error(rc, "mc_gn_silu_conv")
    gn_silu_conv.launches += 1
    return (out, (osums, osumsq)) if emit_stats else out


gn_silu_conv.launches = 0


def gn_silu_up_conv(x, gamma, beta, w, bias, num_groups: int,
                    eps: float = 1e-5, *, stats: Optional[Stats] = None,
                    emit_stats: bool = False) -> Out:
    """K3: conv3x3_same(upsample2x_nearest(silu(gn(x) * gamma + beta))) + bias.

    x (B, h, w, C) at LOW resolution; output (B, 2h, 2w, O). `stats` are the
    low-res x's channel sums (nearest upsampling keeps the group statistics)."""
    if on_cpu(x):
        return gn_silu_up_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                                     emit_stats=emit_stats)
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
    if bias is not None:
        check(bias, "bias", (o,), dev)
    if c > _MAX_C:
        raise ValueError(f"gn_silu_up_conv takes at most {_MAX_C} input channels")
    forward_only(x, gamma, beta, w, bias)
    sums, sumsq = _norm_inputs(x, gamma, beta, num_groups, stats)
    out = torch.empty((b, 2 * h, 2 * wd, o), device=dev, dtype=torch.float32)
    osums, osumsq = _emit_buffers(emit_stats, b, o, dev)
    fn = _build.bind("fused_norm_conv", "mc_gn_silu_up_conv",
                     [P] * 10 + [I] * 6 + [F, P])
    rc = fn(ptr(x), ptr(w), ptr(bias), ptr(gamma), ptr(beta), ptr(sums),
            ptr(sumsq), ptr(out), ptr(osums), ptr(osumsq), b, 2 * h, 2 * wd, c,
            o, num_groups, eps, stream())
    raise_on_error(rc, "mc_gn_silu_up_conv")
    gn_silu_up_conv.launches += 1
    return (out, (osums, osumsq)) if emit_stats else out


gn_silu_up_conv.launches = 0
