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
csrc/fused_norm_conv_bwd.cu (a dgrad and a wgrad kernel). The backward uses
the statistics its forward used (chained or from K1's pass 1); emitted
statistics are not differentiable and chained ones take a zero cotangent,
as in the JAX package (fused_norm_conv.py:1983-1987).

Both wrappers are torch.autograd.Functions: CUDA kernels for CUDA tensors,
forward and backward; the plain PyTorch versions for CPU tensors (the
backward's plain version is `*_bwd_plain`). `.launches` counts the forward
kernels, `gn_silu_conv_bwd.launches` and `gn_silu_up_conv_bwd.launches` the
backward ones.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as Fn

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check,
                                              fp32_reference_math, on_cpu, ptr,
                                              raise_on_error, stream)
from m_cedm_tpu_torch.kernels.fused_norm import (channel_stats, dx_from_da,
                                                 gn_silu_plain, group_mean_rstd,
                                                 group_mean_rstd_from_sums,
                                                 silu_grad)

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
    package (the proj mode's g @ skip_w^T is one XLA matmul there)."""
    if residual is None:
        return None
    if skip_w is not None:
        return g @ skip_w.t()
    return _fold2x2(g) if res_up else g


def gn_silu_conv_bwd_plain(g, x, gamma, beta, w, num_groups: int = 0,
                           eps: float = 1e-5, residual=None, res_up: bool = False,
                           skip_w=None):
    """The K2 backward kernels' formulas (_gnsc_bwd_kernel_a, then
    _dx_from_da) with the plain forward's statistics. Returns (dx, dgamma,
    dbeta, dw, dbias, dres, dskip_w); None where the mode has no such input.
    dskip_b, where there is one, equals dbias."""
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


def _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups):
    """GroupNorm / SiLU backward at low resolution from the folded conv-input
    cotangent (`_pallas_up_pair_bwd`'s XLA tail): (dx, dgamma, dbeta)."""
    xhat = (x - mean[:, None, None]) * rstd[:, None, None]
    a = xhat * gamma[:, None, None] + beta[:, None, None]
    da = ds_low * silu_grad(a)
    dgamma, dbeta = (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))
    return dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups), dgamma, dbeta


def gn_silu_up_conv_bwd_plain(g, x, gamma, beta, w, num_groups: int,
                              eps: float = 1e-5):
    """The K3 backward kernel's formulas (_up_pair_bwd_kernel and its XLA
    tail) with the plain forward's statistics: (dx, dgamma, dbeta, dw, dbias).
    x is low-res (B, h, w, C), g high-res (B, 2h, 2w, O)."""
    s, _, mean, rstd = _act_grad_plain(x, gamma, beta, num_groups, eps)
    dw = conv3x3_wgrad_plain(upsample2x_nearest(s), g)
    ds_low = _fold2x2(conv3x3_dgrad_plain(g, w))
    return _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups) + (
        dw, g.sum(dim=(0, 1, 2)))


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


def _gn_silu_conv_kernel(x, gamma, beta, w, bias, num_groups, eps, stats,
                         residual, res_up, skip_w, skip_b, emit_stats):
    """K2 forward launch; returns (out or (out, out_stats), input stats)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
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
    return ((out, (osums, osumsq)) if emit_stats else out), (sums, sumsq)


def _gn_silu_up_conv_kernel(x, gamma, beta, w, bias, num_groups, eps, stats,
                            emit_stats):
    """K3 forward launch; returns (out or (out, out_stats), input stats)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
    if bias is not None:
        check(bias, "bias", (o,), dev)
    if c > _MAX_C:
        raise ValueError(f"gn_silu_up_conv takes at most {_MAX_C} input channels")
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
    return ((out, (osums, osumsq)) if emit_stats else out), (sums, sumsq)


_WGRAD_BLOCKS = 4 * 132   # about four wgrad blocks per SM of an H100


def _wgrad(x, g, gamma, beta, stats, num_groups, eps, taps, up, dw, dbias):
    """Launch the wgrad kernel: adds into the zeroed dw (taps, C, O) and, when
    given, dbias (O,). x (B, Hin, Win, C), g (B, H, W, O) at the output size.
    A block owns 16 input x 64 output channels of one image and a run of its
    8 x 16 pixel tiles; the runs per image fill about _WGRAD_BLOCKS blocks."""
    b, h, wd, o = g.shape
    c = x.shape[-1]
    tiles = -(-h // 8) * -(-wd // 16)
    blocks = b * -(-c // 16) * -(-o // 64)
    splits = min(tiles, max(1, -(-_WGRAD_BLOCKS // blocks)))
    sums, sumsq = stats if stats is not None else (None, None)
    fn = _build.bind("fused_norm_conv_bwd", "mc_conv_wgrad",
                     [P] * 8 + [I] * 6 + [F] + [I] * 4 + [P])
    raise_on_error(fn(ptr(x), ptr(g), ptr(gamma), ptr(beta), ptr(sums),
                      ptr(sumsq), ptr(dw), ptr(dbias), b, h, wd, c, o,
                      max(num_groups, 1), eps, int(gamma is not None), taps,
                      int(up), splits, stream()), "mc_conv_wgrad")


_DGRAD_LINEAR, _DGRAD_ACT, _DGRAD_UP_FOLD = 0, 1, 2


def _dgrad(g, w, x, gamma, beta, stats, num_groups, eps, mode, out, dgamma,
           dbeta):
    """Launch the dgrad kernel (modes in csrc/fused_norm_conv_bwd.cu)."""
    b, h, wd, o = g.shape
    c = w.shape[2]
    sums, sumsq = stats if stats is not None else (None, None)
    fn = _build.bind("fused_norm_conv_bwd", "mc_conv_dgrad",
                     [P] * 10 + [I] * 6 + [F, I, P])
    raise_on_error(fn(ptr(g), ptr(w), ptr(x), ptr(gamma), ptr(beta), ptr(sums),
                      ptr(sumsq), ptr(out), ptr(dgamma), ptr(dbeta), b, h, wd,
                      c, o, max(num_groups, 1), eps, mode, stream()),
                   "mc_conv_dgrad")


def gn_silu_conv_bwd(g, x, gamma, beta, w, stats: Optional[Stats],
                     num_groups: int = 0, eps: float = 1e-5, residual=None,
                     res_up: bool = False, skip_w=None, need_da: bool = True):
    """K2 backward kernels on the card, with `stats` the (sums, sumsq) the
    forward used (None in the linear mode). Returns what
    `gn_silu_conv_bwd_plain` returns; dx (and dgamma, dbeta) are None when
    `need_da` is False, which skips the dgrad kernel."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(g, "g", (b, h, wd, o), dev)
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
    act = gamma is not None
    if act:
        _norm_inputs(x, gamma, beta, num_groups, stats)
    zeros = lambda *s: torch.zeros(s, device=dev, dtype=torch.float32)
    dw, dbias = zeros(3, 3, c, o), zeros(o)
    _wgrad(x, g, gamma, beta, stats, num_groups, eps, 9, False, dw, dbias)
    dx = dgamma = dbeta = None
    if need_da:
        da = torch.empty_like(x)
        if act:
            dgamma, dbeta = zeros(b, c), zeros(b, c)
        _dgrad(g, w, x, gamma, beta, stats, num_groups, eps,
               _DGRAD_ACT if act else _DGRAD_LINEAR, da, dgamma, dbeta)
        dx = da
        if act:
            mean, rstd = group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)
            dx = dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups)
    dskip_w = None
    if skip_w is not None:
        cr = residual.shape[-1]
        check(residual, "residual", (b, h, wd, cr), dev)
        dskip_w = zeros(1, cr, o)
        _wgrad(residual, g, None, None, None, 0, eps, 1, False, dskip_w, None)
        dskip_w = dskip_w.reshape(cr, o)
    gn_silu_conv_bwd.launches += 1
    return (dx, dgamma, dbeta, dw, dbias,
            _residual_grad(g, residual, res_up, skip_w), dskip_w)


gn_silu_conv_bwd.launches = 0


def gn_silu_up_conv_bwd(g, x, gamma, beta, w, stats: Stats, num_groups: int,
                        eps: float = 1e-5):
    """K3 backward kernels on the card: (dx, dgamma, dbeta, dw, dbias). x is
    low-res (B, h, w, C), g high-res (B, 2h, 2w, O)."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    check(g, "g", (b, 2 * h, 2 * wd, o), dev)
    check(x, "x", (b, h, wd, c), dev)
    check(w, "w", (3, 3, c, o), dev)
    _norm_inputs(x, gamma, beta, num_groups, stats)
    dw = torch.zeros((3, 3, c, o), device=dev, dtype=torch.float32)
    dbias = torch.zeros((o,), device=dev, dtype=torch.float32)
    _wgrad(x, g, gamma, beta, stats, num_groups, eps, 9, True, dw, dbias)
    ds = torch.empty((b, 2 * h, wd, c), device=dev, dtype=torch.float32)
    _dgrad(g, w, None, None, None, None, num_groups, eps, _DGRAD_UP_FOLD, ds,
           None, None)
    # the row pair of each low-res pixel, then GroupNorm / SiLU at low res
    ds_low = ds.reshape(b, h, 2, wd, c).sum(dim=2)
    mean, rstd = group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)
    gn_silu_up_conv_bwd.launches += 1
    return _up_tail_bwd(ds_low, x, gamma, beta, mean, rstd, num_groups) + (dw, dbias)


gn_silu_up_conv_bwd.launches = 0


class _GnSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, sums, sumsq, residual, skip_w,
                skip_b, num_groups, eps, res_up, emit_stats):
        stats = None if sums is None else (sums, sumsq)
        if on_cpu(x):
            out = gn_silu_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                                     residual=residual, res_up=res_up,
                                     skip_w=skip_w, skip_b=skip_b,
                                     emit_stats=emit_stats)
            used = (None, None)
        else:
            out, used = _gn_silu_conv_kernel(x, gamma, beta, w, bias, num_groups,
                                             eps, stats, residual, res_up,
                                             skip_w, skip_b, emit_stats)
        ctx.save_for_backward(x, gamma, beta, w, residual, skip_w, *used)
        ctx.cfg = (num_groups, eps, res_up, bias is not None, skip_b is not None)
        if not emit_stats:
            return out
        out, (osums, osumsq) = out
        ctx.mark_non_differentiable(osums, osumsq)
        return out, osums, osumsq

    @staticmethod
    def backward(ctx, g, *unused_stats_grads):
        num_groups, eps, res_up, has_bias, has_skip_b = ctx.cfg
        x, gamma, beta, w, residual, skip_w, sums, sumsq = ctx.saved_tensors
        g = g.contiguous()
        if on_cpu(g):
            grads = gn_silu_conv_bwd_plain(g, x, gamma, beta, w, num_groups, eps,
                                           residual, res_up, skip_w)
        else:
            stats = None if sums is None else (sums, sumsq)
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
                                        emit_stats=emit_stats)
            used = (None, None)
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
            grads = gn_silu_up_conv_bwd_plain(g, x, gamma, beta, w, num_groups, eps)
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
