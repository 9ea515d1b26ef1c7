"""K1: GroupNorm (+ per-sample FiLM) + SiLU, silu(gn(x) * gamma + beta), and
its backward.

Port of m_cedm_tpu/pallas/fused_norm.py (kernels `_stats_kernel`,
`_apply_kernel`, and the backward's `_grad_stats_kernel`,
`_grad_apply_kernel`; the paired twins `_stats4_kernel`/`_apply4_kernel`/
`_grad_stats4_kernel`/`_grad_apply4_kernel` of fused_norm_conv.py compute the
same math). CUDA source: csrc/fused_norm.cu, whose header says what bounds it
on an H100 and how its design handles that.

`gn_silu` is a torch.autograd.Function and `channel_stats` a plain wrapper:
each runs its CUDA kernel for a CUDA tensor and the plain PyTorch version
beside it for a CPU tensor, and counts its kernel launches in `.launches`
(`gn_silu_bwd.launches` for the backward). The statistics are not
differentiable: a consumer's backward computes the full GroupNorm gradient
from x and gives chained statistics a zero cotangent.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check, on_cpu, ptr,
                                              raise_on_error, stream)

Stats = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def channel_stats_plain(x: torch.Tensor) -> Stats:
    """Per-(B, C) sum and sum of squares of a (B, N, C) activation."""
    return x.sum(dim=1), (x * x).sum(dim=1)


def gn_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  num_groups: int, eps: float = 1e-5,
                  stats: Optional[Stats] = None) -> torch.Tensor:
    """silu(group_norm(x) * gamma + beta); x (B, N, C), gamma/beta (B, C).

    Two-pass variance as in group_norm_silu_reference. Chained `stats` are
    ignored and recomputed, as the JAX reference does."""
    del stats
    b, n, c = x.shape
    xg = x.reshape(b, n, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xhat = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, n, c)
    y = xhat * gamma[:, None, :] + beta[:, None, :]
    return y * torch.sigmoid(y)


def _per_channel(v: torch.Tensor, c: int) -> torch.Tensor:
    """(B, G) group values -> (B, C)."""
    return v.repeat_interleave(c // v.shape[-1], dim=-1)


def group_mean_rstd(x: torch.Tensor, num_groups: int, eps: float):
    """Per-(B, C) mean and rstd of a (B, N, C) tensor's groups, two-pass as
    `gn_silu_plain` computes them."""
    b, n, c = x.shape
    xg = x.reshape(b, n, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return _per_channel(mean, c), _per_channel(torch.rsqrt(var + eps), c)


def group_mean_rstd_from_sums(sums: torch.Tensor, sumsq: torch.Tensor, n: int,
                              num_groups: int, eps: float):
    """Per-(B, C) mean and rstd from channel sums over n pixels, as the
    kernels fold them (E[x^2] - mean^2, clamped at 0)."""
    b, c = sums.shape
    cnt = n * (c // num_groups)
    mean = sums.reshape(b, num_groups, -1).sum(-1) / cnt
    var = torch.clamp(sumsq.reshape(b, num_groups, -1).sum(-1) / cnt
                      - mean * mean, min=0.0)
    return _per_channel(mean, c), _per_channel(torch.rsqrt(var + eps), c)


def dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups: int):
    """The GroupNorm input gradient from the cotangent da of the affine
    output a = xhat * gamma + beta and its channel sums dgamma = sum da * xhat,
    dbeta = sum da (`_dx_from_da`): dx = rstd * (da * gamma - m1 - xhat * m2),
    m1 and m2 the group means of da * gamma and da * gamma * xhat, which the
    identities sum(da * gamma) = gamma * dbeta and sum(da * gamma * xhat) =
    gamma * dgamma give from (B, C) vectors. x, da (B, N, C) or NHWC."""
    b, c = gamma.shape
    n = x.numel() // (b * c)
    cnt = n * (c // num_groups)

    def gmean(v):
        return _per_channel(v.reshape(b, num_groups, -1).sum(-1) / cnt, c)

    m1, m2 = gmean(gamma * dbeta), gmean(gamma * dgamma)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    r, g = rstd.reshape(shape), gamma.reshape(shape)
    xhat = (x - mean.reshape(shape)) * r
    return r * (da * g - m1.reshape(shape) - xhat * m2.reshape(shape))


def silu_grad(y: torch.Tensor) -> torch.Tensor:
    """d silu(y) / dy."""
    sig = torch.sigmoid(y)
    return sig * (1.0 + y * (1.0 - sig))


def gn_silu_bwd_plain(g, x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """The backward kernels' formulas (_grad_stats_kernel, _grad_apply_kernel)
    with the plain forward's statistics: (dx, dgamma, dbeta)."""
    mean, rstd = group_mean_rstd(x, num_groups, eps)
    xhat = (x - mean[:, None]) * rstd[:, None]
    dy = g * silu_grad(xhat * gamma[:, None] + beta[:, None])
    dgamma, dbeta = (dy * xhat).sum(dim=1), dy.sum(dim=1)
    return dx_from_da(x, dy, gamma, dgamma, dbeta, mean, rstd, num_groups), dgamma, dbeta


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def channel_stats(x: torch.Tensor) -> Stats:
    """K1 pass 1: per-(B, C) sums of a (B, N, C) activation."""
    if on_cpu(x):
        return channel_stats_plain(x)
    b, n, c = x.shape
    check(x, "x", (b, n, c), x.device)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("channel statistics are not differentiable: pass a "
                         "detached tensor (the consumers' backward kernels "
                         "take the full GroupNorm gradient)")
    sums = torch.zeros((b, c), device=x.device, dtype=torch.float32)
    sumsq = torch.zeros_like(sums)
    fn = _build.bind("fused_norm", "mc_channel_stats", [P, P, P, I, I, I, P])
    raise_on_error(fn(ptr(x), ptr(sums), ptr(sumsq), b, n, c, stream()),
                   "mc_channel_stats")
    channel_stats.launches += 1
    return sums, sumsq


channel_stats.launches = 0


def _gn_silu_kernel(x, gamma, beta, sums, sumsq, num_groups, eps):
    b, n, c = x.shape
    dev = x.device
    check(x, "x", (b, n, c), dev)
    check(gamma, "gamma", (b, c), dev)
    check(beta, "beta", (b, c), dev)
    check(sums, "sums", (b, c), dev)
    check(sumsq, "sumsq", (b, c), dev)
    out = torch.empty_like(x)
    fn = _build.bind("fused_norm", "mc_gn_silu", [P, P, P, P, P, P, I, I, I, I, F, P])
    raise_on_error(fn(ptr(x), ptr(gamma), ptr(beta), ptr(sums), ptr(sumsq),
                      ptr(out), b, n, c, num_groups, eps, stream()), "mc_gn_silu")
    gn_silu.launches += 1
    return out


def gn_silu_bwd(g, x, gamma, beta, stats: Stats, num_groups: int,
                eps: float = 1e-5):
    """K1 backward kernels on the card (grad-stats, then grad-apply): (dx,
    dgamma, dbeta), with `stats` the (sums, sumsq) the forward used."""
    b, n, c = x.shape
    dev = x.device
    for name, t, shape in (("g", g, (b, n, c)), ("x", x, (b, n, c)),
                           ("gamma", gamma, (b, c)), ("beta", beta, (b, c)),
                           ("sums", stats[0], (b, c)), ("sumsq", stats[1], (b, c))):
        check(t, name, shape, dev)
    dgamma = torch.zeros((b, c), device=dev, dtype=torch.float32)
    dbeta = torch.zeros_like(dgamma)
    dx = torch.empty_like(x)
    fn = _build.bind("fused_norm", "mc_gn_silu_bwd", [P] * 9 + [I] * 4 + [F, P])
    raise_on_error(fn(ptr(x), ptr(g), ptr(gamma), ptr(beta), ptr(stats[0]),
                      ptr(stats[1]), ptr(dgamma), ptr(dbeta), ptr(dx), b, n, c,
                      num_groups, eps, stream()), "mc_gn_silu_bwd")
    gn_silu_bwd.launches += 1
    return dx, dgamma, dbeta


gn_silu_bwd.launches = 0


class _GnSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, sums, sumsq, num_groups, eps):
        ctx.cfg = (num_groups, eps)
        if on_cpu(x):
            ctx.save_for_backward(x, gamma, beta)
            return gn_silu_plain(x, gamma, beta, num_groups, eps)
        if x.shape[-1] % num_groups:
            raise ValueError(f"{x.shape[-1]} channels do not split into "
                             f"{num_groups} groups")
        if sums is None:
            sums, sumsq = channel_stats(x)
        ctx.save_for_backward(x, gamma, beta, sums, sumsq)
        return _gn_silu_kernel(x, gamma, beta, sums, sumsq, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps = ctx.cfg
        x, gamma, beta, *stats = ctx.saved_tensors
        g = g.contiguous()
        if on_cpu(g):
            grads = gn_silu_bwd_plain(g, x, gamma, beta, num_groups, eps)
        else:
            grads = gn_silu_bwd(g, x, gamma, beta, tuple(stats), num_groups, eps)
        # the statistics take a zero cotangent: dx above is the full gradient
        return grads + (None, None, None, None)


def gn_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            num_groups: int, eps: float = 1e-5,
            stats: Optional[Stats] = None) -> torch.Tensor:
    """K1: silu(group_norm(x) * gamma + beta). x (B, N, C); gamma/beta (B, C)
    per-sample folded modulation; `stats` optional chained (sums, sumsq) of
    x, which skip the stats pass (on the card; the plain version recomputes
    them, as the JAX reference does)."""
    sums, sumsq = stats if stats is not None else (None, None)
    return _GnSilu.apply(x, gamma, beta, sums, sumsq, num_groups, eps)


gn_silu.launches = 0
