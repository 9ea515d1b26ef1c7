"""K1: GroupNorm (+ per-sample FiLM) + SiLU, silu(gn(x) * gamma + beta).

Port of m_cedm_tpu/pallas/fused_norm.py (kernels `_stats_kernel`,
`_apply_kernel`; the paired twins `_stats4_kernel`/`_apply4_kernel` of
fused_norm_conv.py compute the same math). CUDA source:
csrc/fused_norm.cu, whose header says what bounds it on an H100 and how its
design handles that.

`gn_silu` and `channel_stats` run the CUDA kernel for a CUDA tensor and the
plain PyTorch version beside them for a CPU tensor; each counts its kernel
launches in `.launches`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check, forward_only,
                                              on_cpu, ptr, raise_on_error, stream)

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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def channel_stats(x: torch.Tensor) -> Stats:
    """K1 pass 1: per-(B, C) sums of a (B, N, C) activation."""
    if on_cpu(x):
        return channel_stats_plain(x)
    b, n, c = x.shape
    check(x, "x", (b, n, c), x.device)
    forward_only(x)
    sums = torch.zeros((b, c), device=x.device, dtype=torch.float32)
    sumsq = torch.zeros_like(sums)
    fn = _build.bind("fused_norm", "mc_channel_stats", [P, P, P, I, I, I, P])
    raise_on_error(fn(ptr(x), ptr(sums), ptr(sumsq), b, n, c, stream()),
                   "mc_channel_stats")
    channel_stats.launches += 1
    return sums, sumsq


channel_stats.launches = 0


def gn_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            num_groups: int, eps: float = 1e-5,
            stats: Optional[Stats] = None) -> torch.Tensor:
    """K1: silu(group_norm(x) * gamma + beta). x (B, N, C); gamma/beta (B, C)
    per-sample folded modulation; `stats` optional chained (sums, sumsq) of
    x, which skip the stats pass."""
    if on_cpu(x):
        return gn_silu_plain(x, gamma, beta, num_groups, eps)
    b, n, c = x.shape
    dev = x.device
    check(x, "x", (b, n, c), dev)
    check(gamma, "gamma", (b, c), dev)
    check(beta, "beta", (b, c), dev)
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    forward_only(x, gamma, beta)
    sums, sumsq = stats if stats is not None else channel_stats(x)
    check(sums, "sums", (b, c), dev)
    check(sumsq, "sumsq", (b, c), dev)
    out = torch.empty_like(x)
    fn = _build.bind("fused_norm", "mc_gn_silu", [P, P, P, P, P, P, I, I, I, I, F, P])
    raise_on_error(fn(ptr(x), ptr(gamma), ptr(beta), ptr(sums), ptr(sumsq),
                      ptr(out), b, n, c, num_groups, eps, stream()), "mc_gn_silu")
    gn_silu.launches += 1
    return out


gn_silu.launches = 0
