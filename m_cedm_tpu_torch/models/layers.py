"""Shared layers of the ADM U-Net (port of m_cedm_tpu/models/layers.py).

NHWC activations throughout. Conv weights are stored HWIO (k, k, C, O), the
layout the conv kernels read and the JAX checkpoint uses; a 1x1 conv stores
its weight as a (C, O) matrix. Linear stores PyTorch's (out, in). The
counterpart of `fp32_softmax_attention` is the K4 wrapper,
m_cedm_tpu_torch.kernels.fused_attention.attention.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m_cedm_tpu_torch.kernels import Ops
from m_cedm_tpu_torch.kernels.fused_norm_conv import (conv3x3_plain,
                                                      upsample2x_nearest)

__all__ = ["make_initializer", "Linear", "Conv2d", "upsample2x_nearest",
           "downsample2x_mean", "GroupNormSiLU", "GroupNorm", "adm_groups",
           "adm_group_norm"]


def make_initializer(mode: str, scale: float, fan_in: int, fan_out: int):
    """ADM weight-init family; returns init(shape, generator) -> tensor."""

    def uniform(shape, generator, bound):
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        if mode == "xavier_uniform":
            return uniform(shape, generator, math.sqrt(6 / (fan_in + fan_out))) * scale
        if mode == "xavier_normal":
            std = math.sqrt(2 / (fan_in + fan_out))
            return torch.randn(shape, generator=generator) * std * scale
        if mode == "kaiming_uniform":
            return uniform(shape, generator, math.sqrt(3 / fan_in)) * scale
        if mode == "kaiming_normal":
            return torch.randn(shape, generator=generator) * math.sqrt(1 / fan_in) * scale
        raise ValueError(f"invalid init mode {mode!r}")

    return init


class Linear(nn.Module):
    """Dense layer with ADM-style init (fans from the feature counts)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self._init = (init_mode, init_weight, init_bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        mode, w_scale, b_scale = self._init
        out_f, in_f = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(make_initializer(mode, w_scale, in_f, out_f)(
                (out_f, in_f), generator))
            if self.bias is not None:
                self.bias.copy_(make_initializer(mode, b_scale, in_f, out_f)(
                    (out_f,), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """3x3 or 1x1 SAME conv with ADM-style init (fans are C*k*k, O*k*k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 use_bias: bool = True, init_mode: str = "kaiming_normal",
                 init_weight: float = 1.0, init_bias: float = 0.0):
        super().__init__()
        if kernel not in (1, 3):
            raise ValueError(f"kernel {kernel} not supported")
        shape = ((in_channels, out_channels) if kernel == 1
                 else (kernel, kernel, in_channels, out_channels))
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self._init = (init_mode, init_weight, init_bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        mode, w_scale, b_scale = self._init
        k = self.kernel
        c, o = self.weight.shape[-2:]
        fan_in, fan_out = c * k * k, o * k * k
        with torch.no_grad():
            self.weight.copy_(make_initializer(mode, w_scale, fan_in, fan_out)(
                tuple(self.weight.shape), generator))
            if self.bias is not None:
                self.bias.copy_(make_initializer(mode, b_scale, fan_in, fan_out)(
                    (o,), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel == 1:
            y = x @ self.weight
            return y + self.bias if self.bias is not None else y
        return conv3x3_plain(x, self.weight, self.bias)


def downsample2x_mean(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling of an NHWC tensor, summed in the JAX order."""
    a = x[:, 0::2] + x[:, 1::2]
    return (a[:, :, 0::2] + a[:, :, 1::2]) * 0.25


def adm_groups(c: int) -> int:
    """ADM convention: groups = min(32, C // 4)."""
    return min(32, c // 4)


class GroupNormSiLU(nn.Module):
    """silu(gn(x) * (1 + film_scale) + film_shift) through the K1 kernel.

    The norm's own scale/bias and the per-sample FiLM modulation fold into
    (B, C) gamma/beta (`fold`), which the fused norm kernels consume."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def fold(self, batch: int, film_scale: Optional[torch.Tensor] = None,
             film_shift: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.weight.shape[0]
        gamma = self.weight[None].expand(batch, c)
        beta = self.bias[None].expand(batch, c)
        if film_scale is not None:
            fs = film_scale + 1.0
            gamma = gamma * fs
            beta = beta * fs + film_shift
        return gamma.contiguous(), beta.contiguous()

    def forward(self, x: torch.Tensor, ops: Ops, film_scale=None, film_shift=None,
                stats=None) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        gamma, beta = self.fold(b, film_scale, film_shift)
        y = ops.gn_silu(x.reshape(b, -1, c), gamma, beta, self.num_groups,
                        self.eps, stats=stats)
        return y.reshape(x.shape)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm on NHWC: fp32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), then (x - mean) * (rsqrt(var + eps) * scale)
    + bias. Plain PyTorch: the attention-site norm is not a TPU kernel."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, h * w, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, 1, g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(1, 1, g, c // g)
        return y.reshape(x.shape)


def adm_group_norm(num_channels: int, eps: float = 1e-5) -> GroupNorm:
    return GroupNorm(num_channels, adm_groups(num_channels), eps)
