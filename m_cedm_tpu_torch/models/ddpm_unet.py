"""The DDPM/DDIM U-Net ("Model") on NHWC tensors (port of
m_cedm_tpu/models/ddpm_unet.py), with the same module names, so that
convert.py maps the flax tree one to one.

The forward is the JAX package's fused, stats-chained form (`_paired` and
`_forward_pairio`, ddpm_unet.py:179-247 and :415-529) without the paired
layout: every ResnetBlock is two K2 calls,

  K2(x; norm1 + SiLU, conv1; chained stats, emit)  ->  h, stats of h
  h + t,  t = temb_proj(silu(temb)),  stats of h + t adjusted exactly:
        sums + N t,  sumsq + 2 t sums + N t^2
  K2(h + t; norm2 + SiLU, conv2; chained stats, + x or + x @ nin_shortcut)

so no statistics pass reads h + t. A block's input statistics come from the
block before it; where an attention site or a resample made the input (and
for the one half of a decoder concat without them), K1's statistics pass
computes them. conv_in and conv_out (C <= 8, O <= 8) take K2's narrow-channel
kernel, the out head's GroupNorm + SiLU K1 with the last block's statistics,
the Upsample's 3x3 conv K2's linear mode, the AttnBlock's softmax attention
K4 (one 64-wide head over the 32x32 tokens at full width). The Downsample's
stride-2 conv (XLA in the JAX package, not a Pallas kernel) is
torch.nn.functional.conv2d with TF32 off.

The norms are the DDPM's: 32 groups, eps 1e-6 (2 channels a group at 64
channels). Every fused operation is a torch.autograd.Function whose backward
is a kernel on the card; chained statistics take a zero cotangent, so the
temb's gradient reaches t through h + t alone, as in the JAX package.

`bayesian` (logvar), dx conditioning, the cond encoder (cond_channels > 0
without cat_cond) and training with dropout > 0 raise; no shipped config
sets them (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.kernels._launch import fp32_reference_math
from m_cedm_tpu_torch.models.layers import (DDPM_EPS, DDPM_GROUPS, Conv2d,
                                            GroupNormSiLU, Linear,
                                            ddpm_group_norm, downsample2x_mean,
                                            upsample2x_nearest)
from m_cedm_tpu_torch.ops.schedules import sinusoidal_timestep_embedding

Stats = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DdpmUNetConfig:
    in_channels: int
    out_ch: int
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 1, 1)
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 128
    dropout: float = 0.0
    resamp_with_conv: bool = True
    cond_channels: int = 0
    cat_cond: bool = False
    self_cond: bool = False
    dx_cond: bool = False
    cat_dx: bool = False
    bayesian: bool = False
    num_timesteps: int = 1000

    @staticmethod
    def from_hparams(hparams) -> "DdpmUNetConfig":
        m = hparams["model"]
        diffusion = hparams.get("diffusion") or {}
        return DdpmUNetConfig(
            in_channels=m["in_channels"], out_ch=m["out_ch"], ch=m["ch"],
            ch_mult=tuple(m["ch_mult"]), num_res_blocks=m["num_res_blocks"],
            attn_resolutions=tuple(m["attn_resolutions"]),
            resolution=m["resolution"], dropout=m.get("dropout", 0.0),
            resamp_with_conv=m.get("resamp_with_conv", True),
            cond_channels=m.get("cond_channels", 0),
            cat_cond=m.get("cat_cond", False), self_cond=m.get("self_cond", False),
            dx_cond=m.get("dx_cond", False), cat_dx=m.get("cat_dx", False),
            bayesian=m.get("type", "simple") == "bayesian",
            num_timesteps=diffusion.get("num_diffusion_timesteps", 1000))

    @property
    def total_in_channels(self) -> int:
        c = self.in_channels * (2 if self.self_cond else 1)
        if self.cat_cond:
            c += self.cond_channels
        if self.dx_cond and self.cat_dx:
            c += self.in_channels
        return c


def _conv(in_channels: int, out_channels: int, kernel: int = 3) -> Conv2d:
    """The JAX package's TorchConv2d: torch's default init."""
    return Conv2d(in_channels, out_channels, kernel, init_mode="torch_default",
                  init_bias=1.0)


def _linear(in_features: int, out_features: int) -> Linear:
    """The JAX package's TorchLinear: torch's default init."""
    return Linear(in_features, out_features, init_mode="torch_default", init_bias=1.0)


def _channel_stats(ops: Ops, x: torch.Tensor) -> Stats:
    """K1's statistics pass over an NHWC activation; chained statistics carry
    no gradient (the consumer's backward takes the whole GroupNorm
    gradient), so the pass reads x detached."""
    return ops.channel_stats(x.detach().reshape(x.shape[0], -1, x.shape[-1]))


class ResnetBlock(nn.Module):
    """DDPM residual block with additive time conditioning, as two K2 calls
    with the statistics chained across the temb add (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, DDPM_GROUPS, DDPM_EPS)
        self.conv1 = _conv(in_channels, out_channels)
        self.temb_proj = _linear(temb_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, DDPM_GROUPS, DDPM_EPS)
        self.conv2 = _conv(out_channels, out_channels)
        self.nin_shortcut = (_conv(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, in_stats: Optional[Stats],
                ops: Ops) -> Tuple[torch.Tensor, Stats]:
        b, hh, ww, _ = x.shape
        npix = hh * ww
        g1, b1 = self.norm1.fold(b)
        h, (hs, hss) = ops.gn_silu_conv(x, g1, b1, self.conv1.weight, self.conv1.bias,
                                        DDPM_GROUPS, DDPM_EPS, stats=in_stats,
                                        emit_stats=True)
        t = self.temb_proj(F.silu(temb))
        h = h + t[:, None, None, :]
        # exact channel statistics of h + t (ddpm_unet.py:233-238)
        stats = (hs + npix * t, hss + 2.0 * t * hs + npix * t * t)
        g2, b2 = self.norm2.fold(b)
        nin = self.nin_shortcut
        return ops.gn_silu_conv(h, g2, b2, self.conv2.weight, self.conv2.bias,
                                DDPM_GROUPS, DDPM_EPS, stats=stats, residual=x,
                                skip_w=None if nin is None else nin.weight,
                                skip_b=None if nin is None else nin.bias,
                                emit_stats=True)


class AttnBlock(nn.Module):
    """GroupNorm, q/k/v as 1x1 convs, one-head softmax attention over the
    H * W tokens (K4: the function of attention_reference), proj_out, and
    the residual. The JAX module's norm `GroupNorm_0` is `attn_norm`."""

    def __init__(self, channels: int):
        super().__init__()
        self.attn_norm = ddpm_group_norm(channels)
        self.q = _conv(channels, channels, 1)
        self.k = _conv(channels, channels, 1)
        self.v = _conv(channels, channels, 1)
        self.proj_out = _conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, ops: Ops) -> torch.Tensor:
        b, hh, ww, c = x.shape
        y = self.attn_norm(x)
        q, k, v = (m(y).reshape(b, hh * ww, c) for m in (self.q, self.k, self.v))
        a = ops.attention(q, k, v).reshape(b, hh, ww, c)
        return x + self.proj_out(a)


class Downsample(nn.Module):
    """torch's (0, 1, 0, 1) pad, then a valid stride-2 3x3 conv; or a 2x2
    mean pool without the conv."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.conv = _conv(channels, channels) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is None:
            return downsample2x_mean(x)
        if x.is_cuda:
            fp32_reference_math()
        y = F.conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2),
                     self.conv.weight.permute(3, 2, 0, 1), self.conv.bias, stride=2)
        return y.permute(0, 2, 3, 1).contiguous()


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv through K2's linear mode."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.conv = _conv(channels, channels) if with_conv else None

    def forward(self, x: torch.Tensor, ops: Ops) -> torch.Tensor:
        x = upsample2x_nearest(x)
        if self.conv is None:
            return x
        return ops.gn_silu_conv(x.contiguous(), None, None, self.conv.weight,
                                self.conv.bias)


class DdpmUNet(nn.Module):
    """The DDPM U-Net; x (B, H, W, C) and t (B,) in, (B, H, W, out_ch) out.

    `ops` selects the fused operations (DEVICE_OPS: the kernels on the card,
    their plain versions on the CPU; PLAIN_OPS: plain everywhere). `calls`
    counts forwards."""

    def __init__(self, cfg: DdpmUNetConfig, ops: Ops = DEVICE_OPS):
        super().__init__()
        if cfg.bayesian or cfg.dx_cond or (cfg.cond_channels > 0 and not cfg.cat_cond):
            raise NotImplementedError(
                "the DDPM U-Net's bayesian logvar, dx and cond-encoder inputs are "
                "not ported yet (see ROADMAP.md)")
        self.cfg, self.ops, self.calls = cfg, ops, 0
        ch = cfg.ch
        temb_ch = 4 * ch
        self.temb_dense0 = _linear(ch, temb_ch)
        self.temb_dense1 = _linear(temb_ch, temb_ch)
        self.conv_in = _conv(cfg.total_in_channels, ch)
        self.order: List[Tuple[str, str]] = []  # (kind, name) in forward order

        def add(kind, name, module):
            self.add_module(name, module)
            self.order.append((kind, name))

        n = len(cfg.ch_mult)
        res, c_in = cfg.resolution, ch
        skips = [ch]
        for level in range(n):
            c_out = ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks):
                add("down", f"down_{level}_block_{i}", ResnetBlock(c_in, c_out, temb_ch))
                c_in = c_out
                if res in cfg.attn_resolutions:
                    add("attn", f"down_{level}_attn_{i}", AttnBlock(c_in))
                skips.append(c_in)
            if level != n - 1:
                add("downsample", f"down_{level}_downsample",
                    Downsample(c_in, cfg.resamp_with_conv))
                skips.append(c_in)
                res //= 2
        add("block", "mid_block_1", ResnetBlock(c_in, c_in, temb_ch))
        add("attn", "mid_attn_1", AttnBlock(c_in))
        add("block", "mid_block_2", ResnetBlock(c_in, c_in, temb_ch))
        for level in reversed(range(n)):
            c_out = ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                add("up", f"up_{level}_block_{i}",
                    ResnetBlock(c_in + skips.pop(), c_out, temb_ch))
                c_in = c_out
                if res in cfg.attn_resolutions:
                    add("attn", f"up_{level}_attn_{i}", AttnBlock(c_in))
            if level != 0:
                add("upsample", f"up_{level}_upsample",
                    Upsample(c_in, cfg.resamp_with_conv))
                res *= 2
        self.norm_out = GroupNormSiLU(c_in, DDPM_GROUPS, DDPM_EPS)
        self.conv_out = _conv(c_in, cfg.out_ch)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch's default init of every layer, in module order, from
        `generator`; the norms start at scale 1, bias 0."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, ops = self.cfg, self.ops
        if x.dtype == torch.bfloat16:
            raise NotImplementedError("bf16 compute of the DDPM U-Net is not ported "
                                      "yet (see ROADMAP.md)")
        if x.shape[1] != cfg.resolution or x.shape[2] != cfg.resolution:
            raise ValueError(f"input {tuple(x.shape)} is not at resolution "
                             f"{cfg.resolution}")
        if self.training and cfg.dropout > 0:
            raise NotImplementedError("training with dropout > 0 is not ported "
                                      "yet (see ROADMAP.md)")
        self.calls += 1
        temb = sinusoidal_timestep_embedding(t, cfg.ch)
        temb = self.temb_dense1(F.silu(self.temb_dense0(temb)))
        if cfg.self_cond:
            x = torch.cat([torch.zeros_like(x) if x_self_cond is None else x_self_cond,
                           x], dim=-1)
        if cfg.cat_cond and cfg.cond_channels > 0:
            if cond is None:
                cond = x.new_zeros(x.shape[:3] + (cfg.cond_channels,))
            x = torch.cat([cond, x], dim=-1)
        h, stats = ops.gn_silu_conv(x.contiguous(), None, None, self.conv_in.weight,
                                    self.conv_in.bias, emit_stats=True)
        skips = [(h, stats)]
        for kind, name in self.order:
            mod = getattr(self, name)
            if kind == "attn":
                h, stats = mod(h, ops), None
            elif kind == "downsample":
                h, stats = mod(skips[-1][0]), None
            elif kind == "upsample":
                h, stats = mod(h, ops), None
            else:
                if kind == "up":
                    skip, skip_stats = skips.pop()
                    # where one half's statistics are known, K1's pass runs
                    # over the other half alone
                    if stats is not None or skip_stats is not None:
                        stats = stats or _channel_stats(ops, h)
                        skip_stats = skip_stats or _channel_stats(ops, skip)
                        stats = (torch.cat([stats[0], skip_stats[0]], -1),
                                 torch.cat([stats[1], skip_stats[1]], -1))
                    h = torch.cat([h, skip], dim=-1)
                h, stats = mod(h, temb, stats, ops)
            if name.startswith("down_"):  # the encoder's outputs are the skips
                if kind == "attn":  # the attention follows its block's entry
                    skips[-1] = (h, None)
                else:
                    skips.append((h, stats))
        y = self.norm_out(h, ops, stats=stats)
        return ops.gn_silu_conv(y, None, None, self.conv_out.weight, self.conv_out.bias)
