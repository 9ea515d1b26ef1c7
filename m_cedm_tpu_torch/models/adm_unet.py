"""ADM / EDM U-Net ("DhariwalUNet") on NHWC tensors (port of
m_cedm_tpu/models/adm_unet.py).

The forward is the JAX package's fused, stats-chained form (`use_chain`,
adm_unet.py:571-619, with the decoder concat materialized): every conv runs
through K2/K3 with the GroupNorm + SiLU in its prologue and the block tail in
its epilogue, and each kernel hands the channel sums of its output to the
next norm, so no separate statistics pass runs where a producer emitted them.
Per block:

  plain  K2(x; chained stats, emit) -> K2(h; FiLM, chained, + skip, emit)
  down   K1(x) -> 2x2 mean pool -> K2 linear(emit) -> K2(h; + pool(x) [1x1])
  up     K3(x; emit) -> K2(h; + upsample(x or skip(x)))
  attn   GroupNorm -> qkv matmul -> K4 -> proj matmul + x (no stats out)

The same chained forward runs with gradients: every fused operation is a
torch.autograd.Function whose backward is a kernel on the card, and the
(B, C) gamma/beta that `GroupNormSiLU.fold` builds carry their gradients on
to the norm weights, `affine` and the embedding MLP through autograd.

The cond encoder, dx and self-conditioning inputs are not used by the
flagship config and raise NotImplementedError (listed in ROADMAP.md).
Dropout is the identity at inference; training with dropout > 0 raises
(the flagship trains with 0.0, which the JAX paired train path asserts).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.layers import (Conv2d, GroupNormSiLU, Linear,
                                            adm_group_norm, adm_groups,
                                            downsample2x_mean)
from m_cedm_tpu_torch.ops.schedules import fourier_positional_embedding

INIT = dict(init_mode="kaiming_uniform", init_weight=3 ** -0.5, init_bias=3 ** -0.5)
INIT_ZERO = dict(init_mode="kaiming_uniform", init_weight=0.0, init_bias=0.0)

Stats = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdmUNetConfig:
    in_channels: int
    out_ch: int
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 1, 1)
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 128
    dropout: float = 0.0
    cond_channels: int = 0
    cat_cond: bool = False
    self_cond: bool = False
    dx_cond: bool = False
    cat_dx: bool = False
    label_dim: int = 0
    augment_dim: int = 0

    @staticmethod
    def from_hparams(hparams) -> "AdmUNetConfig":
        m = hparams["model"]
        return AdmUNetConfig(
            in_channels=m["in_channels"], out_ch=m["out_ch"], ch=m["ch"],
            ch_mult=tuple(m["ch_mult"]), num_res_blocks=m["num_res_blocks"],
            attn_resolutions=tuple(m["attn_resolutions"]),
            resolution=m["resolution"], dropout=m.get("dropout", 0.0),
            cond_channels=m.get("cond_channels", 0),
            cat_cond=m.get("cat_cond", False), self_cond=m.get("self_cond", False),
            dx_cond=m.get("dx_cond", False), cat_dx=m.get("cat_dx", False),
            label_dim=m.get("label_dim", 0), augment_dim=m.get("augment_dim", 0))

    @property
    def total_in_channels(self) -> int:
        c = self.in_channels * (2 if self.self_cond else 1)
        if self.cat_cond:
            c += self.cond_channels
        if self.dx_cond and self.cat_dx:
            c += self.in_channels
        return c


class UNetBlock(nn.Module):
    """Residual block with adaptive scale-shift conditioning and optional
    self-attention; `concat_skip` marks decoder blocks that take an encoder
    skip concatenated onto their input."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 concat_skip: bool = False, channels_per_head: int = 64,
                 eps: float = 1e-5):
        super().__init__()
        c = out_channels
        self.up, self.down, self.concat_skip, self.eps = up, down, concat_skip, eps
        self.num_heads = c // channels_per_head if attention else 0
        self.norm0 = GroupNormSiLU(in_channels, adm_groups(in_channels), eps)
        self.conv0 = Conv2d(in_channels, c, 3, **INIT)
        self.affine = Linear(emb_channels, 2 * c, **INIT)
        self.norm1 = GroupNormSiLU(c, adm_groups(c), eps)
        self.conv1 = Conv2d(c, c, 3, **INIT_ZERO)
        self.skip = Conv2d(in_channels, c, 1, **INIT) if c != in_channels else None
        if self.num_heads:
            self.attn_norm = adm_group_norm(c, eps)
            self.qkv = Conv2d(c, 3 * c, 1, **INIT)
            self.proj = Conv2d(c, c, 1, **INIT_ZERO)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, in_stats: Optional[Stats],
                ops: Ops) -> Tuple[torch.Tensor, Optional[Stats]]:
        b, c_in = x.shape[0], x.shape[-1]
        g_in = adm_groups(c_in)
        c = self.conv1.weight.shape[-1]
        g0, b0 = self.norm0.fold(b)
        conv0, conv1 = self.conv0, self.conv1
        skw = self.skip.weight if self.skip is not None else None
        skb = self.skip.bias if self.skip is not None else None
        if self.down:
            y = self.norm0(x, ops, stats=in_stats)
            h, h_stats = ops.gn_silu_conv(downsample2x_mean(y), None, None,
                                          conv0.weight, conv0.bias,
                                          emit_stats=True)
            tail = dict(residual=downsample2x_mean(x), skip_w=skw, skip_b=skb)
        elif self.up:
            h, h_stats = ops.gn_silu_up_conv(x, g0, b0, conv0.weight, conv0.bias,
                                             g_in, self.eps, stats=in_stats,
                                             emit_stats=True)
            # a 1x1 skip commutes with nearest upsampling: project at low res
            res_lo = self.skip(x) if self.skip is not None else x
            tail = dict(residual=res_lo, res_up=True)
        else:
            h, h_stats = ops.gn_silu_conv(x, g0, b0, conv0.weight, conv0.bias,
                                          g_in, self.eps, stats=in_stats,
                                          emit_stats=True)
            tail = dict(residual=x, skip_w=skw, skip_b=skb)
        scale, shift = self.affine(emb).chunk(2, dim=-1)
        g1, b1 = self.norm1.fold(b, scale, shift)
        # emitted stats are only valid when nothing transforms the output
        emit = not self.num_heads
        out = ops.gn_silu_conv(h, g1, b1, conv1.weight, conv1.bias, adm_groups(c),
                               self.eps, stats=h_stats, emit_stats=emit, **tail)
        if emit:
            return out
        return self._attention(out, ops), None

    def _attention(self, x: torch.Tensor, ops: Ops) -> torch.Tensor:
        b, hh, ww, c = x.shape
        heads, length = self.num_heads, hh * ww
        y = self.attn_norm(x).reshape(b, length, c)
        qkv = self.qkv(y)  # (B, L, 3c)

        def split(t):  # (B, L, c) -> (B * heads, L, d)
            return t.reshape(b, length, heads, -1).transpose(1, 2).reshape(
                b * heads, length, -1).contiguous()

        q, k, v = (split(t) for t in qkv.chunk(3, dim=-1))
        a = ops.attention(q, k, v)  # fp32 softmax attention, K4
        a = a.reshape(b, heads, length, -1).transpose(1, 2).reshape(b, hh, ww, c)
        return self.proj(a) + x


class AdmUNet(nn.Module):
    """The full ADM U-Net; input and output are NHWC (B, H, W, C).

    `ops` selects the fused operations: DEVICE_OPS (kernels on the card,
    plain versions on the CPU) or PLAIN_OPS (plain everywhere: the reference
    the kernel path is held against on the card). `calls` counts forwards."""

    def __init__(self, cfg: AdmUNetConfig, ops: Ops = DEVICE_OPS):
        super().__init__()
        if cfg.self_cond or cfg.dx_cond or cfg.label_dim or cfg.augment_dim or (
                cfg.cond_channels > 0 and not cfg.cat_cond):
            raise NotImplementedError(
                "self-cond, dx, label, augment and cond-encoder inputs of the "
                "ADM U-Net are not ported yet (see ROADMAP.md)")
        self.cfg, self.ops, self.calls = cfg, ops, 0
        ch = cfg.ch
        self.map_layer0 = Linear(ch, ch, **INIT)
        self.map_layer1 = Linear(ch, ch, **INIT)
        feat = ch * cfg.ch_mult[0]
        self.conv_in = Conv2d(cfg.total_in_channels, feat, 3, **INIT)

        def add(name, c_in, c_out, **kw):
            self.add_module(name, UNetBlock(c_in, c_out, ch, **kw))
            self.order.append(name)
            return c_out

        self.order: List[str] = []
        skips = [feat]
        cout = feat
        for level, mult in enumerate(cfg.ch_mult):
            res = cfg.resolution >> level
            if level > 0:
                cout = add(f"enc_{res}x{res}_down", cout, cout, down=True)
                skips.append(cout)
            for idx in range(cfg.num_res_blocks):
                cout = add(f"enc_{res}x{res}_block{idx}", cout, ch * mult,
                           attention=res in cfg.attn_resolutions)
                skips.append(cout)
        for level, mult in reversed(list(enumerate(cfg.ch_mult))):
            res = cfg.resolution >> level
            if level == len(cfg.ch_mult) - 1:
                cout = add(f"dec_{res}x{res}_in0", cout, cout, attention=True)
                cout = add(f"dec_{res}x{res}_in1", cout, cout)
            else:
                cout = add(f"dec_{res}x{res}_up", cout, cout, up=True)
            for idx in range(cfg.num_res_blocks + 1):
                cout = add(f"dec_{res}x{res}_block{idx}", cout + skips.pop(),
                           ch * mult, attention=res in cfg.attn_resolutions,
                           concat_skip=True)
        self.out_norm = GroupNormSiLU(cout, adm_groups(cout))
        self.out_conv = Conv2d(cout, cfg.out_ch, 3, **INIT_ZERO)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """ADM init of every parameter, drawn in module order from `generator`."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, ops = self.cfg, self.ops
        if self.training and cfg.dropout > 0:
            raise NotImplementedError("training with dropout > 0 is not ported "
                                      "yet (see ROADMAP.md)")
        self.calls += 1
        emb = fourier_positional_embedding(noise_labels, cfg.ch)
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))
        if cfg.cat_cond and cfg.cond_channels > 0:
            if cond is None:
                cond = x.new_zeros(x.shape[:3] + (cfg.cond_channels,))
            x = torch.cat([cond, x], dim=-1)
        x, stats = ops.gn_silu_conv(x.contiguous(), None, None,
                                    self.conv_in.weight, self.conv_in.bias,
                                    emit_stats=True)
        skips = [(x, stats)]
        for name in self.order:
            blk = getattr(self, name)
            if blk.concat_skip:
                skip, skip_stats = skips.pop()
                x = torch.cat([x, skip], dim=-1)
                # channel stats of a concat are the concat of the halves'
                stats = (None if stats is None or skip_stats is None else
                         (torch.cat([stats[0], skip_stats[0]], -1),
                          torch.cat([stats[1], skip_stats[1]], -1)))
            x, stats = blk(x, emb, stats, ops)
            if name.startswith("enc_"):
                skips.append((x, stats))
        y = self.out_norm(x, ops, stats=stats)
        return ops.gn_silu_conv(y, None, None, self.out_conv.weight,
                                self.out_conv.bias)
