"""Fourier Neural Operator networks (port of m_cedm_tpu/models/fno.py), NHWC.

  SpectralConv2d  truncated two-corner complex mode mix over the (H, W) axes
  Fno2d           time-as-channels stepper with dx / dy / dt scalar channels
  FnoState2d      space-time field with coordinate channels, padded trailing
                  X / T edges, optional instance norm; output (B, T, X, C)

Modules carry the flax names (fc0, fourier_{i}, conv_{i}, fc1, fc2), so
convert.py maps a JAX parameter tree onto them leaf by leaf. The complex
weights are four real parameters (w1_real, w1_imag, w2_real, w2_imag), so
every optimizer and checkpoint path stays real.

The spectral conv takes one of two routes, chosen by shape alone as the JAX
package's default does: the truncated DFT as matmuls (`spectral_conv_dft`)
when the two corners of kept rows do not overlap and no Nyquist column is
kept (2 m1 <= h and m2 <= w // 2, every shipped config), else
`torch.fft.rfft2` / `irfft2` (`spectral_conv_fft`). Both are plain PyTorch
in the tensor's dtype: the JAX package runs them as XLA matmuls and FFTs,
outside any Pallas kernel. On the card TF32 is off for them
(kernels._launch.fp32_reference_math). The activation is flax's nn.gelu,
the tanh approximation. bf16 compute is not ported (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from m_cedm_tpu_torch.kernels._launch import fp32_reference_math
from m_cedm_tpu_torch.models.layers import Conv2d, Linear, gelu


@functools.lru_cache(maxsize=None)
def _dft_mats(h: int, w: int, m1: int, m2: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
    """The truncated DFT / inverse-DFT matrices (cw, sw, ch, sh, icw, isw) of
    a spectrum cut to rows {0..m1-1, h-m1..h-1} and rfft columns {0..m2-1},
    built in float64 numpy exactly as the JAX package builds them, then cast
    to `dtype`: cw / sw (w, m2) the forward rfft over W, ch / sh (h, 2 m1)
    the forward DFT over H at the kept rows, icw / isw (m2, w) the inverse
    rfft with the hermitian doubling (2 - delta_l0) / w and Im(bin 0)
    dropped, as numpy's irfft drops it; the H inverse reuses ch / sh.
    Cached per shape, device and dtype: every caller gets the same tensors
    and only reads them."""
    kh = np.concatenate([np.arange(m1), np.arange(h - m1, h)])
    ang_h = 2.0 * np.pi * np.outer(np.arange(h), kh) / h
    ang_w = 2.0 * np.pi * np.outer(np.arange(w), np.arange(m2)) / w
    cw, sw = np.cos(ang_w), np.sin(ang_w)
    ch, sh = np.cos(ang_h), np.sin(ang_h)
    dbl = np.full((m2, 1), 2.0 / w)
    dbl[0, 0] = 1.0 / w
    icw = dbl * cw.T
    isw = -(dbl * sw.T)
    isw[0, :] = 0.0
    return tuple(torch.from_numpy(a).to(device, dtype) for a in (cw, sw, ch, sh, icw, isw))


def dft_route(h: int, w: int, m1: int, m2: int) -> bool:
    """The truncated DFT as matmuls where the corners fit and no Nyquist
    column is kept, as the JAX package's default chooses."""
    return 2 * m1 <= h and m2 <= w // 2


def _cmul(br, bi, wr, wi):
    """The complex contraction over input channels as four real einsums."""
    out_r = (torch.einsum("bxyi,ioxy->bxyo", br, wr)
             - torch.einsum("bxyi,ioxy->bxyo", bi, wi))
    out_i = (torch.einsum("bxyi,ioxy->bxyo", br, wi)
             + torch.einsum("bxyi,ioxy->bxyo", bi, wr))
    return out_r, out_i


def spectral_conv_dft(x, w1r, w1i, w2r, w2i) -> torch.Tensor:
    """The spectral conv of x (B, h, w, C) with the truncated DFT as
    matmuls, in the JAX package's order of contractions: W forward, H
    forward, the mode mix, H inverse (times 1 / h), W inverse."""
    b, h, w, _ = x.shape
    m1, m2 = w1r.shape[2:]
    cw, sw, ch, sh, icw, isw = _dft_mats(h, w, m1, m2, x.device, x.dtype)
    xw_r = torch.einsum("bhwc,wl->bhlc", x, cw)
    xw_i = -torch.einsum("bhwc,wl->bhlc", x, sw)
    y_r = (torch.einsum("bhlc,hk->bklc", xw_r, ch)
           + torch.einsum("bhlc,hk->bklc", xw_i, sh))
    y_i = (torch.einsum("bhlc,hk->bklc", xw_i, ch)
           - torch.einsum("bhlc,hk->bklc", xw_r, sh))
    top_r, top_i = _cmul(y_r[:, :m1], y_i[:, :m1], w1r, w1i)
    bot_r, bot_i = _cmul(y_r[:, m1:], y_i[:, m1:], w2r, w2i)
    o_r = torch.cat([top_r, bot_r], dim=1)
    o_i = torch.cat([top_i, bot_i], dim=1)
    z_r = (torch.einsum("bklc,hk->bhlc", o_r, ch)
           - torch.einsum("bklc,hk->bhlc", o_i, sh)) * (1.0 / h)
    z_i = (torch.einsum("bklc,hk->bhlc", o_i, ch)
           + torch.einsum("bklc,hk->bhlc", o_r, sh)) * (1.0 / h)
    return (torch.einsum("bhlc,lw->bhwc", z_r, icw)
            + torch.einsum("bhlc,lw->bhwc", z_i, isw))


def spectral_conv_fft(x, w1r, w1i, w2r, w2i) -> torch.Tensor:
    """The spectral conv of x (B, h, w, C) through rfft2 / irfft2: the two
    corners mixed, written into a zero spectrum (the bottom corner last),
    transformed back at (h, w)."""
    b, h, w, _ = x.shape
    m1, m2 = w1r.shape[2:]
    x_ft = torch.fft.rfft2(x, dim=(1, 2))
    top_r, top_i = _cmul(x_ft[:, :m1, :m2].real, x_ft[:, :m1, :m2].imag, w1r, w1i)
    bot_r, bot_i = _cmul(x_ft[:, -m1:, :m2].real, x_ft[:, -m1:, :m2].imag, w2r, w2i)
    spec = (b, h, w // 2 + 1, w1r.shape[1])
    out_r = x.new_zeros(spec)
    out_i = x.new_zeros(spec)
    out_r[:, :m1, :m2] = top_r
    out_r[:, h - m1:, :m2] = bot_r
    out_i[:, :m1, :m2] = top_i
    out_i[:, h - m1:, :m2] = bot_i
    return torch.fft.irfft2(torch.complex(out_r, out_i), s=(h, w), dim=(1, 2))


class SpectralConv2d(nn.Module):
    """2D Fourier layer over the (H, W) axes of an NHWC tensor."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int):
        super().__init__()
        shape = (in_channels, out_channels, modes1, modes2)
        for name in ("w1_real", "w1_imag", "w2_real", "w2_imag"):
            setattr(self, name, nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch.rand(cfloat) * scale: real and imaginary parts each uniform
        in [0, 1 / (in * out))."""
        in_ch, out_ch = self.w1_real.shape[:2]
        scale = 1.0 / (in_ch * out_ch)
        with torch.no_grad():
            for p in (self.w1_real, self.w1_imag, self.w2_real, self.w2_imag):
                p.copy_(torch.rand(p.shape, generator=generator) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            fp32_reference_math()
        _, h, w, _ = x.shape
        m1, m2 = self.w1_real.shape[2:]
        route = spectral_conv_dft if dft_route(h, w, m1, m2) else spectral_conv_fft
        return route(x, self.w1_real, self.w1_imag, self.w2_real, self.w2_imag)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.InstanceNorm2d's default over NHWC: per (sample, channel)
    over the spatial axes, biased variance, no affine parameters."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.var(x, dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


@dataclasses.dataclass(frozen=True)
class FnoConfig:
    modes_1: int = 12
    modes_2: int = 12
    width: int = 32
    num_layers: int = 5
    time_history: int = 128
    time_future: int = 0
    padding_t: int = 4
    padding_x: int = 0
    input_size: int = 1
    state_size: int = 1
    inst_norm: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype in ("bfloat16", "bf16"):
            raise NotImplementedError("bf16 compute is not ported yet (see ROADMAP.md)")

    @staticmethod
    def from_hparams(hp) -> "FnoConfig":
        return FnoConfig(**{f.name: hp.get(f.name, f.default)
                            for f in dataclasses.fields(FnoConfig)})


def _torch_linear(in_features: int, out_features: int) -> Linear:
    """The JAX package's TorchLinear: torch's default init."""
    return Linear(in_features, out_features, init_mode="torch_default", init_bias=1.0)


def _torch_conv1x1(channels: int) -> Conv2d:
    """The JAX package's TorchConv2d(kernel=1): torch's default init."""
    return Conv2d(channels, channels, 1, init_mode="torch_default", init_bias=1.0)


class _FnoLayers(nn.Module):
    """fc0, the spectral layers gelu(spectral(x) + conv_i(x)), and the fc1 /
    fc2 head, shared by both FNOs."""

    def __init__(self, cfg: FnoConfig, in_features: int, out_features: int):
        super().__init__()
        self.cfg = cfg
        self.fc0 = _torch_linear(in_features, cfg.width)
        for i in range(cfg.num_layers):
            self.add_module(f"fourier_{i}", SpectralConv2d(cfg.width, cfg.width,
                                                           cfg.modes_1, cfg.modes_2))
            self.add_module(f"conv_{i}", _torch_conv1x1(cfg.width))
        self.fc1 = _torch_linear(cfg.width, 128)
        self.fc2 = _torch_linear(128, out_features)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """A fresh draw of every parameter, with the JAX initializers'
        distributions (not their numbers)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    @staticmethod
    def _fp32(u: torch.Tensor) -> None:
        """On the card: TF32 off for every matmul of the model."""
        if u.is_cuda:
            fp32_reference_math()

    def _layers(self, x: torch.Tensor, inst_norm: bool) -> torch.Tensor:
        for i in range(self.cfg.num_layers):
            spectral = getattr(self, f"fourier_{i}")
            x1 = (instance_norm(spectral(instance_norm(x))) if inst_norm
                  else spectral(x))
            x = gelu(x1 + getattr(self, f"conv_{i}")(x))
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Fno2d(_FnoLayers):
    """Autoregressive time stepper: history frames as channels.

    u (B, H, W, time_history); dx, dy, dt (B,) scalars appended as constant
    channels. Output (B, H, W, time_future)."""

    def __init__(self, cfg: FnoConfig):
        super().__init__(cfg, cfg.time_history + 3, cfg.time_future)

    def forward(self, u, dx, dy, dt) -> torch.Tensor:
        self._fp32(u)
        b, h, w, _ = u.shape
        const = torch.stack([dx, dy, dt], dim=-1)[:, None, None, :]
        x = torch.cat([u, const.expand(b, h, w, 3).to(u.dtype)], dim=-1)
        return self._head(self._layers(self.fc0(x), False))


class FnoState2d(_FnoLayers):
    """State-reconstruction FNO over the full space-time field.

    u (B, X, T, C_in); dx, dt either (B,) spacings or None (then the
    linspace(0, 1) grids). Pads the trailing X / T edges before the
    spectral layers and crops them after. Output (B, T, X, state_size):
    time-major, as the reference returns it."""

    def __init__(self, cfg: FnoConfig):
        super().__init__(cfg, cfg.input_size + 2, cfg.state_size)

    def forward(self, u, dx=None, dt=None) -> torch.Tensor:
        self._fp32(u)
        cfg = self.cfg
        b, sx, st, _ = u.shape
        if dx is not None and dt is not None:
            gx, gt = (v.to(u.dtype)[:, None, None, None].expand(b, sx, st, 1)
                      for v in (dx, dt))
        else:
            lin = lambda n: torch.linspace(0, 1, n, dtype=u.dtype, device=u.device)
            gx = lin(sx)[None, :, None, None].expand(b, sx, st, 1)
            gt = lin(st)[None, None, :, None].expand(b, sx, st, 1)
        x = self.fc0(torch.cat([u, gx, gt], dim=-1))
        x = F.pad(x, (0, 0, 0, cfg.padding_t, 0, cfg.padding_x))
        x = self._layers(x, cfg.inst_norm)
        x = x[:, :x.shape[1] - cfg.padding_x, :x.shape[2] - cfg.padding_t]
        return self._head(x).transpose(1, 2)
