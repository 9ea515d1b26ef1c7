"""OFormer: Galerkin linear-attention operator transformer (port of
m_cedm_tpu/models/oformer.py, the configuration `oformer_t` reaches).

Modules carry the flax names, so convert.py maps a JAX parameter tree onto
them leaf by leaf (a Dense kernel (in, out) becomes `weight` (out, in); a
LayerNorm scale becomes `weight`; an embedding stays (num, features)). The
Gaussian Fourier matrix `B` is a buffer, the counterpart of the JAX
package's frozen 'constants' collection: it never reaches the optimizer.

Every linear attention runs its two products through `ops.kv_dots` and
`ops.apply_dots` (K5 and K6 on the card) with the heads folded into the
batch. The decoder's rollout takes the concatenated form [z | x_node | pos]
of its first dense layers, which the JAX package folds into loop-invariant
row blocks (MCEDM_OFORMER_INVFOLD); the two are value-equal.

Not reached by `oformer_t`, so not ported (ROADMAP.md): the Fourier
attention type, attention without RoPE, the padding-mask path, `not_assoc`,
`cat_pos`, LayerNorm inside the attention (`use_ln`), dropout other than
the decoder's, and bf16 compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m_cedm_tpu_torch.kernels import Ops
from m_cedm_tpu_torch.models.encoding import (apply_rotary_pos_emb_multi,
                                              rotary_freqs)
from m_cedm_tpu_torch.models.layers import Linear


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"OFormer {what} is not ported yet (see ROADMAP.md)")


def _gelu(x):  # flax nn.gelu: the tanh approximation
    return F.gelu(x, approximate="tanh")


def lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator]):
    """flax's default Dense init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0))
    u = torch.empty(shape).uniform_(lo, hi, generator=generator)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.erfinv(2 * u - 1) * math.sqrt(2) * std


def orthogonal(rows: int, cols: int, gain: float, generator):
    """A (rows, cols) matrix with orthonormal rows (rows <= cols) times gain,
    from the QR of a normal draw, as jax.nn.initializers.orthogonal."""
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return gain * (q.T if rows < cols else q)


class Dense(Linear):
    """flax nn.Dense: weight (out, in), lecun-normal init, zero bias."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(lecun_normal((out_f, in_f), in_f, generator))
            if self.bias is not None:
                self.bias.zero_()


class QkvDense(Dense):
    """Bias-free projection to `n_chunks` (q, k, v) blocks of heads * dim_head
    features, each computed from its own row block of the weight (the JAX
    package's ChunkedDense). Init `_qkv_init`: torch Linear's default uniform,
    with the `boosted` chunks replaced per head by an orthogonal block plus a
    diagonal, both of size `gain`."""

    def __init__(self, in_features: int, heads: int, dim_head: int, n_chunks: int,
                 boosted: Sequence[int], gain: float):
        super().__init__(in_features, heads * dim_head * n_chunks, use_bias=False)
        self.heads, self.dim_head, self.n_chunks = heads, dim_head, n_chunks
        self.boosted, self.gain = tuple(boosted), gain

    def reset_parameters(self, generator: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        bound = math.sqrt(6.0 / (6 * in_f))
        w = torch.empty(out_f, in_f).uniform_(-bound, bound, generator=generator)
        eye = torch.eye(self.dim_head, in_f)
        for chunk in self.boosted:
            for h in range(self.heads):
                row0 = (chunk * self.heads + h) * self.dim_head
                w[row0:row0 + self.dim_head] = (
                    orthogonal(self.dim_head, in_f, self.gain, generator) + self.gain * eye)
        with torch.no_grad():
            self.weight.copy_(w)

    def chunks(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.weight.shape[0] // self.n_chunks
        return tuple(F.linear(x, self.weight[i * c:(i + 1) * c])
                     for i in range(self.n_chunks))


class Embed(nn.Module):
    """flax nn.Embed: `embedding` (num, features), N(0, 1 / features) init."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        num, features = self.embedding.shape
        with torch.no_grad():
            self.embedding.copy_(torch.randn(num, features, generator=generator)
                                 / math.sqrt(features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.embedding)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: eps 1e-6 and the fast variance E[x^2] - E[x]^2,
    then (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def instance_norm_tokens(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine normalization of each token over its head-width axis: what
    the reference's InstanceNorm1d on (b*h, n, d) actually computes."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def linear_attn(q, k, v, denom, ops: Ops) -> torch.Tensor:
    """q (k^T v) / denom for (b, h, n, d) operands: heads folded into the
    batch, the two products through K5 and K6, 1/denom on the small (d, e)
    factor."""
    b, h, nq, d = q.shape
    fold = lambda t: t.reshape(b * h, t.shape[2], t.shape[3]).contiguous()
    dots = ops.kv_dots(fold(k), fold(v)) / denom
    return ops.apply_dots(fold(q), dots).reshape(b, h, nq, -1)


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _rope_freqs(pos, dim_head: int, axes: int, min_freq: float, scale: float):
    """Per spatial axis, phases (b, 1, n, dim_head / axes) for every head."""
    return [rotary_freqs(pos[:, :, i], dim_head // axes, min_freq, scale)[:, None]
            for i in range(axes)]


class GeGELUFeedForward(nn.Module):
    """FeedForward (use_relu False, dropout 0): Dense(2 hidden), gelu(first
    half) * second half, Dense(dim)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.Dense_0 = Dense(dim, 2 * hidden_dim)
        self.Dense_1 = Dense(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Dense_0(x)
        c = h.shape[-1] // 2
        return self.Dense_1(_gelu(h[..., :c]) * h[..., c:])


class LinearAttention(nn.Module):
    """Galerkin linear self-attention, q (k^T v) / n with instance-normed k
    and v, and RoPE on q and k."""

    def __init__(self, dim: int, heads: int, dim_head: int, ops: Ops,
                 scale: float = 1.0, relative_emb_dim: int = 2,
                 min_freq: float = 1 / 64):
        super().__init__()
        self.heads, self.dim_head, self.ops = heads, dim_head, ops
        self.scale, self.relative_emb_dim, self.min_freq = scale, relative_emb_dim, min_freq
        self.to_qkv = QkvDense(dim, heads, dim_head, 3, (0,), 1.0 / dim_head)
        self.to_out = (None if heads == 1 and dim_head == dim
                       else Dense(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, not_assoc: bool = False,
                padding_mask=None) -> torch.Tensor:
        if not_assoc:
            raise _not_ported("not_assoc attention")
        if padding_mask is not None:
            raise _not_ported("padding-mask attention")
        b, n, _ = x.shape
        q, k, v = (_heads_first(t, self.heads) for t in self.to_qkv.chunks(x))
        freqs = _rope_freqs(pos, self.dim_head, self.relative_emb_dim, self.min_freq,
                            self.scale)
        q = apply_rotary_pos_emb_multi(q, freqs)
        k = apply_rotary_pos_emb_multi(instance_norm_tokens(k), freqs)
        out = linear_attn(q, k, instance_norm_tokens(v), n, self.ops)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return out if self.to_out is None else self.to_out(out)


class CrossLinearAttention(nn.Module):
    """Galerkin cross attention with RoPE: queries from the coordinate
    features x, keys and values from z."""

    def __init__(self, dim: int, z_dim: int, heads: int, dim_head: int, ops: Ops,
                 scale: float, relative_emb_dim: int, min_freq: float):
        super().__init__()
        self.heads, self.dim_head, self.ops = heads, dim_head, ops
        self.scale, self.relative_emb_dim, self.min_freq = scale, relative_emb_dim, min_freq
        gain = 1.0 / dim_head
        self.to_q = QkvDense(dim, heads, dim_head, 1, (0,), gain)
        self.to_kv = QkvDense(z_dim, heads, dim_head, 2, (0, 1), gain)
        self.to_out = (None if heads == 1 and dim_head == dim
                       else Dense(heads * dim_head, dim))

    def forward(self, x, z, x_pos, z_pos) -> torch.Tensor:
        b, n1, _ = x.shape
        q = _heads_first(self.to_q(x), self.heads)
        k, v = (instance_norm_tokens(_heads_first(t, self.heads))
                for t in self.to_kv.chunks(z))
        args = (self.dim_head, self.relative_emb_dim, self.min_freq, self.scale)
        q = apply_rotary_pos_emb_multi(q, _rope_freqs(x_pos, *args))
        k = apply_rotary_pos_emb_multi(k, _rope_freqs(z_pos, *args))
        out = linear_attn(q, k, v, z.shape[1], self.ops).transpose(1, 2).reshape(b, n1, -1)
        return out if self.to_out is None else self.to_out(out)


class TransformerCatNoCls(nn.Module):
    """`depth` rounds of RoPE linear attention and a GeGELU feed-forward;
    with use_ln each sub-layer is x = LN(x); x = f(x) + x (the residual adds
    the normalized x, as the reference does)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 ops: Ops, use_ln: bool = False, scale: Sequence[float] = (16,),
                 relative_emb_dim: int = 2, min_freq: float = 1 / 64):
        super().__init__()
        scales = list(scale) * depth if len(scale) == 1 else list(scale)
        self.depth, self.use_ln = depth, use_ln
        for d in range(depth):
            self.add_module(f"attn_{d}", LinearAttention(
                dim, heads, dim_head, ops, scale=scales[d],
                relative_emb_dim=relative_emb_dim, min_freq=min_freq))
            self.add_module(f"ffn_{d}", GeGELUFeedForward(dim, mlp_dim))
            if use_ln:
                self.add_module(f"ln1_{d}", LayerNorm(dim))
                self.add_module(f"ln2_{d}", LayerNorm(dim))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        for d in range(self.depth):
            layer = lambda name: getattr(self, f"{name}_{d}")
            if self.use_ln:
                x = layer("ln1")(x)
            x = layer("attn")(x, pos) + x
            if self.use_ln:
                x = layer("ln2")(x)
            x = layer("ffn")(x) + x
        return x


@dataclasses.dataclass(frozen=True)
class OformerEncoderConfig:
    input_channels: int = 3
    time_window: int = 1
    in_emb_dim: int = 128
    out_channels: int = 128
    max_node_type: int = 2
    heads: int = 1
    depth: int = 4
    res: int = 128
    use_ln: bool = True
    emb_dropout: float = 0.0
    relative_emb_dim: int = 2

    @staticmethod
    def from_hparams(hp) -> "OformerEncoderConfig":
        names = {f.name for f in dataclasses.fields(OformerEncoderConfig)}
        return OformerEncoderConfig(**{k: v for k, v in dict(hp).items() if k in names})


@dataclasses.dataclass(frozen=True)
class OformerDecoderConfig:
    max_node_type: int = 2
    latent_channels: int = 128
    out_channels: int = 1
    res: int = 128
    scale: float = 2.0
    dropout: float = 0.1
    relative_emb_dim: int = 2

    @staticmethod
    def from_hparams(hp) -> "OformerDecoderConfig":
        names = {f.name for f in dataclasses.fields(OformerDecoderConfig)}
        return OformerDecoderConfig(**{k: v for k, v in dict(hp).items() if k in names})


class IrregSTEncoder(nn.Module):
    """Token encoder: dense time-window patching, node-type embedding and a
    Galerkin transformer stack."""

    def __init__(self, cfg: OformerEncoderConfig, ops: Ops):
        super().__init__()
        self.cfg = cfg
        w = cfg.in_emb_dim
        self.emb0 = Dense(cfg.time_window * cfg.input_channels, w, use_bias=False)
        self.emb1 = Dense(w, w, use_bias=False)
        self.node_embedding = Embed(cfg.max_node_type, w)
        self.combine_embedding = Dense(2 * w, w, use_bias=False)
        if cfg.depth > 4:
            scales = [32, 16, 8, 8] + [1] * (cfg.depth - 4)
        else:
            scales = [32] + [16] * (cfg.depth - 2) + [1]
        self.s_transformer = TransformerCatNoCls(
            w, cfg.depth, cfg.heads, w, w, ops, cfg.use_ln,
            scale=tuple(scales), relative_emb_dim=cfg.relative_emb_dim,
            min_freq=1 / cfg.res)
        self.ln = LayerNorm(w)
        self.out0 = Dense(w, w, use_bias=False)
        self.out1 = Dense(w, cfg.out_channels, use_bias=False)

    def forward(self, x, node_type, input_pos, train: bool = False) -> torch.Tensor:
        if train and self.cfg.emb_dropout > 0:
            raise _not_ported("embedding dropout")
        b, t, n, c = x.shape
        tw = self.cfg.time_window
        # a (tw, 1) conv with stride (tw, 1) over [t, n] is a dense layer over
        # tw-grouped frames
        x = x.transpose(1, 2).reshape(b, n, t // tw, tw * c)
        x = x[:, :, 0] if t // tw == 1 else x.reshape(b, n * (t // tw), tw * c)
        x = self.emb1(_gelu(self.emb0(x)))
        x_node = self.node_embedding(node_type[..., 0])
        x = self.combine_embedding(torch.cat([x, x_node], dim=-1))
        x = self.ln(self.s_transformer(x, input_pos) + x)
        return self.out1(torch.relu(self.out0(x)))


class GaussianFourierFeatures(nn.Module):
    """[sin | cos](2 pi x @ B) with B a frozen (in, mapping) buffer, drawn
    N(0, scale^2)."""

    def __init__(self, num_input_channels: int, mapping_size: int, scale: float):
        super().__init__()
        self.scale = scale
        self.register_buffer("B", torch.empty(num_input_channels, mapping_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.B.copy_(torch.randn(self.B.shape, generator=generator) * self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = 2 * math.pi * (x @ self.B)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class CrossFormer(nn.Module):
    """Cross attention with a residual, then a GeGELU feed-forward with a
    residual (use_ln False)."""

    def __init__(self, dim: int, z_dim: int, heads: int, dim_head: int, mlp_dim: int,
                 ops: Ops, scale: float, relative_emb_dim: int, min_freq: float):
        super().__init__()
        self.cross_attn = CrossLinearAttention(dim, z_dim, heads, dim_head, ops, scale,
                                               relative_emb_dim, min_freq)
        self.ffn = GeGELUFeedForward(dim, mlp_dim)

    def forward(self, x, z, x_pos, z_pos) -> torch.Tensor:
        x = self.cross_attn(x, z, x_pos, z_pos) + x
        return self.ffn(x) + x


class IrregSTDecoder(nn.Module):
    """Coordinate-query decoder: Fourier coordinate features, cross attention
    into the latent tokens, a mix layer, then `forward_steps` rounds of
    propagate and decode."""

    def __init__(self, cfg: OformerDecoderConfig, z_dim: int, ops: Ops):
        super().__init__()
        self.cfg = cfg
        lc, sd = cfg.latent_channels, cfg.relative_emb_dim
        self.node_type_embedding = Embed(cfg.max_node_type, lc)
        self.fourier_features = GaussianFourierFeatures(sd, lc // 2, cfg.scale)
        self.coord_proj0 = Dense(lc, lc, use_bias=False)
        self.coord_proj1 = Dense(lc, lc, use_bias=False)
        self.combine_layer = Dense(2 * lc, lc, use_bias=False)
        self.decoding_transformer = CrossFormer(lc, z_dim, 4, lc, lc, ops, 32.0, sd,
                                                1 / cfg.res)
        self.mix_layer = LinearAttention(lc, 1, lc, ops, scale=32.0,
                                         relative_emb_dim=sd, min_freq=1 / cfg.res)
        self.expand_layer = Dense(lc, 2 * lc, use_bias=False)
        self.prop_norm = LayerNorm(2 * lc)
        self.prop_mlp0 = Dense(2 * lc + lc + sd, 2 * lc, use_bias=False)
        for i in range(1, 4):
            self.add_module(f"prop_mlp{i}", Dense(2 * lc, 2 * lc, use_bias=False))
        self.out_norm = LayerNorm(2 * lc)
        self.to_out0 = Dense(2 * lc + lc, 2 * lc, use_bias=False)
        self.to_out1 = Dense(2 * lc, lc, use_bias=False)
        self.to_out2 = Dense(lc, cfg.out_channels)

    def forward(self, z, propagate_pos, prop_node_type, forward_steps: int, input_pos,
                dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """dropout_keep: the (B, N, z width) 0/1 mask of the decoder's one
        dropout site (rate cfg.dropout, train only); None = deterministic."""
        x_node = self.node_type_embedding(prop_node_type[..., 0])
        x = self.coord_proj1(_gelu(self.coord_proj0(self.fourier_features(propagate_pos))))
        x = self.combine_layer(torch.cat([x, x_node], dim=-1))
        if dropout_keep is not None:
            z = torch.where(dropout_keep.bool(), z / (1.0 - self.cfg.dropout), 0.0)
        z = self.decoding_transformer(x, z, propagate_pos, input_pos)
        z = self.mix_layer(z, propagate_pos) + z
        z = self.expand_layer(z)
        history = []
        for _ in range(forward_steps):
            h = self.prop_mlp0(torch.cat([self.prop_norm(z), x_node, propagate_pos], dim=-1))
            for i in range(1, 4):
                h = getattr(self, f"prop_mlp{i}")(_gelu(h))
            z = h + z
            h = self.to_out0(torch.cat([self.out_norm(z), x_node], dim=-1))
            history.append(self.to_out2(torch.relu(self.to_out1(torch.relu(h)))))
        return torch.stack(history, dim=1)


class OformerModel(nn.Module):
    """Encoder then decoder (m_cedm_tpu/tasks/oformer.py::OformerModel)."""

    def __init__(self, enc_cfg: OformerEncoderConfig, dec_cfg: OformerDecoderConfig,
                 ops: Ops):
        super().__init__()
        self.encoder = IrregSTEncoder(enc_cfg, ops)
        self.decoder = IrregSTDecoder(dec_cfg, enc_cfg.out_channels, ops)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """A fresh draw of every parameter and of B, with the JAX
        initializers' distributions (not their numbers)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x, node_type_inp, node_type_prop, input_pos, prop_pos,
                forward_steps: int, dropout_keep: Optional[torch.Tensor] = None):
        z = self.encoder(x, node_type_inp, input_pos, train=dropout_keep is not None)
        return self.decoder(z, prop_pos, node_type_prop, forward_steps, input_pos,
                            dropout_keep)
