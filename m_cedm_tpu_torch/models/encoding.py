"""Rotary position embeddings (port of m_cedm_tpu/models/encoding.py).

The phases reach about 2e4 rad at the OFormer's scales (offset positions up
to about 5, times scale / min_freq = 32 * 128), so `inv_freq` is computed in
fp32 exactly as the JAX package writes it, and the coordinates are scaled
before they meet it: a float64 `inv_freq` rounded to fp32 differs in some
entries, which moves sin and cos by about 1e-3 at such phases.
"""
from __future__ import annotations

from typing import List

import torch


def rotary_freqs(coordinates: torch.Tensor, dim: int, min_freq: float = 1 / 64,
                 scale: float = 1.0) -> torch.Tensor:
    """coordinates (..., n) -> phases (..., n, dim): inv_freq = 10000^(-2i/dim),
    the coordinates rescaled by scale / min_freq."""
    arange = torch.arange(0, dim, 2, dtype=torch.float32, device=coordinates.device)
    inv_freq = 1.0 / (10000 ** (arange / dim))
    t = coordinates * (scale / min_freq)
    freqs = t[..., None] * inv_freq
    return torch.cat([freqs, freqs], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rotary_pos_emb_1d(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    return t * torch.cos(freqs) + rotate_half(t) * torch.sin(freqs)


def apply_rotary_pos_emb_multi(t: torch.Tensor, freqs: List[torch.Tensor]) -> torch.Tensor:
    """Split the last axis of t (b, h, n, d) across the spatial axes and
    rotate each slice by its axis's phases (each broadcastable to
    (b, h, n, d_i)); the last slice takes the remainder."""
    space_dim = len(freqs)
    d1 = t.shape[-1] // space_dim
    parts = []
    for i, freq in enumerate(freqs):
        end = (i + 1) * d1 if i < space_dim - 1 else t.shape[-1]
        parts.append(apply_rotary_pos_emb_1d(t[..., i * d1:end], freq))
    return torch.cat(parts, dim=-1)
