"""Shared task infrastructure for serving: the state holder, normalizer
construction and data transforms (port of the inference half of
m_cedm_tpu/tasks/base.py; the optimizer and EMA update come with the
training slice)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from m_cedm_tpu_torch.ops.normalizer import Normalizer


@dataclasses.dataclass
class TaskState:
    """Parameters (a state_dict), their EMA copy and the two normalizers."""
    params: Dict[str, torch.Tensor]
    ema_params: Optional[Dict[str, torch.Tensor]]
    normalizer_input: Normalizer
    normalizer_target: Normalizer


def normalizers_from_stats(stats, normalization: str,
                           device="cpu") -> Tuple[Normalizer, Normalizer]:
    """Input/target normalizers from datamodule stats (PlMcedm.setup)."""

    def squeeze(v):
        v = np.asarray(v, np.float32)
        return v.reshape(()) if v.size == 1 else v

    if normalization == "min_max":
        return (Normalizer.min_max(squeeze(stats["input_min"]),
                                   squeeze(stats["input_min_max"]), device),
                Normalizer.min_max(squeeze(stats["target_min"]),
                                   squeeze(stats["target_min_max"]), device))
    return (Normalizer.gauss(squeeze(stats["input_mean"]),
                             squeeze(stats["input_std"]), device),
            Normalizer.gauss(squeeze(stats["target_mean"]),
                             squeeze(stats["target_std"]), device))


class DataTransform:
    """normalize -> (dequantize) -> (rescale), and its inverse."""

    def __init__(self, data_cfg):
        self.normalization = data_cfg.get("normalization", "gauss")
        self.uniform_dequantization = data_cfg.get("uniform_dequantization", False)
        self.gaussian_dequantization = data_cfg.get("gaussian_dequantization", False)
        self.rescaled = data_cfg.get("rescaled", False)

    def forward(self, state: TaskState, h, u,
                generator: Optional[torch.Generator] = None):
        h = state.normalizer_input(h)
        u = state.normalizer_target(u)
        x = torch.cat([h, u], dim=-1)
        if self.uniform_dequantization:
            x = x / 256.0 * 255.0 + torch.rand(
                x.shape, generator=generator, device=x.device) / 256.0
        if self.gaussian_dequantization:
            x = x + torch.randn(x.shape, generator=generator, device=x.device) * 0.01
        if self.rescaled:
            x = 2 * x - 1.0
        return x

    def inverse(self, state: TaskState, h, u):
        if self.rescaled:
            h = (h + 1.0) / 2.0
            u = (u + 1.0) / 2.0
        if self.normalization == "min_max":
            h = torch.clamp(h, 0.0, 1.0)
            u = torch.clamp(u, 0.0, 1.0)
        return (state.normalizer_input(h, inverse=True),
                state.normalizer_target(u, inverse=True))


def ensemble(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """Stack `draw(i)` for i < n: the plain loop that replaces the JAX
    package's chunked, vmapped `chunked_ensemble`."""
    return torch.stack([draw(i) for i in range(n)], dim=0)
