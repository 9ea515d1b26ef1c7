"""Per-channel affine normalization (port of m_cedm_tpu/ops/normalizer.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """x_norm = (x - subtract) / divide; inverse: x = x_norm * divide + subtract.

    subtract/divide are float32 tensors that broadcast against the trailing
    (channel) axis.
    """
    subtract: torch.Tensor
    divide: torch.Tensor

    @staticmethod
    def _tensor(v, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    @staticmethod
    def identity(stats_shape=(), device="cpu"):
        return Normalizer(torch.zeros(stats_shape, device=device),
                          torch.ones(stats_shape, device=device))

    @staticmethod
    def gauss(mean, std, device="cpu"):
        return Normalizer(Normalizer._tensor(mean, device),
                          Normalizer._tensor(std, device))

    @staticmethod
    def min_max(minimum, value_range, device="cpu"):
        return Normalizer(Normalizer._tensor(minimum, device),
                          Normalizer._tensor(value_range, device))

    def __call__(self, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        if inverse:
            return x * self.divide + self.subtract
        return (x - self.subtract) / self.divide

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.subtract) / self.divide

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.divide + self.subtract

    @property
    def num_channels(self) -> int:
        return int(self.subtract.shape[-1]) if self.subtract.ndim > 0 else 1
