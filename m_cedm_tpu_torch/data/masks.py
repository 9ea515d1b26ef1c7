"""Observation masks (port of m_cedm_tpu/data/masks.py). mask = 1 -> missing
(to be recovered); mask = 0 -> observed.

The train-time samplers draw a batch of masks at once from a
torch.Generator, on the generator's device (the JAX package vmaps a per-item
sampler over split keys; the two give different numbers from one seed, so
tests pass masks in or compare distributions). The evaluation masks are
static, plain numpy: the same arrays on either framework.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def _uniform(generator: torch.Generator, b: int) -> torch.Tensor:
    return torch.rand((b,), generator=generator, device=generator.device)


def _randint(generator: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """One integer in [0, high) per item, for a per-item (b,) `high`."""
    u = _uniform(generator, high.shape[0])
    return torch.minimum((u * high).floor().long(), high - 1)


def _var_mask(choice, thresholds, t_dim, x_dim, inp_ch, tar_ch):
    """(b, T, X, C) block mask over the variable (channel) axis from a (b,)
    uniform draw: draw < t0 -> target missing; t0 <= draw < t1 -> input
    missing; else both present."""
    ch_is_input = torch.arange(inp_ch + tar_ch, device=choice.device) < inp_ch
    target_missing = (choice < thresholds[0])[:, None]
    input_missing = ((choice >= thresholds[0]) & (choice < thresholds[1]))[:, None]
    ch_missing = (target_missing & ~ch_is_input) | (input_missing & ch_is_input)
    return ch_missing[:, None, None, :].expand(-1, t_dim, x_dim, -1)


def _observed_until(t_max, t_dim, x_dim, inp_ch, tar_ch, stride=None):
    """(b, T, X, C): observed where t < t_max of the channel's variable (and,
    with `stride`, on the variable's 2^k sub-grid); t_max, stride (b, 2)."""
    dev = t_max.device
    t_idx = torch.arange(t_dim, device=dev)[None, :, None, None]
    x_idx = torch.arange(x_dim, device=dev)[None, None, :, None]
    var = (torch.arange(inp_ch + tar_ch, device=dev) >= inp_ch).long()
    tm = t_max[:, var][:, None, None, :]
    obs = t_idx < tm
    if stride is not None:
        each = stride[:, var][:, None, None, :]
        obs = obs & (t_idx % each == 0) & (x_idx % each == 0)
    return obs


def sample_train_mask_var(generator: torch.Generator, b: int, t_dim: int,
                          x_dim: int, inp_ch: int = 1, tar_ch: int = 1):
    """50/50: either the input block or the target block is missing
    (HDF5MaskDataset: rand > 0.5 -> input observed / target missing)."""
    mask = _var_mask(_uniform(generator, b), (0.5, 1.0), t_dim, x_dim, inp_ch,
                     tar_ch)
    return mask.float()


def sample_train_mask_time(generator: torch.Generator, b: int, t_dim: int,
                           x_dim: int, inp_ch: int = 1, tar_ch: int = 1):
    """40% target-missing / 40% input-missing / 20% both present, then every
    time after a per-variable cutoff t_max in [T/2, T] is missing too."""
    mask_var = _var_mask(_uniform(generator, b), (0.4, 0.8), t_dim, x_dim,
                         inp_ch, tar_ch)
    high = torch.full((b,), t_dim // 2 + 1, device=generator.device)
    t_max = torch.stack([t_dim // 2 + _randint(generator, high) for _ in range(2)], 1)
    return (mask_var | ~_observed_until(t_max, t_dim, x_dim, inp_ch, tar_ch)).float()


def sample_train_mask_sparse(generator: torch.Generator, b: int, t_dim: int,
                             x_dim: int, inp_ch: int = 1, tar_ch: int = 1):
    """33/33/33 variable masking, plus per-variable random 2^k observation
    strides (k in 0..2) and time cutoffs."""
    dev = generator.device
    mask_var = _var_mask(_uniform(generator, b), (1 / 3, 2 / 3), t_dim, x_dim,
                         inp_ch, tar_ch)
    three = torch.full((b,), 3, device=dev)
    res_rand = torch.stack([_randint(generator, three) + 1 for _ in range(2)], 1)
    each = 2 ** (res_rand - 1)
    res_cur = t_dim // each
    t_max = t_dim // 2 + res_rand * torch.stack(
        [_randint(generator, res_cur[:, i] // 2 + 1) for i in range(2)], 1)
    obs = _observed_until(t_max, t_dim, x_dim, inp_ch, tar_ch, stride=each)
    return (mask_var | ~obs).float()


TRAIN_MASK_SAMPLERS: Dict[str, Callable] = {
    "var": sample_train_mask_var,
    "time": sample_train_mask_time,
    "sparse": sample_train_mask_sparse,
}


# ---------------------------------------------------------------------------
# Evaluation mask tasks (static)
# ---------------------------------------------------------------------------

def _block(t_dim, x_dim, inp_missing, tar_missing, inp_ch, tar_ch):
    inp = np.full((t_dim, x_dim, inp_ch), float(inp_missing), np.float32)
    tar = np.full((t_dim, x_dim, tar_ch), float(tar_missing), np.float32)
    return np.concatenate([inp, tar], axis=-1)


def eval_masks_var(t_dim: int, x_dim: int, inp_ch: int = 1, tar_ch: int = 1
                   ) -> Dict[str, np.ndarray]:
    """{"u": input observed / target missing, "h": the inverse}."""
    return {
        "u": _block(t_dim, x_dim, 0, 1, inp_ch, tar_ch),
        "h": _block(t_dim, x_dim, 1, 0, inp_ch, tar_ch),
    }


def eval_masks_time(t_dim: int, x_dim: int, inp_ch: int = 1, tar_ch: int = 1,
                    add_time_masks: bool = False) -> Dict[str, np.ndarray]:
    """Variable-recovery tasks, or the half-time forecast set {hu, u, h}."""
    if not add_time_masks:
        return eval_masks_var(t_dim, x_dim, inp_ch, tar_ch)
    half = int(0.5 * t_dim)
    m_hu = _block(t_dim, x_dim, 0, 0, inp_ch, tar_ch)
    m_hu[half:] = 1.0
    m_u = _block(t_dim, x_dim, 0, 1, inp_ch, tar_ch)
    m_u[half:, :, :inp_ch] = 1.0
    m_h = _block(t_dim, x_dim, 1, 0, inp_ch, tar_ch)
    m_h[half:, :, inp_ch:] = 1.0
    return {"hu": m_hu, "u": m_u, "h": m_h}


def eval_masks_sparse(t_dim: int, x_dim: int, inp_ch: int = 1, tar_ch: int = 1,
                      add_res_masks: bool = False) -> Dict[str, np.ndarray]:
    """Variable-recovery tasks, or every-4th-point observation variants."""
    if not add_res_masks:
        return eval_masks_var(t_dim, x_dim, inp_ch, tar_ch)
    m_u = _block(t_dim, x_dim, 1, 1, inp_ch, tar_ch)
    m_u[::4, ::4, :inp_ch] = 0.0
    m_h = _block(t_dim, x_dim, 1, 1, inp_ch, tar_ch)
    m_h[::4, ::4, inp_ch:] = 0.0
    return {"u": m_u, "h": m_h}


def stack_eval_masks(masks: Dict[str, np.ndarray]
                     ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Dict -> (task names, (n_tasks, T, X, C) array)."""
    names = tuple(masks.keys())
    return names, np.stack([masks[n] for n in names], axis=0)
