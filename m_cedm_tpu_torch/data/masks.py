"""Static evaluation observation masks (port of the eval half of
m_cedm_tpu/data/masks.py). mask = 1 -> missing (to be recovered);
mask = 0 -> observed. Plain numpy: the same arrays on either framework.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
