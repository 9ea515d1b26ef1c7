"""Tokenize (t, x) grids for the OFormer (numpy copy of
m_cedm_tpu/data/oformer_data.py::PlOformerSwpDatamodule `_materialize` and
`_tokenize`, at down_factor 1; the HDF5 datamodule itself comes with the
data slice, ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _min_max(a: np.ndarray) -> np.ndarray:
    lo, hi = a.min(1, keepdims=True), a.max(1, keepdims=True)
    return (a - lo) / (hi - lo)


def tokenize_grid(inputs: np.ndarray, targets: np.ndarray, x: np.ndarray,
                  t: np.ndarray, stats: Mapping, *, norm_input: bool = True,
                  norm_target: bool = True, norm_x: bool = True,
                  norm_t: bool = True, add_t: bool = True,
                  flip_xy: bool = False) -> Dict[str, np.ndarray]:
    """Fields (n, T, X, C) on coordinates x (n, X) and t (n, T) -> the OFormer
    batch arrays: gauss-normalized inputs with the min-max-normalized t (when
    add_t) and x channels appended, x (n, 1, T*X, C_in), targets y (n, 1,
    T*X, C_out), node_type (n, T*X, 1) int32 (1 on the grid's boundary),
    offset positions pos (n, T*X, 2) = (t - t_min, x - x_min) and n_time (n,).
    `stats` holds input_mean, input_std, target_mean and target_std."""
    inp = np.array(inputs)
    target = np.array(targets)
    if norm_input:
        inp = (inp - stats["input_mean"]) / stats["input_std"]
    if norm_target:
        target = (target - stats["target_mean"]) / stats["target_std"]
    if flip_xy:
        inp, target = target, inp
    x_norm = _min_max(x) if norm_x else x
    t_norm = _min_max(t) if norm_t else t
    n, T, X = inp.shape[:3]
    coords = [np.broadcast_to(x_norm[:, None, :, None], (n, T, X, 1))]
    if add_t:
        coords.insert(0, np.broadcast_to(t_norm[:, :, None, None], (n, T, X, 1)))
    inp = np.concatenate([inp] + coords, axis=-1)

    tg, xg = np.meshgrid(t[0] - t[0].min(), x[0] - x[0].min(), indexing="ij")
    pos = np.stack([tg, xg], axis=-1).reshape(-1, 2).astype(np.float32)
    node_type = np.zeros((T, X), np.int32)
    node_type[[0, -1]] = 1
    node_type[:, [0, -1]] = 1
    node_type = node_type.reshape(-1, 1)
    return {
        "x": inp.reshape(n, 1, T * X, inp.shape[-1]).astype(np.float32),
        "y": target.reshape(n, 1, T * X, target.shape[-1]).astype(np.float32),
        "node_type": np.broadcast_to(node_type[None], (n,) + node_type.shape),
        "pos": np.broadcast_to(pos[None], (n,) + pos.shape),
        "n_time": np.full((n,), T, np.int32),
    }
