"""OFormer token datamodule: (t, x) grids flattened into coordinate clouds
(port of m_cedm_tpu/data/oformer_data.py, numpy only).

tokens = the flattened (t, x) grid; channels = [state, (t), x] with the
coordinates min-max normalized; node type 1 on the grid's boundary; offset
positions (t - t_min, x - x_min). The time-prediction datamodule splits the
grid at n_history: the history tokens are the input, the future tokens the
target, each with its own node types and positions.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.data.datamodule import HDF5Datamodule, _bilinear_resize

TOKEN_KEYS = ("x", "y", "node_type", "pos", "n_time")
TIMEPRED_KEYS = ("x", "y", "node_type_inp", "node_type_prop", "input_pos",
                 "prop_pos", "n_time")


def _min_max(a: np.ndarray) -> np.ndarray:
    lo, hi = a.min(1, keepdims=True), a.max(1, keepdims=True)
    return (a - lo) / (hi - lo)


def _with_coords(inp: np.ndarray, x: np.ndarray, t: np.ndarray, *, norm_x: bool,
                 norm_t: bool, add_t: bool) -> np.ndarray:
    """inp (n, T, X, C) with the (normalized) t (when add_t) and x channels
    appended."""
    x_norm = _min_max(x) if norm_x else x
    t_norm = _min_max(t) if norm_t else t
    n, T, X = inp.shape[:3]
    coords = [np.broadcast_to(x_norm[:, None, :, None], (n, T, X, 1))]
    if add_t:
        coords.insert(0, np.broadcast_to(t_norm[:, :, None, None], (n, T, X, 1)))
    return np.concatenate([inp] + coords, axis=-1)


def _grid(x: np.ndarray, t: np.ndarray):
    """Of the (T, X) grid of the first trajectory: the node types (T, X, 1),
    1 on the grid's boundary, and the offset positions (T, X, 2)."""
    tg, xg = np.meshgrid(t[0] - t[0].min(), x[0] - x[0].min(), indexing="ij")
    pos = np.stack([tg, xg], axis=-1).astype(np.float32)
    node_type = np.zeros(tg.shape + (1,), np.int32)
    node_type[[0, -1]] = 1
    node_type[:, [0, -1]] = 1
    return node_type, pos


def _per_item(a: np.ndarray, n: int) -> np.ndarray:
    """(..., C) -> (n, tokens, C), one read-only view for every item."""
    a = a.reshape(-1, a.shape[-1])
    return np.broadcast_to(a[None], (n,) + a.shape)


def _tokens(inp: np.ndarray, target: np.ndarray, x: np.ndarray, t: np.ndarray
            ) -> Dict[str, np.ndarray]:
    n, T, X = inp.shape[:3]
    node_type, pos = _grid(x, t)
    return {
        "x": inp.reshape(n, 1, T * X, inp.shape[-1]).astype(np.float32),
        "y": target.reshape(n, 1, T * X, target.shape[-1]).astype(np.float32),
        "node_type": _per_item(node_type, n),
        "pos": _per_item(pos, n),
        "n_time": np.full((n,), T, np.int32),
    }


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
    inp, target = _normalized(inputs, targets, stats, norm_input, norm_target, flip_xy)
    inp = _with_coords(inp, x, t, norm_x=norm_x, norm_t=norm_t, add_t=add_t)
    return _tokens(inp, target, x, t)


def _normalized(inputs, targets, stats: Mapping, norm_input: bool, norm_target: bool,
                flip_xy: bool):
    """Gauss-normalized copies of the fields, in the flip_xy role order (the
    datamodule's HDF5Datamodule._normalized)."""
    inp, target = np.array(inputs), np.array(targets)
    if norm_input:
        inp = (inp - stats["input_mean"]) / stats["input_std"]
    if norm_target:
        target = (target - stats["target_mean"]) / stats["target_std"]
    return (target, inp) if flip_xy else (inp, target)


class PlOformerSwpDatamodule(HDF5Datamodule):
    """Tokenized space-time datamodule for the OFormer reconstruction task.

    Batch: (x, y, node_type, pos, n_time) as `tokenize_grid` gives them."""

    keys = TOKEN_KEYS

    def __init__(self, *args, add_t: bool = False, train_2d: bool = True, **kw):
        self.add_t = add_t or train_2d
        self.train_2d = train_2d
        super().__init__(*args, **kw)

    def _materialize(self, store, down_factor):
        inp, target, x, t = self._normalized(store)
        inp = _with_coords(inp, x, t, norm_x=self.norm_x, norm_t=self.norm_t,
                           add_t=self.add_t)
        if down_factor > 1:
            each = 2 ** (down_factor - 1)
            T, X = inp.shape[1], inp.shape[2]
            inp = _bilinear_resize(inp[:, ::each, ::each], T, X)
            target = _bilinear_resize(target[:, ::each, ::each], T, X)
        return _tokens(inp, target, x, t)

    def _split_len(self, split):
        return self._prepare(split)["x"].shape[0]

    def _take(self, split, idx):
        arrays = self._prepare(split)
        return tuple(arrays[k][idx] for k in self.keys)

    def field_shape(self, split="train"):
        arrays = self._prepare(split)
        T = int(arrays["n_time"][0])
        ntok = arrays["x"].shape[2]
        return ((T, ntok // T, arrays["x"].shape[-1]),
                (T, ntok // T, arrays["y"].shape[-1]))


@register("datamodules.pl_oformer_datamodule.PlOformerSwpDatamodule",
          "m_cedm_tpu.data.PlOformerSwpDatamodule")
def _build_oformer_dm(**kw):
    return PlOformerSwpDatamodule(**kw)


def _time_pred_tokens(inp: np.ndarray, target: np.ndarray, x: np.ndarray,
                      t: np.ndarray, n_history: int, *, norm_x: bool, norm_t: bool,
                      add_t: bool) -> Dict[str, np.ndarray]:
    channels = inp.shape[-1] + target.shape[-1]
    full = _with_coords(np.concatenate([inp, target], axis=-1), x, t,
                        norm_x=norm_x, norm_t=norm_t, add_t=add_t)
    n, T, X = full.shape[:3]
    nh = n_history
    node_type, pos = _grid(x, t)
    return {
        "x": full[:, :nh].reshape(n, 1, nh * X, -1).astype(np.float32),
        "y": full[:, nh:, :, :channels].reshape(n, 1, (T - nh) * X, -1).astype(np.float32),
        "node_type_inp": _per_item(node_type[:nh], n),
        "node_type_prop": _per_item(node_type[nh:], n),
        "input_pos": _per_item(pos[:nh], n),
        "prop_pos": _per_item(pos[nh:], n),
        "n_time": np.full((n,), T - nh, np.int32),
    }


def tokenize_time_pred(inputs: np.ndarray, targets: np.ndarray, x: np.ndarray,
                       t: np.ndarray, stats: Mapping, n_history: int, *,
                       norm_input: bool = True, norm_target: bool = True,
                       norm_x: bool = True, norm_t: bool = True, add_t: bool = True,
                       flip_xy: bool = False) -> Dict[str, np.ndarray]:
    """Fields (n, T, X, C) -> the time-prediction batch arrays (TIMEPRED_KEYS),
    normalized as `tokenize_grid` normalizes them, with the min-max-normalized
    t (when add_t) and x channels appended; the first n_history steps' tokens
    are x (n, 1, n_history*X, C_in + C_out [+1] + 1), the rest's fields y
    (n, 1, (T - n_history)*X, C_in + C_out), each token set with its own
    node types and offset positions; n_time = T - n_history."""
    inp, target = _normalized(inputs, targets, stats, norm_input, norm_target, flip_xy)
    return _time_pred_tokens(inp, target, x, t, n_history, norm_x=norm_x,
                             norm_t=norm_t, add_t=add_t)


class PlOformerSwpTimePredDatamodule(PlOformerSwpDatamodule):
    """Future prediction: the first n_history steps' tokens are the input,
    the rest the target, with separate node types and positions.

    Batch: (x, y, node_type_inp, node_type_prop, input_pos, prop_pos,
    n_time) as `tokenize_time_pred` gives them. No down_factor, as in the JAX
    package."""

    keys = TIMEPRED_KEYS

    def __init__(self, *args, n_history: int = 64, **kw):
        self.n_history = n_history
        super().__init__(*args, **kw)

    def _materialize(self, store, down_factor):
        inp, target, x, t = self._normalized(store)
        return _time_pred_tokens(inp, target, x, t, self.n_history, norm_x=self.norm_x,
                                 norm_t=self.norm_t, add_t=self.add_t)


@register("datamodules.pl_oformer_datamodule.PlOformerSwpTimePredDatamodule",
          "m_cedm_tpu.data.PlOformerSwpTimePredDatamodule")
def _build_oformer_timepred_dm(**kw):
    return PlOformerSwpTimePredDatamodule(**kw)
