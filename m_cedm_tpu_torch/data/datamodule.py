"""Datamodules: host-resident trajectory stores with the reference's
semantics (port of m_cedm_tpu/data/datamodule.py).

The whole dataset is materialized once into host numpy; batches are array
slices, with no worker processes. The mask datamodules name a
`train_mask_kind`; the task draws its training masks on the device
(data/masks.py). Evaluation masks are static numpy arrays.

Batch layout mirrors the reference item tuples:
  return_abs_coords & return_grid:  (inp, t_grid, x_grid, target)
  return_abs_coords:                (inp, x, t, target)
  neither:                          (inp, dx, dt, target)

`iter_split(split, rng)` shuffles with the caller's numpy Generator exactly
as the JAX package does, so both give the same batches from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from m_cedm_tpu_torch.config import DotDict, register
from m_cedm_tpu_torch.data import masks as mask_lib
from m_cedm_tpu_torch.data.h5_io import (TrajectoryStore, read_store,
                                         stats_from_attrs, stats_from_data)

EPS = 1e-6


def _resize_matrix(in_n: int, out_n: int) -> np.ndarray:
    """(out_n, in_n) weights of jax.image.resize's linear method without
    antialiasing: half-pixel centres, the triangle kernel, weights
    renormalised to sum 1 (which holds the edge value at the border), and
    samples beyond half a pixel outside the input zeroed."""
    if in_n == out_n:
        return np.eye(in_n)
    sample = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(in_n)[None, :]))
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_n - 0.5)
    return np.where(inside[:, None], w, 0.0)


def _bilinear_resize(arr: np.ndarray, out_t: int, out_x: int) -> np.ndarray:
    """Bilinear resize of (N, T, X, C) fields to (N, out_t, out_x, C), as
    jax.image.resize(method="bilinear", antialias=False) of each field."""
    wt = _resize_matrix(arr.shape[1], out_t)
    wx = _resize_matrix(arr.shape[2], out_x)
    out = np.einsum("ti,nijc,xj->ntxc", wt, arr.astype(np.float64), wx)
    return out.astype(np.float32)


def _linear_resize_1d(arr: np.ndarray, out_n: int) -> np.ndarray:
    """Linear resize of each row of (N, n) to (N, out_n)."""
    out = arr.astype(np.float64) @ _resize_matrix(arr.shape[1], out_n).T
    return out.astype(np.float32)


@dataclasses.dataclass
class SplitArrays:
    """One split fully prepared per the dataset flags: (N, T, X, C) fields."""
    inp: np.ndarray
    target: np.ndarray
    coord_a: np.ndarray  # t_grid / x / dx depending on flags
    coord_b: np.ndarray  # x_grid / t / dt

    def __len__(self):
        return self.inp.shape[0]

    def batch(self, idx: np.ndarray):
        ca = self.coord_a[idx] if self.coord_a.shape[0] == self.inp.shape[0] else self.coord_a
        cb = self.coord_b[idx] if self.coord_b.shape[0] == self.inp.shape[0] else self.coord_b
        return self.inp[idx], ca, cb, self.target[idx]


class HDF5Datamodule:
    """Base datamodule over the reference h5 layout."""

    train_mask_kind: Optional[str] = None  # set by the mask variants

    def __init__(
        self,
        name: str = "h5_datamodule",
        train_path: str = "data/train.h5",
        val_path: str = "data/val.h5",
        test_path: str = "data/test.h5",
        return_abs_coords: bool = False,
        return_grid: bool = False,
        norm_x: bool = False,
        norm_t: bool = False,
        norm_input: bool = True,
        norm_target: bool = True,
        flip_xy: bool = False,
        const_norm_stats: bool = True,
        use_theta: bool = False,
        use_tar_ic: bool = False,
        num_workers: int = 0,  # accepted for config parity; unused
        batch_size: int = 32,
        test_batch_size: Optional[int] = None,
        down_factor: int = 1,
        down_interp: bool = True,
        **_unused,
    ):
        self.name = name
        self.train_path = train_path
        self.val_path = val_path
        self.test_path = test_path
        self.return_abs_coords = return_abs_coords
        self.return_grid = return_grid
        self.norm_x = norm_x
        self.norm_t = norm_t
        self.norm_input = norm_input
        self.norm_target = norm_target
        self.flip_xy = flip_xy
        self.const_norm_stats = const_norm_stats
        self.use_theta = use_theta
        self.use_tar_ic = use_tar_ic
        self.batch_size = batch_size
        self.test_batch_size = test_batch_size if test_batch_size else batch_size
        self.down_factor = down_factor
        self.down_interp = down_interp

        self._splits: Dict[str, SplitArrays] = {}
        self._load_stats()

    # -- statistics --------------------------------------------------------

    def _load_stats(self):
        store = read_store(self.train_path)
        self._train_store = store
        if self.const_norm_stats and "inp_mean" in store.attrs:
            mean_std, min_max = stats_from_attrs(store.attrs)
        else:
            mean_std, min_max = stats_from_data(store.inputs, store.targets)
        input_mean, input_std, target_mean, target_std = [np.asarray(a, np.float32) for a in mean_std]
        input_min, input_max, target_min, target_max = [np.asarray(a, np.float32) for a in min_max]
        self.input_mean = input_mean
        self.input_std = input_std + EPS
        self.target_mean = target_mean
        self.target_std = target_std + EPS
        self.input_min = input_min
        self.input_min_max = input_max - input_min + EPS
        self.target_min = target_min
        self.target_min_max = target_max - target_min + EPS

    def get_norm_stats(self) -> DotDict:
        inp = ("norm_input", "input_mean", "input_std", "input_min", "input_min_max")
        tar = ("norm_target", "target_mean", "target_std", "target_min", "target_min_max")
        src_inp, src_tar = (tar, inp) if self.flip_xy else (inp, tar)
        return DotDict({**{k: getattr(self, s) for k, s in zip(inp, src_inp)},
                        **{k: getattr(self, s) for k, s in zip(tar, src_tar)}})

    # -- split preparation -------------------------------------------------

    def _prepare(self, split: str):
        if split in self._splits:
            return self._splits[split]
        path = {"train": self.train_path, "val": self.val_path,
                "test": self.test_path}[split]
        store = self._train_store if path == self.train_path else read_store(path)
        down = self.down_factor if split != "train" else 1
        arrays = self._materialize(store, down)
        self._splits[split] = arrays
        return arrays

    def _normalized(self, store: TrajectoryStore):
        """Copies of the store's fields, normalized per the flags and in the
        flip_xy role order, with its x and t rows."""
        inp = store.inputs.copy()
        target = store.targets.copy()
        if self.norm_input:
            inp = (inp - self.input_mean) / self.input_std
        if self.norm_target:
            target = (target - self.target_mean) / self.target_std
        if self.flip_xy:
            inp, target = target, inp
        return inp, target, store.x.copy(), store.t.copy()

    def _materialize(self, store: TrajectoryStore, down_factor: int) -> SplitArrays:
        inp, target, x, t = self._normalized(store)

        if self.use_theta:
            thetas = [np.broadcast_to(v[:, None, None, None],
                                      inp.shape[:3] + (1,)).astype(np.float32)
                      for v in store.consts.values()]
            inp = np.concatenate([inp] + thetas, axis=-1)

        if self.use_tar_ic:
            n_times = inp.shape[1]
            ic = np.repeat(target[:, 0:1], n_times, axis=1)
            inp = np.concatenate([inp, ic], axis=-1)

        if self.norm_x:
            xmn = x.min(axis=1, keepdims=True)
            xmx = x.max(axis=1, keepdims=True)
            x = (x - xmn) / (xmx - xmn)
        if self.norm_t:
            tmn = t.min(axis=1, keepdims=True)
            tmx = t.max(axis=1, keepdims=True)
            t = (t - tmn) / (tmx - tmn)

        if down_factor > 1:
            each = 2 ** (down_factor - 1)
            if self.down_interp:
                # subsample on a stride, then restore the resolution bilinearly
                T, X = inp.shape[1], inp.shape[2]
                inp = _bilinear_resize(inp[:, ::each, ::each], T, X)
                target = _bilinear_resize(target[:, ::each, ::each], T, X)
            else:
                T, X = inp.shape[1] // each, inp.shape[2] // each
                inp = _bilinear_resize(inp, T, X)
                target = _bilinear_resize(target, T, X)
                x = _linear_resize_1d(x, X)
                t = _linear_resize_1d(t, T)

        if self.return_abs_coords:
            if self.return_grid:
                t_grid = np.broadcast_to(t[:, :, None, None],
                                         t.shape + (x.shape[1], 1)).astype(np.float32)
                x_grid = np.broadcast_to(x[:, None, :, None],
                                         (x.shape[0], t.shape[1], x.shape[1], 1)).astype(np.float32)
                return SplitArrays(inp, target, np.ascontiguousarray(t_grid),
                                   np.ascontiguousarray(x_grid))
            return SplitArrays(inp, target, x, t)
        dx = np.diff(x, axis=1)[:, 0]
        dt = np.diff(t, axis=1)[:, 0]
        return SplitArrays(inp, target, dx, dt)

    # -- iteration ---------------------------------------------------------

    def _batch_size(self, split: str) -> int:
        return self.batch_size if split == "train" else self.test_batch_size

    def _split_len(self, split: str) -> int:
        return len(self._prepare(split))

    def _take(self, split: str, idx: np.ndarray) -> Tuple:
        return self._prepare(split).batch(idx)

    def num_batches(self, split: str) -> int:
        n, bs = self._split_len(split), self._batch_size(split)
        if split == "train":
            return n // bs if n >= bs else 1
        return (n + bs - 1) // bs

    def iter_split(self, split: str, rng: Optional[np.random.Generator] = None,
                   drop_last: Optional[bool] = None) -> Iterator[Tuple]:
        n, bs = self._split_len(split), self._batch_size(split)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        if drop_last is None:
            drop_last = split == "train" and n >= bs
        stop = (n // bs) * bs if drop_last else n
        for start in range(0, stop, bs):
            yield self._take(split, idx[start:start + bs])

    # -- shapes / eval masks ----------------------------------------------

    def field_shape(self, split: str = "train"):
        arrays = self._prepare(split)
        return arrays.inp.shape[1:], arrays.target.shape[1:]

    def channel_counts(self, split: str = "train"):
        (_, _, inp_ch), (_, _, tar_ch) = self.field_shape(split)
        return inp_ch, tar_ch

    def eval_masks(self, split: str = "test") -> Dict[str, np.ndarray]:
        raise NotImplementedError("base datamodule has no mask tasks")


@register("datamodules.pl_datamodule.HDF5Datamodule",
          "m_cedm_tpu.data.HDF5Datamodule")
def _build_h5(**kw):
    return HDF5Datamodule(**kw)


class HDF5MaskDatamodule(HDF5Datamodule):
    """50/50 variable-recovery masking (the mcedm flagship datamodule)."""
    train_mask_kind = "var"

    def eval_masks(self, split: str = "test") -> Dict[str, np.ndarray]:
        (t_dim, x_dim, inp_ch), (_, _, tar_ch) = self.field_shape(split)
        return mask_lib.eval_masks_var(t_dim, x_dim, inp_ch, tar_ch)


@register("datamodules.pl_datamodule.HDF5MaskDatamodule",
          "m_cedm_tpu.data.HDF5MaskDatamodule")
def _build_h5_mask(**kw):
    return HDF5MaskDatamodule(**kw)


class HDF5TimeMaskDatamodule(HDF5MaskDatamodule):
    """Mixed-conditional time masking (40/40/20 + time cutoffs)."""
    train_mask_kind = "time"

    def __init__(self, *args, add_time_masks: bool = False, **kw):
        super().__init__(*args, **kw)
        self.add_time_masks = add_time_masks

    def eval_masks(self, split: str = "test") -> Dict[str, np.ndarray]:
        (t_dim, x_dim, inp_ch), (_, _, tar_ch) = self.field_shape(split)
        return mask_lib.eval_masks_time(t_dim, x_dim, inp_ch, tar_ch,
                                        self.add_time_masks)


@register("datamodules.pl_datamodule.HDF5TimeMaskDatamodule",
          "m_cedm_tpu.data.HDF5TimeMaskDatamodule")
def _build_h5_time_mask(**kw):
    return HDF5TimeMaskDatamodule(**kw)


class HDF5SparseMaskDatamodule(HDF5MaskDatamodule):
    """Sparse-observation masking (random 2^k strides)."""
    train_mask_kind = "sparse"

    def __init__(self, *args, add_res_masks: bool = False, **kw):
        super().__init__(*args, **kw)
        self.add_res_masks = add_res_masks

    def eval_masks(self, split: str = "test") -> Dict[str, np.ndarray]:
        (t_dim, x_dim, inp_ch), (_, _, tar_ch) = self.field_shape(split)
        return mask_lib.eval_masks_sparse(t_dim, x_dim, inp_ch, tar_ch,
                                          self.add_res_masks)


@register("datamodules.pl_datamodule.HDF5SparseMaskDatamodule",
          "m_cedm_tpu.data.HDF5SparseMaskDatamodule")
def _build_h5_sparse_mask(**kw):
    return HDF5SparseMaskDatamodule(**kw)
