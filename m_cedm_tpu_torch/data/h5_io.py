"""HDF5 trajectory-store I/O (port of m_cedm_tpu/data/h5_io.py; h5py and
numpy only).

File layout (the reference format):
    <seed>/data/input   (T, X, Ci)   observed variable (e.g. water height h)
    <seed>/data/target  (T, X, Ct)   unobserved variable (e.g. velocity u)
    <seed>/grid/x       (X,)
    <seed>/grid/t       (T,) or (T+1,)
    <seed>/const/<name> scalar simulation constants
  file attrs: inp_mean/std/min/max, tar_mean/std/min/max

The whole file is read once into host numpy; batches are array slices.
A missing h5py raises when a store is read or written, not at import.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

try:
    import h5py
except ImportError:
    h5py = None


@dataclasses.dataclass
class TrajectoryStore:
    """Fully-materialized dataset: stacked trajectories + grids + stats."""
    inputs: np.ndarray   # (N, T, X, Ci)
    targets: np.ndarray  # (N, T, X, Ct)
    x: np.ndarray        # (N, X)
    t: np.ndarray        # (N, T)
    consts: Dict[str, np.ndarray]  # name -> (N,)
    attrs: Dict[str, np.ndarray]

    def __len__(self):
        return self.inputs.shape[0]


def read_store(path: str, dtype=np.float32) -> TrajectoryStore:
    if h5py is None:
        raise ImportError("h5py is required to read trajectory stores")
    with h5py.File(path, "r") as f:
        inputs, targets, xs, ts = [], [], [], []
        consts: Dict[str, list] = {}
        for k in sorted(f.keys()):
            g = f[k]
            inputs.append(np.asarray(g["data"]["input"], dtype=dtype))
            targets.append(np.asarray(g["data"]["target"], dtype=dtype))
            xs.append(np.asarray(g["grid"]["x"], dtype=dtype))
            t = np.asarray(g["grid"]["t"], dtype=dtype)
            if len(t) > inputs[-1].shape[0]:
                t = t[:-1]  # some simulators store one extra step
            ts.append(t)
            if "const" in g:
                for cname in g["const"]:
                    consts.setdefault(cname, []).append(
                        np.asarray(g["const"][cname], dtype=dtype).reshape(-1)[0])
        attrs = {k: np.asarray(v, dtype=dtype) for k, v in f.attrs.items()}
    return TrajectoryStore(
        inputs=np.stack(inputs),
        targets=np.stack(targets),
        x=np.stack(xs),
        t=np.stack(ts),
        consts={k: np.asarray(v, dtype=dtype) for k, v in consts.items()},
        attrs=attrs,
    )


def write_store(path: str, inputs: np.ndarray, targets: np.ndarray,
                x: np.ndarray, t: np.ndarray,
                consts: Optional[Dict[str, np.ndarray]] = None,
                with_stats: bool = True, seed_offset: int = 0) -> None:
    """Write the reference h5 layout: one group per trajectory, and the
    scalar statistics of inputs and targets as file attributes."""
    if h5py is None:
        raise ImportError("h5py is required to write trajectory stores")
    with h5py.File(path, "w") as f:
        for i in range(inputs.shape[0]):
            g = f.create_group(f"{seed_offset + i:04d}")
            d = g.create_group("data")
            d.create_dataset("input", data=inputs[i])
            d.create_dataset("target", data=targets[i])
            gr = g.create_group("grid")
            gr.create_dataset("x", data=x[i] if x.ndim == 2 else x)
            gr.create_dataset("t", data=t[i] if t.ndim == 2 else t)
            if consts:
                c = g.create_group("const")
                for name, vals in consts.items():
                    c.create_dataset(name, data=np.asarray([vals[i]]))
        if with_stats:
            f.attrs.update(store_stats(inputs, targets))


def store_stats(inputs: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    """The file attributes write_store records: mean, std, min and max of
    the inputs (inp_*) and of the targets (tar_*)."""
    stats = {}
    for prefix, arr in (("inp", inputs), ("tar", targets)):
        stats[f"{prefix}_mean"] = float(arr.mean())
        stats[f"{prefix}_std"] = float(arr.std())
        stats[f"{prefix}_min"] = float(arr.min())
        stats[f"{prefix}_max"] = float(arr.max())
    return stats


def stats_from_attrs(attrs: Dict[str, np.ndarray]):
    """(mean_std, min_max) tuples from file attrs, reference order."""
    mean_std = [attrs["inp_mean"], attrs["inp_std"], attrs["tar_mean"], attrs["tar_std"]]
    min_max = [attrs["inp_min"], attrs["inp_max"], attrs["tar_min"], attrs["tar_max"]]
    return mean_std, min_max


def stats_from_data(inputs: np.ndarray, targets: np.ndarray):
    """Per-(t, x)-location stats across the trajectory axis, as the reference
    computes when const_norm_stats=False."""
    inp = inputs.squeeze(-1) if inputs.shape[-1] == 1 else inputs
    tar = targets.squeeze(-1) if targets.shape[-1] == 1 else targets
    mean_std = [inp.mean(0), inp.std(0, ddof=1), tar.mean(0), tar.std(0, ddof=1)]
    min_max = [inp.min(0), inp.max(0), tar.min(0), tar.max(0)]
    return mean_std, min_max
