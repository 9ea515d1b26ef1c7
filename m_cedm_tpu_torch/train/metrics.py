"""Metrics logging (port of m_cedm_tpu/train/metrics.py).

Per-epoch means are appended to `<out_dir>/metrics.jsonl`, the run's config
to `config.json`, both in the JAX package's format and with its metric keys;
they go to wandb too (offline) when that package is importable.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from m_cedm_tpu_torch.utils import get_logger, is_main_process

log = get_logger(__name__)


def _as_floats(values: list) -> list:
    """Python floats of scalars, tensors among them read back from their
    devices in one copy per device (one synchronisation, not one a value)."""
    out = list(values)
    by_device: Dict[torch.device, list] = defaultdict(list)
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device[v.device].append(i)
        else:
            out[i] = float(v)
    for device, idx in by_device.items():
        host = torch.stack([values[i].detach().reshape(()).float()
                            for i in idx]).cpu().tolist()
        for i, v in zip(idx, host):
            out[i] = v
    return out


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run",
                 use_wandb: bool = False, wandb_project: str = "gen_no"):
        self.out_dir = out_dir
        self.run_name = run_name
        self._epoch_acc: Dict[str, list] = defaultdict(list)
        self._jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self.summary: Dict[str, float] = {}
        self._wandb = None
        if use_wandb and is_main_process():
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         mode="offline")
            except ImportError:
                log.info("wandb not installed; logging to JSONL only")
        if is_main_process():
            os.makedirs(out_dir, exist_ok=True)

    def accumulate(self, metrics: Dict):
        """Keep the step's values as they come (device tensors): they are
        read back once an epoch, in flush_epoch, so the loop never waits for
        the device a step."""
        for k, v in metrics.items():
            self._epoch_acc[k].append(v)

    def flush_epoch(self, epoch: int, extra: Optional[Dict] = None) -> Dict[str, float]:
        keys = list(self._epoch_acc)
        flat = _as_floats([v for k in keys for v in self._epoch_acc[k]])
        means, at = {}, 0
        for k in keys:
            n = len(self._epoch_acc[k])
            means[k] = float(np.mean(flat[at:at + n]))
            at += n
        self._epoch_acc.clear()
        if extra:
            means.update({k: float(v) for k, v in extra.items()})
        self.summary.update(means)
        record = {"epoch": epoch, "time": time.time(), **means}
        if is_main_process():
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            if self._wandb is not None:
                self._wandb.log(means, step=epoch)
        return means

    def log_config(self, cfg: Dict):
        if is_main_process():
            with open(os.path.join(self.out_dir, "config.json"), "w") as f:
                json.dump(cfg, f, indent=2, default=str)
            if self._wandb is not None:
                self._wandb.config.update(cfg, allow_val_change=True)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
