"""Checkpoints of a whole TaskState, and resume (port of
m_cedm_tpu/train/checkpoint.py on torch.save / torch.load).

Layout: `<run_dir>/checkpoints/<step>/state.pt`, one directory per step,
the most recent max(save_top_k + 1, 2) kept. A checkpoint holds the params,
the EMA params, the optimizer state with its counts, the step, the frozen
constants and both normalizers: dicts of tensors and ints only, so it loads
with `weights_only=True`. A save is written under a temporary name and
renamed into place, so a directory that exists is complete.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

import torch

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.tasks.base import TaskState
from m_cedm_tpu_torch.utils import get_logger, is_main_process

log = get_logger(__name__)

STATE_FILE = "state.pt"


def _normalizer_dict(n: Normalizer) -> dict:
    return {"subtract": n.subtract, "divide": n.divide}


def state_to_dict(state: TaskState) -> dict:
    """The checkpoint's content: a TaskState as nested dicts of tensors."""
    return {"params": state.params, "ema_params": state.ema_params,
            "opt_state": state.opt_state, "step": int(state.step),
            "constants": state.constants,
            "normalizer_input": _normalizer_dict(state.normalizer_input),
            "normalizer_target": _normalizer_dict(state.normalizer_target)}


def state_from_dict(d: dict) -> TaskState:
    return TaskState(params=d["params"], ema_params=d["ema_params"],
                     normalizer_input=Normalizer(**d["normalizer_input"]),
                     normalizer_target=Normalizer(**d["normalizer_target"]),
                     opt_state=d["opt_state"], step=int(d["step"]),
                     constants=d["constants"])


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitor: Optional[str] = None,
                 mode: str = "min", save_top_k: int = 1):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max(save_top_k + 1, 2)
        self.best_value: Optional[float] = None
        self.best_step: Optional[int] = None
        if is_main_process():
            os.makedirs(self.ckpt_dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(name) for name in os.listdir(self.ckpt_dir)
                      if re.fullmatch(r"\d+", name)
                      and os.path.isfile(os.path.join(self.ckpt_dir, name, STATE_FILE)))

    def save(self, step: int, state: TaskState, metrics: Optional[dict] = None):
        if is_main_process():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(state_to_dict(state), os.path.join(tmp, STATE_FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))
        if self.monitor and metrics and self.monitor in metrics:
            value = float(metrics[self.monitor])
            better = (self.best_value is None
                      or (value < self.best_value if self.mode == "min"
                          else value > self.best_value))
            if better:
                self.best_value = value
                self.best_step = step

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: TaskState, step: Optional[int] = None
                ) -> Optional[TaskState]:
        """The checkpoint at `step` (default the latest) on the device of
        `target`, an initialized state of the same task; None if there is
        no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        device = next(iter(target.params.values())).device
        d = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                       map_location=device, weights_only=True)
        if set(d["params"]) != set(target.params):
            raise ValueError(f"checkpoint at step {step} in {self.ckpt_dir} "
                             f"holds other parameters than the task's")
        log.info(f"Restored checkpoint at step {step} from {self.ckpt_dir}")
        return state_from_dict(d)


@register("m_cedm_tpu.train.checkpoint.CheckpointManager")
def _build_checkpoint_manager(dirpath: str = "checkpoints/",
                              monitor: Optional[str] = None, mode: str = "min",
                              save_top_k: int = 1, **_lightning_keys):
    """The callbacks' `model_checkpoint` node (save_last, filename, verbose
    and the like are Lightning's and do not apply)."""
    return CheckpointManager(dirpath, monitor=monitor, mode=mode,
                             save_top_k=save_top_k)


def resolve_ckpt_dir(ckpt_path: Optional[str]) -> Optional[str]:
    """Accept a run directory (appends checkpoints/) or a checkpoint dir."""
    if ckpt_path is None:
        return None
    sub = os.path.join(ckpt_path, "checkpoints")
    if os.path.isdir(sub):
        return sub
    return ckpt_path
