"""Task registry of the port: config `_target_` names -> task builders.

The port keeps its own registry (the JAX package's `config._REGISTRY` is
filled by JAX modules under the same names)."""
from __future__ import annotations

from typing import Callable, Dict

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.tasks.base import TaskState
from m_cedm_tpu_torch.tasks.diffusion import DiffusionTaskBase, McedmTask

MCEDM_TARGET = "m_cedm_tpu.tasks.McedmTask"

_REGISTRY: Dict[str, Callable] = {
    MCEDM_TARGET: McedmTask,
    "models.mcedm.PlMcedm": McedmTask,
}


def build_task(hparams, device, target: str = MCEDM_TARGET,
               ops: Ops = DEVICE_OPS) -> DiffusionTaskBase:
    """The task a model config's `_target_` names, built from its `hparams`
    on `device`. `ops=PLAIN_OPS` runs every fused operation as its plain
    PyTorch version (the reference path)."""
    if target not in _REGISTRY:
        raise NotImplementedError(f"task {target!r} is not ported yet (see ROADMAP.md)")
    return _REGISTRY[target](hparams, device, ops)


__all__ = ["build_task", "McedmTask", "TaskState", "MCEDM_TARGET"]
