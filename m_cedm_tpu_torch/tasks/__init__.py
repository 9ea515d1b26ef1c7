"""Task registry of the port: config `_target_` names -> task builders.

The port keeps its own registry (the JAX package's `config._REGISTRY` is
filled by JAX modules under the same names)."""
from __future__ import annotations

from typing import Callable, Dict

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.tasks.base import TaskState
from m_cedm_tpu_torch.tasks.diffusion import McedmTask
from m_cedm_tpu_torch.tasks.oformer import OformerTask

MCEDM_TARGET = "m_cedm_tpu.tasks.McedmTask"
OFORMER_TARGET = "m_cedm_tpu.tasks.OformerTask"

_REGISTRY: Dict[str, Callable] = {
    MCEDM_TARGET: McedmTask,
    "models.mcedm.PlMcedm": McedmTask,
    OFORMER_TARGET: OformerTask,
    "models.oformer.PlOformer": OformerTask,
}


def build_task(hparams, device, target: str = MCEDM_TARGET, ops: Ops = DEVICE_OPS,
               **kwargs):
    """The task a model config's `_target_` names, built from its `hparams`
    on `device`; `kwargs` go to the task (e.g. grad_clip, steps_per_epoch and
    max_epochs of the OFormer). `ops=PLAIN_OPS` runs every fused operation as
    its plain PyTorch version (the reference path)."""
    if target not in _REGISTRY:
        raise NotImplementedError(f"task {target!r} is not ported yet (see ROADMAP.md)")
    return _REGISTRY[target](hparams, device, ops, **kwargs)


__all__ = ["build_task", "McedmTask", "OformerTask", "TaskState", "MCEDM_TARGET",
           "OFORMER_TARGET"]
