"""Task registry of the port: config `_target_` names -> task builders.

The port keeps its own registry (the JAX package's `config._REGISTRY` is
filled by JAX modules under the same names). Each model `_target_` under
`configs/`, and its reference alias, is also registered with the port's
`config.instantiate`, which builds it through `build_task` on the device
the caller names; a task not ported yet raises there."""
from __future__ import annotations

from typing import Callable, Dict

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.tasks.base import TaskState
from m_cedm_tpu_torch.tasks.diffusion import (CondDdimTask, CondEdmTask,
                                              DdimTask, McedmTask)
from m_cedm_tpu_torch.tasks.oformer import OformerTask

MCEDM_TARGET = "m_cedm_tpu.tasks.McedmTask"
OFORMER_TARGET = "m_cedm_tpu.tasks.OformerTask"
COND_EDM_TARGET = "m_cedm_tpu.tasks.CondEdmTask"
DDIM_TARGET = "m_cedm_tpu.tasks.DdimTask"
COND_DDIM_TARGET = "m_cedm_tpu.tasks.CondDdimTask"

_REGISTRY: Dict[str, Callable] = {
    MCEDM_TARGET: McedmTask,
    "models.mcedm.PlMcedm": McedmTask,
    OFORMER_TARGET: OformerTask,
    "models.oformer.PlOformer": OformerTask,
    COND_EDM_TARGET: CondEdmTask,
    "models.ddim.PlCondEdm": CondEdmTask,
    DDIM_TARGET: DdimTask,
    "models.ddim.PlDdim": DdimTask,
    COND_DDIM_TARGET: CondDdimTask,
    "models.ddim.PlCondDdim": CondDdimTask,
}


def build_task(hparams, device, target: str = MCEDM_TARGET, ops: Ops = DEVICE_OPS,
               **kwargs):
    """The task a model config's `_target_` names, built from its `hparams`
    on `device`; `kwargs` go to the task (e.g. grad_clip, steps_per_epoch and
    max_epochs of the OFormer; `mega=True` for the diffusion tasks, whose
    sampling forwards then run the U-Net's blocks through K7).
    `ops=PLAIN_OPS` runs every fused operation as its plain PyTorch version
    (the reference path)."""
    if target not in _REGISTRY:
        raise NotImplementedError(f"task {target!r} is not ported yet (see ROADMAP.md)")
    return _REGISTRY[target](hparams, device, ops, **kwargs)


def _config_factory(target: str):
    def build(hparams, device, **kwargs):
        return build_task(hparams, device, target, **kwargs)
    return build


# the model targets named under configs/, with their reference aliases; the
# FNO family is not ported yet, so build_task raises for it
_CONFIG_TARGETS = {
    MCEDM_TARGET: "models.mcedm.PlMcedm",
    OFORMER_TARGET: "models.oformer.PlOformer",
    COND_EDM_TARGET: "models.ddim.PlCondEdm",
    DDIM_TARGET: "models.ddim.PlDdim",
    COND_DDIM_TARGET: "models.ddim.PlCondDdim",
    "m_cedm_tpu.tasks.FnoStateReconstrTask": "models.fno_state_2d.PlFnoStateReconstr2d",
}
for _target, _alias in _CONFIG_TARGETS.items():
    register(_target, _alias)(_config_factory(_target))


__all__ = ["build_task", "McedmTask", "OformerTask", "CondEdmTask", "DdimTask",
           "CondDdimTask", "TaskState", "MCEDM_TARGET", "OFORMER_TARGET",
           "COND_EDM_TARGET", "DDIM_TARGET", "COND_DDIM_TARGET"]
