"""Task registry of the port: config `_target_` names -> task builders.

The port keeps its own registry (the JAX package's `config._REGISTRY` is
filled by JAX modules under the same names). Each model `_target_` under
`configs/`, and its reference alias, is also registered with the port's
`config.instantiate`, which builds it through `build_task` on the device
the caller names."""
from __future__ import annotations

from typing import Callable, Dict

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.tasks.base import TaskState
from m_cedm_tpu_torch.tasks.diffusion import (CondDdimTask, CondEdmTask,
                                              DdimTask, McedmTask)
from m_cedm_tpu_torch.tasks.fno import (Fno2dTask, FnoStateReconstrTask,
                                        FnoStateTimePredTask, FnoTimePredTask)
from m_cedm_tpu_torch.tasks.oformer import (OformerStateTimePredTask,
                                            OformerTask, OformerTimePredTask)

MCEDM_TARGET = "m_cedm_tpu.tasks.McedmTask"
OFORMER_TARGET = "m_cedm_tpu.tasks.OformerTask"
COND_EDM_TARGET = "m_cedm_tpu.tasks.CondEdmTask"
DDIM_TARGET = "m_cedm_tpu.tasks.DdimTask"
COND_DDIM_TARGET = "m_cedm_tpu.tasks.CondDdimTask"
FNO_TARGET = "m_cedm_tpu.tasks.FnoStateReconstrTask"

# target -> (reference alias, task class)
_TASKS = {
    MCEDM_TARGET: ("models.mcedm.PlMcedm", McedmTask),
    OFORMER_TARGET: ("models.oformer.PlOformer", OformerTask),
    "m_cedm_tpu.tasks.OformerTimePredTask": ("models.oformer.PlOformerTimePred",
                                             OformerTimePredTask),
    "m_cedm_tpu.tasks.OformerStateTimePredTask": ("models.oformer.PlOformerStateTimePred",
                                                  OformerStateTimePredTask),
    COND_EDM_TARGET: ("models.ddim.PlCondEdm", CondEdmTask),
    DDIM_TARGET: ("models.ddim.PlDdim", DdimTask),
    COND_DDIM_TARGET: ("models.ddim.PlCondDdim", CondDdimTask),
    FNO_TARGET: ("models.fno_state_2d.PlFnoStateReconstr2d", FnoStateReconstrTask),
    "m_cedm_tpu.tasks.FnoTimePredTask": ("models.fno_state_2d.PlFnoTimePred2d",
                                         FnoTimePredTask),
    "m_cedm_tpu.tasks.FnoStateTimePredTask": ("models.fno_state_2d.PlFnoStateTimePred2d",
                                              FnoStateTimePredTask),
    "m_cedm_tpu.tasks.Fno2dTask": ("models.fno_2d.PlFno2d", Fno2dTask),
}
_REGISTRY: Dict[str, Callable] = {name: cls for target, (alias, cls) in _TASKS.items()
                                  for name in (target, alias)}


def build_task(hparams, device, target: str = MCEDM_TARGET, ops: Ops = DEVICE_OPS,
               **kwargs):
    """The task a model config's `_target_` names, built from its `hparams`
    on `device`; `kwargs` go to the task (e.g. grad_clip, steps_per_epoch and
    max_epochs of the OFormer; `mega=True` for the diffusion tasks, whose
    sampling forwards then run the U-Net's blocks through K7).
    `ops=PLAIN_OPS` runs every fused operation as its plain PyTorch version
    (the reference path)."""
    if target not in _REGISTRY:
        raise KeyError(f"no task {target!r} in the port's registry")
    return _REGISTRY[target](hparams, device, ops, **kwargs)


def _config_factory(target: str):
    def build(hparams, device, **kwargs):
        return build_task(hparams, device, target, **kwargs)
    return build


for _target, (_alias, _) in _TASKS.items():
    register(_target, _alias)(_config_factory(_target))


__all__ = ["build_task", "McedmTask", "OformerTask", "OformerTimePredTask",
           "OformerStateTimePredTask", "CondEdmTask", "DdimTask", "CondDdimTask",
           "FnoStateReconstrTask", "FnoTimePredTask", "FnoStateTimePredTask",
           "Fno2dTask", "TaskState", "MCEDM_TARGET", "OFORMER_TARGET",
           "COND_EDM_TARGET", "DDIM_TARGET", "COND_DDIM_TARGET", "FNO_TARGET"]
