"""Training orchestration of the port: the loop, checkpoints, metrics and
callbacks (port of m_cedm_tpu/train)."""
from m_cedm_tpu_torch.train.loop import Trainer

__all__ = ["Trainer"]
