"""Dataset path routing and logging helpers (port of m_cedm_tpu/utils.py).

"Main process" is rank 0 of torch.distributed when a process group is
initialised, and the only process otherwise.
"""
from __future__ import annotations

import logging
import os

import torch

from m_cedm_tpu_torch.config import DotDict

__all__ = ["DotDict", "override_data_folders", "get_logger", "is_main_process"]


def override_data_folders(cfg_datamodule, dataroot, system, res=128, n_train=1000):
    """Route `system` + `res` + `n_train` to train/val/test h5 paths.

    Training data is always the res-128 set; val/test come from the requested
    resolution (cross-resolution evaluation).
    """
    train_res = 128
    if system == "swe":
        if n_train == 1000:
            train_file = f"1D_swp_{train_res}/1D_swp_{train_res}_train.h5"
        else:
            train_file = f"1D_swp_{train_res}/1D_swp_{train_res}_train_{n_train}.h5"
        val_file = test_file = f"1D_swp_{res}/1D_swp_{res}_test.h5"
    elif system == "swe_per":
        train_file = f"1D_swp_{train_res}_per/1D_swp_{train_res}_per_train.h5"
        val_file = test_file = f"1D_swp_{res}_per/1D_swp_{res}_per_test.h5"
    elif system == "darcy":
        train_file = "1D_darcy_128/darcy_train.h5"
        val_file = test_file = "1D_darcy_128/darcy_test.h5"
    else:
        train_file = f"1D_swp_{train_res}/1D_swp_{train_res}_train.h5"
        val_file = test_file = f"1D_swp_{res}/1D_swp_{res}_test.h5"

    cfg_datamodule.train_path = os.path.join(dataroot, train_file)
    cfg_datamodule.val_path = os.path.join(dataroot, val_file)
    cfg_datamodule.test_path = os.path.join(dataroot, test_file)
    return cfg_datamodule


def is_main_process() -> bool:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank() == 0
    return True


class _MainProcessFilter(logging.Filter):
    def filter(self, record):
        return is_main_process()


def get_logger(name=__name__) -> logging.Logger:
    """Logger that only emits on the main process."""
    logger = logging.getLogger(name)
    if not any(isinstance(f, _MainProcessFilter) for f in logger.filters):
        logger.addFilter(_MainProcessFilter())
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
