"""Test-only entry point of the port (the JAX package's `eval_model.py`): restore
the latest checkpoint of a run and run the test loop.

    python -m m_cedm_tpu_torch.eval_model --config-name=config_adm_edm_mcedm_res32.yaml \\
        ckpt_path=logs/runs/adm_edm_mcedm... dataroot=data

Returns test_mae_u_scaled. Runs on a CUDA device unless `--device cpu` is
given, as `m_cedm_tpu_torch.run` does. As in the JAX package, it does not
read `trainer.precision`: to serve in bf16 give the model's dtype,
`+model.hparams.dtype=bfloat16` (the OFormer) or
`+model.hparams.model.dtype=bfloat16` (the ADM tasks).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from m_cedm_tpu_torch.config import compose, instantiate, to_plain
from m_cedm_tpu_torch.run import (build_run_dir, hydra_setting,
                                  one_test_item_at_100_samples, parse_args,
                                  resolve_device, route_data,
                                  split_hydra_overrides, warn_unconsumed_hydra)
from m_cedm_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_dir
from m_cedm_tpu_torch.train.loop import Trainer
from m_cedm_tpu_torch.train.metrics import MetricsLogger


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    job_overrides, hydra_cli = split_hydra_overrides(args.overrides)
    warn_unconsumed_hydra(hydra_cli)
    cfg, hydra_block = compose(args.config_path, args.config_name,
                               job_overrides, return_hydra=True)
    route_data(cfg)
    one_test_item_at_100_samples(cfg)

    out_dir = (hydra_cli.get("hydra.run.dir")
               or hydra_setting(hydra_block, {}, "hydra.run.dir")
               or build_run_dir(cfg))
    logger = MetricsLogger(out_dir, run_name=f"eval_{cfg.model.hparams.name}")
    logger.log_config(to_plain(cfg))

    datamodule = instantiate(cfg.datamodule)
    task = instantiate(cfg.model, device=device)
    if cfg.get("diff_sampler") is not None:
        task.set_test_sampler_params(cfg.diff_sampler)
    if cfg.get("system") is not None:
        task.set_pde_loss_function(cfg.system, datamodule.flip_xy)

    ckpt_dir = resolve_ckpt_dir(cfg.get("ckpt_path"))
    if not (ckpt_dir and os.path.isdir(ckpt_dir)):
        raise FileNotFoundError(f"no checkpoint dir at {ckpt_dir}")

    seed = cfg.get("seed", 0)
    state = task.init_state(torch.Generator().manual_seed(seed),
                            datamodule.get_norm_stats())
    state = CheckpointManager(ckpt_dir).restore(state)
    if state is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")

    trainer = Trainer(max_epochs=0, logger=logger, out_dir=out_dir, seed=seed)
    metrics = trainer.test(task, datamodule, state=state)
    logger.finish()
    return float(metrics.get("test_mae_u_scaled", np.inf))


if __name__ == "__main__":
    main()
