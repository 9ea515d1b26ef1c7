"""Train + test entry point of the port (the JAX package's `run.py`, with the same
hydra-style surface):

    python -m m_cedm_tpu_torch.run --config-name=config_adm_edm_mcedm_res32.yaml \\
        system=swe_per dataroot=data
    python -m m_cedm_tpu_torch.run --device cpu ...     # on the CPU

Flow: compose the config -> route dataset paths by system/res/n_train ->
seed -> build the datamodule, callbacks, trainer and task on the device ->
set the test sampler and the PDE loss -> fit (with optional resume from
ckpt_path) -> test -> return the sweep objective (val_mae_u_scaled).

It runs on a CUDA device unless `--device cpu` is given, and raises when no
CUDA device is present; it never carries on on the CPU by itself.
`-m/--multirun` (the TPE sweep) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import yaml

from m_cedm_tpu_torch.config import compose, instantiate, to_plain
from m_cedm_tpu_torch.train.loop import Trainer
from m_cedm_tpu_torch.train.metrics import MetricsLogger
from m_cedm_tpu_torch.utils import get_logger, override_data_folders

log = get_logger(__name__)

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-name", default="config.yaml")
    p.add_argument("--config-path", default=CONFIG_DIR)
    p.add_argument("-m", "--multirun", action="store_true",
                   help="hydra --multirun (the TPE sweep): not ported yet")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu on request)")
    p.add_argument("overrides", nargs="*", help="hydra-style key=value overrides")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The device to run on: a CUDA device must be present unless the CPU is
    asked for by name."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to "
                           "run on the CPU")
    return device


def build_run_dir(cfg) -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    root = cfg.get("logs_root_folder", "") or ""
    return os.path.join(f"{root}logs", "runs",
                        f"{cfg.get('name', 'run')}{cfg.get('subname', '')}{stamp}")


def split_hydra_overrides(overrides):
    """Hydra consumes `hydra.*` overrides itself rather than composing them
    into the job config (`hydra.run.dir=...` sets the output directory).
    Returns (job_overrides, hydra_cfg)."""
    job, hydra_cfg = [], {}
    for o in overrides:
        key = o.split("=", 1)[0].lstrip("+")
        if key == "hydra" or key.startswith("hydra."):
            k, _, v = o.partition("=")
            hydra_cfg[k.lstrip("+")] = v
        else:
            job.append(o)
    return job, hydra_cfg


def warn_unconsumed_hydra(hydra_cli, consumed=frozenset({"hydra.run.dir"})):
    """Warn about each hydra.* CLI key the entry points do not consume (the
    sweep's keys too, until it is ported): likely a typo, never swallowed."""
    for k in hydra_cli:
        if k not in consumed:
            log.warning(f"hydra override {k!r} is not supported by this "
                        f"entry point and is ignored")


def hydra_setting(hydra_block, hydra_cli, dotted_key, default=None):
    """Resolve a `hydra.x.y` setting: a CLI override wins over the config's
    `hydra:` block."""
    if dotted_key in hydra_cli:
        return yaml.safe_load(hydra_cli[dotted_key])
    node = hydra_block or {}
    for part in dotted_key.split(".")[1:]:
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return default if node is None else node


def route_data(cfg):
    """The datamodule's train/val/test paths from dataroot, system, res and
    n_train."""
    cfg.datamodule = override_data_folders(
        cfg.datamodule, cfg.dataroot, cfg.get("system"), cfg.get("res", 128),
        n_train=cfg.get("n_train", 1000))


def one_test_item_at_100_samples(cfg):
    """n_samples == 100 -> test batch size 1, as the reference does."""
    if cfg.get("diff_sampler") is not None and cfg.diff_sampler.get("n_samples") == 100:
        cfg.datamodule.test_batch_size = 1


def main(argv=None) -> float:
    args = parse_args(argv)
    if args.multirun:
        raise NotImplementedError("--multirun (the TPE sweep) is not ported yet "
                                  "(see ROADMAP.md)")
    device = resolve_device(args.device)
    job_overrides, hydra_cfg = split_hydra_overrides(args.overrides)
    warn_unconsumed_hydra(hydra_cfg)
    cfg, hydra_block = compose(args.config_path, args.config_name,
                               job_overrides, return_hydra=True)
    route_data(cfg)

    model_name = cfg.model.hparams.name
    dataset = cfg.datamodule.name
    log.info(f"This run trains and tests the model {model_name} on the {dataset} dataset")

    seed = cfg.get("seed", 0)
    np.random.seed(seed)

    out_dir = (hydra_cfg.get("hydra.run.dir")
               or hydra_setting(hydra_block, {}, "hydra.run.dir")
               or build_run_dir(cfg))
    sampler_name = (cfg.get("diff_sampler") or {}).get("name", "")
    run_name = f"{model_name}_{dataset}_{seed}{sampler_name}{cfg.get('subname', '')}"
    logger = MetricsLogger(out_dir, run_name=run_name, use_wandb=True)
    logger.log_config(to_plain(cfg))
    log.info(f"Output dir is {out_dir}")

    one_test_item_at_100_samples(cfg)
    datamodule = instantiate(cfg.datamodule)

    callbacks = []
    ckpt_monitor, ckpt_mode = None, "min"
    for cb_conf in (cfg.get("callbacks") or {}).values():
        if not isinstance(cb_conf, dict) or "_target_" not in cb_conf:
            continue
        if ("CheckpointManager" in cb_conf["_target_"]
                or "ModelCheckpoint" in cb_conf["_target_"]):
            ckpt_monitor = cb_conf.get("monitor")
            ckpt_mode = cb_conf.get("mode", "min")
            continue  # checkpointing is owned by the Trainer
        callbacks.append(instantiate(cb_conf))

    trainer_kw = {k: v for k, v in cfg.trainer.items() if k != "_target_"}
    trainer = Trainer(
        max_epochs=trainer_kw.get("max_epochs", 500),
        check_val_every_n_epoch=trainer_kw.get("check_val_every_n_epoch", 1),
        gradient_clip_val=trainer_kw.get("gradient_clip_val"),
        callbacks=callbacks, logger=logger, out_dir=out_dir, seed=seed,
        ckpt_monitor=ckpt_monitor, ckpt_mode=ckpt_mode)

    # trainer precision 'bf16' selects bf16 compute, as the JAX run.py maps
    # it: the ADM tasks and the OFormer's train and serve in bf16 (fp32
    # master params, optimizer state and EMA); the FNO raises when the task
    # is built, the DDPM U-Net at its first bf16 forward (ROADMAP.md)
    if str(trainer_kw.get("precision", "32")) in ("bf16", "bfloat16"):
        if "model" in cfg.model.hparams:
            cfg.model.hparams.model["dtype"] = "bfloat16"
        else:
            cfg.model.hparams["dtype"] = "bfloat16"

    task = instantiate(cfg.model, device=device,
                       grad_clip=trainer_kw.get("gradient_clip_val"))

    if cfg.get("diff_sampler") is not None:
        log.info("Set sampler params")
        task.set_test_sampler_params(cfg.diff_sampler)

    if cfg.get("system") is not None:
        log.info("Set pde loss for a concrete system")
        task.set_pde_loss_function(cfg.system, datamodule.flip_xy)

    # override_epochs has no effect: a resumed run trains on to
    # trainer.max_epochs (the reference's guard compares that key with itself)
    trainer.fit(task, datamodule, ckpt_path=cfg.get("ckpt_path"))

    metric_key = "val_mae_u_scaled"
    metric = logger.summary.get(metric_key, np.inf)
    if metric is np.inf:
        log.warning(f"Metric {metric_key} not found in summary")

    trainer.test(task, datamodule)
    logger.finish()
    return float(metric)


if __name__ == "__main__":
    main()
