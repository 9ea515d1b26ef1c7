"""The training loop (port of m_cedm_tpu/train/loop.py, one device).

Owns the epochs, batch placement on the task's device, the validation
cadence, the test, checkpoints and resume, metric aggregation and the
callbacks. Everything numeric happens in the tasks; this file is
orchestration.

Random draws: the parameters are drawn on the host (the models' initializers
draw there) from a generator seeded with `seed`; the train and validation
steps draw from one generator on the task's device seeded with `seed`, the
test from one seeded with `seed + 12345`. The batch order comes from
`np.random.default_rng(seed)`, as in the JAX package. Batches go to the
device once a step, copied without blocking from pinned host memory.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_dir
from m_cedm_tpu_torch.train.metrics import MetricsLogger
from m_cedm_tpu_torch.utils import get_logger

log = get_logger(__name__)

TEST_SEED_OFFSET = 12345


@register("pytorch_lightning.Trainer", "m_cedm_tpu.train.Trainer")
def _build_trainer(**kw):
    """Accepts the reference trainer-config surface; maps what applies."""
    return Trainer(
        max_epochs=kw.get("max_epochs", 500),
        check_val_every_n_epoch=kw.get("check_val_every_n_epoch", 1),
        gradient_clip_val=kw.get("gradient_clip_val"),
        callbacks=kw.get("callbacks", ()),
        logger=kw.get("logger"),
        out_dir=kw.get("out_dir", "."),
    )


def batch_to_device(batch, device: torch.device):
    """A host batch (numpy arrays) as tensors on `device`."""
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


class Trainer:
    def __init__(self, max_epochs: int = 500, check_val_every_n_epoch: int = 1,
                 gradient_clip_val: Optional[float] = None,
                 callbacks: Sequence = (), logger: Optional[MetricsLogger] = None,
                 out_dir: str = ".", seed: int = 0,
                 ckpt_monitor: Optional[str] = None, ckpt_mode: str = "min",
                 limit_train_batches: Optional[int] = None):
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.gradient_clip_val = gradient_clip_val
        self.callbacks = list(callbacks)
        self.out_dir = out_dir
        self.seed = seed
        self.limit_train_batches = limit_train_batches
        self.logger = logger or MetricsLogger(out_dir)
        self.ckpt = CheckpointManager(f"{out_dir}/checkpoints",
                                      monitor=ckpt_monitor, mode=ckpt_mode)
        self.state = None
        self.current_epoch = 0
        for cb in self.callbacks:
            if hasattr(cb, "setup"):
                cb.setup(out_dir, getattr(self.logger, "_wandb", None))

    # ------------------------------------------------------------------ fit

    def fit(self, task, datamodule, ckpt_path: Optional[str] = None):
        rng = np.random.default_rng(self.seed)
        device = task.device
        gen = torch.Generator(device=device).manual_seed(self.seed)

        if hasattr(task, "set_train_mask_kind") and getattr(
                datamodule, "train_mask_kind", None):
            task.set_train_mask_kind(datamodule.train_mask_kind)
        task.down_factor = (datamodule.down_factor
                            if getattr(datamodule, "down_interp", True) else 1)

        steps_per_epoch = datamodule.num_batches("train")
        if hasattr(task, "configure_lr_schedule"):  # the OFormer's and the FNO's
            task.configure_lr_schedule(steps_per_epoch, self.max_epochs)

        state = task.init_state(torch.Generator().manual_seed(self.seed),
                                datamodule.get_norm_stats())

        start_epoch = 0
        resume_dir = resolve_ckpt_dir(ckpt_path)
        if resume_dir:
            restored = CheckpointManager(resume_dir).restore(state)
            if restored is not None:
                state = restored
                start_epoch = int(state.step) // max(steps_per_epoch, 1)
                log.info(f"Resuming from epoch {start_epoch}")

        val_every = getattr(task, "val_every", None) or self.check_val_every_n_epoch

        for epoch in range(start_epoch, self.max_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            n_batches = 0
            for batch in datamodule.iter_split("train", rng):
                if (self.limit_train_batches
                        and n_batches >= self.limit_train_batches):
                    break
                state, metrics = task.train_step(
                    state, batch_to_device(batch, device), gen)
                # the port's train steps also return the gradient norm; the
                # logs keep the JAX package's keys
                metrics.pop("grad_norm", None)
                self.logger.accumulate(metrics)
                n_batches += 1

            run_val = (epoch % val_every == 0 or epoch == 0
                       or epoch == self.max_epochs - 1)
            if run_val:
                self._run_eval(task, state, datamodule, "val", epoch, gen)

            epoch_metrics = self.logger.flush_epoch(
                epoch, {"epoch_time_s": time.time() - t0})
            if epoch % 10 == 0 or run_val:
                msg = ", ".join(f"{k}={v:.4g}" for k, v in epoch_metrics.items()
                                if not k.startswith("epoch_"))
                log.info(f"epoch {epoch}: {msg} "
                         f"({epoch_metrics.get('epoch_time_s', 0):.1f}s)")
            self.ckpt.save(int(state.step), state, epoch_metrics)

        self.state = state
        return state

    # ----------------------------------------------------------------- test

    def test(self, task, datamodule, state=None, verbose: bool = True):
        state = state if state is not None else self.state
        if state is None:
            raise ValueError("call fit() first or pass a state")
        gen = torch.Generator(device=task.device).manual_seed(
            self.seed + TEST_SEED_OFFSET)
        task.down_factor = (datamodule.down_factor
                            if getattr(datamodule, "down_interp", True) else 1)
        self._run_eval(task, state, datamodule, "test", self.current_epoch, gen)
        metrics = self.logger.flush_epoch(self.current_epoch)
        if verbose:
            for k, v in sorted(metrics.items()):
                log.info(f"  {k}: {v:.6g}")
        return metrics

    # ------------------------------------------------------------- eval core

    def _run_eval(self, task, state, datamodule, split, epoch, gen):
        from m_cedm_tpu_torch.tasks.diffusion import DiffusionTaskBase, McedmTask

        device = task.device
        sp = getattr(task, "test_sparams", None)
        n_samples = 1
        if split == "test" and sp is not None:
            n_samples = int(sp.get("n_samples", 1) if hasattr(sp, "get")
                            else getattr(sp, "n_samples", 1))
        # the callbacks take host arrays; without callbacks nothing is read back
        host = bool(self.callbacks)

        def to_host(t):
            return t.detach().cpu().numpy()

        for batch_idx, host_batch in enumerate(datamodule.iter_split(split)):
            batch = batch_to_device(host_batch, device)
            outputs: Dict = {}
            if isinstance(task, McedmTask):
                masks = datamodule.eval_masks(split)
                down_mask = (self._down_mask(task, batch[0].shape, device)
                             if split == "test" else None)
                for name, mask in masks.items():
                    metrics, pred = task.eval_step(
                        state, batch, gen, torch.from_numpy(mask).to(device),
                        split=split, n_samples=n_samples, mask_name=name,
                        down_mask=down_mask)
                    self.logger.accumulate(metrics)
                    if host:
                        gt = task.transform.forward(state, batch[0], batch[3])
                        outputs[f"traj_{name}"] = to_host(pred)[:, None]
                        outputs[f"gt_{name}"] = to_host(gt)
            elif isinstance(task, DiffusionTaskBase):
                metrics, pred = task.eval_step(state, batch, gen, split=split,
                                               n_samples=n_samples)
                self.logger.accumulate(metrics)
                if host:
                    outputs["traj"] = to_host(pred)[:, None]
                    gt = to_host(task.transform.forward(state, batch[0], batch[3]))
                    # conditional tasks predict only the u block; plot matching gt
                    outputs["gt"] = gt[..., -pred.shape[-1]:]
            else:
                metrics, pred = task.eval_step(state, batch, gen, split=split)
                self.logger.accumulate(metrics)
                if host:
                    outputs["pred"] = to_host(pred)
                    target_fn = getattr(task, "eval_target", None)
                    outputs["target"] = np.asarray(
                        target_fn(host_batch) if target_fn else host_batch[3])
            for cb in self.callbacks:
                cb.on_eval_batch(outputs, batch_idx, split)
        for cb in self.callbacks:
            cb.on_eval_end(epoch, split)

    @staticmethod
    def _down_mask(task, shape, device):
        down = getattr(task, "down_factor", 1)
        if down <= 1:
            return None
        each = 2 ** (down - 1)
        m = np.zeros(tuple(shape[1:3]) + (1,), np.float32)
        m[::each, ::each] = 1.0
        return torch.from_numpy(m[None]).to(device)
