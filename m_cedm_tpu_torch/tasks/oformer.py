"""OFormer reconstruction task (port of m_cedm_tpu/tasks/oformer.py::OformerTask).

    task = build_task(hparams, device, target="m_cedm_tpu.tasks.OformerTask",
                      grad_clip=2.0, steps_per_epoch=None, max_epochs=None)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, batch, generator)
    metrics, grid_pred = task.eval_step(state, batch, split="val")

batch = (x, y, node_type, pos, n_time) as the OFormer datamodule gives it
(data.oformer_data.tokenize_grid): x (B, 1, T*X, C_in), y (B, 1, T*X, C_out),
node_type (B, T*X, 1), pos (B, T*X, 2), n_time (B,).

Training is the MSE of `_criterion` (sum over channels, mean over the rest),
the global-norm clip, and AdamW with weight decay on every trainable
parameter, at a constant lr or, given a schedule length, on optax's
cosine one-cycle schedule. The state is functional: `train_step` returns a
new TaskState. The time-prediction tasks come in a later slice (ROADMAP.md).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.oformer import (OformerDecoderConfig,
                                             OformerEncoderConfig,
                                             OformerModel)
from m_cedm_tpu_torch.ops import losses
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.ops.schedules import cosine_onecycle
from m_cedm_tpu_torch.physics.pde_loss import get_pde_loss_function
from m_cedm_tpu_torch.tasks.base import (Optimizer, TaskState, apply_updates,
                                         global_norm, normalizers_from_stats,
                                         to_device)


class OformerTask:
    """Space-time token reconstruction with the OFormer encoder/decoder."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS,
                 grad_clip: Optional[float] = 2.0,
                 steps_per_epoch: Optional[int] = None,
                 max_epochs: Optional[int] = None):
        hparams = copy.deepcopy(hparams)
        if hparams.get("dtype", "float32") in ("bfloat16", "bf16"):
            raise NotImplementedError("bf16 compute is not ported yet (see ROADMAP.md)")
        self.hparams = hparams
        self.device = torch.device(device)
        self.enc_cfg = OformerEncoderConfig.from_hparams(hparams["encoder"])
        self.dec_cfg = OformerDecoderConfig.from_hparams(hparams["decoder"])
        self.model = OformerModel(self.enc_cfg, self.dec_cfg, ops).to(self.device)
        self.time_history = hparams.get("time_history", 128)
        self.lr = hparams["lr"]
        self.weight_decay = hparams.get("weight_decay", 1e-4)
        self.curriculum_steps = hparams.get("curriculum_steps", 0)
        self.curriculum_ratio = hparams.get("curriculum_ratio", 0.2)
        self.grad_clip = grad_clip
        self.norm_input = self.norm_target = True
        self.down_factor = 1
        self.total_steps = None
        self.pde_loss, _ = get_pde_loss_function("swe", False)
        self.configure_lr_schedule(steps_per_epoch, max_epochs)

    # -- wiring -------------------------------------------------------------

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        self.pde_loss, _ = get_pde_loss_function(
            system, flip_xy, Tn_mult=self.time_history / 128)

    def configure_lr_schedule(self, steps_per_epoch: Optional[int],
                              max_epochs: Optional[int] = None):
        """AdamW after the clip; the one-cycle schedule over
        steps_per_epoch * max_epochs steps when both are given and its warm-up
        is at least one step (optax's schedule is NaN otherwise), else the
        constant lr."""
        sched = self.lr
        if steps_per_epoch and max_epochs:
            self.total_steps = steps_per_epoch * max_epochs
            if int(0.3 * self.total_steps) >= 1:
                sched = cosine_onecycle(self.total_steps, self.lr, pct_start=0.3,
                                        div_factor=1e4, final_div_factor=1e4)
        self.tx = Optimizer("AdamW", lr=sched, weight_decay=self.weight_decay,
                            grad_clip=self.grad_clip)

    def init_state(self, generator: Optional[torch.Generator], norm_stats=None,
                   params=None, *, constants=None, opt_state=None, step: int = 0,
                   ema_params=None) -> TaskState:
        """A state on the task's device: `params` and `constants` (e.g. from
        convert.jax_train_state_to_torch) or a fresh draw of both from
        `generator`; identity normalizers unless `norm_stats` are given (their
        norm_input / norm_target flags are read as the JAX task reads them).
        The OFormer keeps no EMA."""
        if ema_params is not None:
            raise ValueError("the OFormer task keeps no EMA")
        if params is None:
            self.model.reset_parameters(generator)
            params = dict(self.model.named_parameters())
            constants = dict(self.model.named_buffers())
        elif constants is None:
            raise ValueError("params come with their constants (the Fourier matrix B)")
        if norm_stats is not None:
            self.norm_input = bool(norm_stats.get("norm_input", True))
            self.norm_target = bool(norm_stats.get("norm_target", True))
            n_in, n_tar = normalizers_from_stats(norm_stats, "gauss", self.device)
        else:
            n_in = Normalizer.identity((), self.device)
            n_tar = Normalizer.identity((), self.device)
        params = to_device(params, self.device)
        return TaskState(
            params=params, ema_params=None, normalizer_input=n_in,
            normalizer_target=n_tar,
            opt_state=(self.tx.init(params) if opt_state is None
                       else to_device(opt_state, self.device)),
            step=int(step), constants=to_device(constants, self.device))

    # -- forward ------------------------------------------------------------

    def apply(self, state: TaskState, params, x, node_type, pos,
              forward_steps: int, dropout_keep=None) -> torch.Tensor:
        """The model with `params` and the state's constants swapped in."""
        return functional_call(self.model, {**params, **state.constants},
                               (x, node_type, node_type, pos, pos, forward_steps),
                               {"dropout_keep": dropout_keep})

    @staticmethod
    def _criterion(pred, target):
        """MultiLoss: sum over channels, mean over tokens and batch."""
        return torch.mean(torch.sum(torch.square(pred - target), dim=-1))

    def _pair_target(self, state: TaskState, s):
        if self.norm_target:
            return s, state.normalizer_target(s, inverse=True)
        return state.normalizer_target(s), s

    def _curriculum_forward_steps(self, step: int, forward_steps: int) -> int:
        if self.curriculum_steps <= 0 or not self.total_steps:
            return forward_steps
        limit = int(self.curriculum_ratio * self.total_steps)
        if step >= limit:
            return forward_steps
        progress = (step * 2) / limit
        c = self.curriculum_steps + int(
            max(0.0, progress - 1.0)
            * ((forward_steps - self.curriculum_steps) / 2.0)) * 2
        return min(max(c, 1), forward_steps)

    # -- training -----------------------------------------------------------

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   dropout_keep: Optional[torch.Tensor] = None):
        """One AdamW step on the MSE of the first curriculum steps. Returns
        (new state, {"train_loss", "grad_norm"}), the norm before clipping.
        dropout_keep (B, tokens, latent) 0/1 replaces the generator's draw of
        the decoder's dropout mask (kept with probability 1 - rate)."""
        x, y, node_type, pos, _ = batch
        c_steps = self._curriculum_forward_steps(state.step, int(y.shape[1]))
        y_norm, _ = self._pair_target(state, y[:, :c_steps])
        rate = self.dec_cfg.dropout
        if dropout_keep is None and rate > 0:
            b, t, n = x.shape[:3]
            shape = (b, n * (t // self.enc_cfg.time_window), self.enc_cfg.out_channels)
            dropout_keep = torch.rand(shape, generator=generator,
                                      device=x.device) < 1.0 - rate

        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        with torch.enable_grad():
            pred = self.apply(state, params, x, node_type, pos, c_steps, dropout_keep)
            loss = self._criterion(pred, y_norm)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
        return (dataclasses.replace(state, params=apply_updates(state.params, updates),
                                    opt_state=opt_state, step=state.step + 1),
                {"train_loss": loss.detach(), "grad_norm": global_norm(grads)})

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator=None, split: str = "val"):
        """One forward over every step of y; returns (metrics, grid_pred) with
        the reference keys {split}_loss, _mae_u, _mae_u_un, _corr,
        _mae_u_scaled and, for one-step targets, _pde_loss and _pde_loss_gt;
        grid_pred is the prediction as (B, n_time, X, C)."""
        x, y, node_type, pos, n_time = batch
        n_time = int(n_time[0])
        y_norm, y_unnorm = self._pair_target(state, y)
        pred = self.apply(state, state.params, x, node_type, pos, int(y.shape[1]))
        down = self.down_factor if split == "test" else 1
        pred_un = state.normalizer_target(pred, inverse=True)
        metrics = {
            f"{split}_loss": self._criterion(pred, y_norm),
            f"{split}_mae_u": losses.downsampled_loss(pred, y_norm, down),
            f"{split}_mae_u_un": losses.downsampled_loss(pred_un, y_unnorm, down),
            f"{split}_corr": torch.mean(losses.correlation(pred, y_norm)),
            f"{split}_mae_u_scaled": losses.scaled_mae_loss(pred, y_norm),
        }
        metrics.update(self._pde_metrics(state, x, pred, y_norm, n_time, split))
        return metrics, pred.reshape(pred.shape[0], n_time, -1, pred.shape[-1])

    def _pde_metrics(self, state, x, pred, y_norm, n_time: int, split: str):
        if pred.shape[1] != 1:
            return {}
        b, c = pred.shape[0], pred.shape[-1]
        x_g = x.reshape(b, n_time, -1, x.shape[-1])[..., :-2]  # drop the t, x coords
        return {f"{split}_pde_loss": self._pde(state, x_g, pred.reshape(b, n_time, -1, c)),
                f"{split}_pde_loss_gt": self._pde(state, x_g,
                                                  y_norm.reshape(b, n_time, -1, c))}

    def _pde(self, state: TaskState, cond, pred):
        x_un = torch.cat([state.normalizer_input(cond, inverse=True),
                          state.normalizer_target(pred, inverse=True)], dim=-1)
        m = self.pde_loss(x_un, x_un, state.normalizer_input,
                          state.normalizer_target, clamp_loss=False)
        return torch.sum(m) / cond.shape[0]

    @staticmethod
    def eval_target(batch) -> np.ndarray:
        """Grid-shaped target for plotting callbacks: (B, T, X, C)."""
        y = np.asarray(batch[1])
        n_time = int(np.asarray(batch[-1])[0])
        return y.reshape(y.shape[0], n_time, -1, y.shape[-1])
