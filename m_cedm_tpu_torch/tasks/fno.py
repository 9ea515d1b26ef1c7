"""FNO supervised tasks (port of m_cedm_tpu/tasks/fno.py).

  FnoStateReconstrTask  reconstruct the unobserved state s from the observed
                        field u over the history window
  FnoTimePredTask       predict the future (u, s) from the first
                        time_history steps
  FnoStateTimePredTask  reconstruct, then predict: test-only, from two
                        trained states
  Fno2dTask             autoregressive stepper with teacher forcing

    task = build_task(hparams, device, target="m_cedm_tpu.tasks.FnoStateReconstrTask",
                      grad_clip=None, steps_per_epoch=None)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, (u, x, t, s))
    metrics, pred = task.eval_step(state, (u, x, t, s), split="val")

Training is Adam after `add_decayed_weights` (when weight_decay is set)
after the global-norm clip (when grad_clip is set), on torch's StepLR as an
lr function of the optimizer's count: lr * factor ** ((count //
steps_per_epoch) // step_size), the constant lr without steps_per_epoch.
The FNO keeps no EMA. It runs no kernel of the port: the spectral matmuls
are plain PyTorch, as they are XLA matmuls in the JAX package.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch.func import functional_call

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.fno import Fno2d, FnoConfig, FnoState2d
from m_cedm_tpu_torch.ops import losses
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.physics.pde_loss import get_pde_loss_function
from m_cedm_tpu_torch.tasks.base import (Optimizer, TaskState, mae,
                                         normalizers_from_stats, optimizer_step,
                                         to_device)


def _criterion(kind: str):
    if kind == "l1":
        return lambda p, t: torch.mean(torch.abs(p - t))
    if kind in ("l2", "mse"):
        return lambda p, t: torch.mean(torch.square(p - t))
    if kind == "smooth_l1":
        def f(p, t):
            d = torch.abs(p - t)
            return torch.mean(torch.where(d < 1, 0.5 * torch.square(p - t), d - 0.5))
        return f
    if kind == "lp":
        return lambda p, t: losses.lp_loss(p, t, p=2, reduction="sum")
    raise ValueError(kind)


class FnoTaskBase:
    """Shared: the model, the StepLR Adam, the normalizer pairs, the PDE
    residual."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS,
                 grad_clip: Optional[float] = None,
                 steps_per_epoch: Optional[int] = None):
        hparams = copy.deepcopy(hparams)
        self.hparams = hparams
        self.device = torch.device(device)
        self.cfg = FnoConfig.from_hparams(hparams)
        self.model = self._build_model().to(self.device)
        self.time_history = hparams.get("time_history", 128)
        self.criterion = _criterion(hparams.get("loss", "l1"))
        self.lr = hparams["lr"]
        self.weight_decay = hparams.get("weight_decay", 0.0)
        self.factor = hparams.get("factor", 0.3)
        self.step_size = hparams.get("step_size", 50)
        self.grad_clip = grad_clip
        self.norm_input = self.norm_target = True
        self.down_factor = 1
        self.pde_loss, _ = get_pde_loss_function("swe", False)
        self.configure_lr_schedule(steps_per_epoch)

    def _build_model(self):
        return FnoState2d(self.cfg)

    def configure_lr_schedule(self, steps_per_epoch: Optional[int],
                              max_epochs: Optional[int] = None):
        """Adam on torch's StepLR (step_size epochs, gamma = factor) when
        steps_per_epoch is given, else the constant lr; the schedule's
        length (max_epochs) does not enter."""
        sched = self.lr
        if steps_per_epoch:
            spe, lr, factor, size = int(steps_per_epoch), self.lr, self.factor, self.step_size
            sched = lambda count: lr * factor ** ((count // spe) // size)
        self.tx = Optimizer("Adam", lr=sched, weight_decay=self.weight_decay,
                            grad_clip=self.grad_clip)

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        self.pde_loss, _ = get_pde_loss_function(
            system, flip_xy, Tn_mult=getattr(self, "_tn_mult", 1.0))

    def set_norm_flags(self, stats):
        self.norm_input = bool(stats.get("norm_input", True))
        self.norm_target = bool(stats.get("norm_target", True))

    def init_state(self, generator: Optional[torch.Generator], norm_stats=None,
                   params=None, *, opt_state=None, step: int = 0,
                   ema_params=None) -> TaskState:
        """A state on the task's device: `params` (e.g. from
        convert.jax_train_state_to_torch) or a fresh draw from `generator`;
        identity normalizers unless `norm_stats` are given (their norm_input
        / norm_target flags are read as the JAX task reads them). The FNO
        keeps no EMA."""
        if ema_params is not None:
            raise ValueError("the FNO tasks keep no EMA")
        if params is None:
            self.model.reset_parameters(generator)
            params = dict(self.model.named_parameters())
        if norm_stats is not None:
            self.set_norm_flags(norm_stats)
            n_in, n_tar = normalizers_from_stats(norm_stats, "gauss", self.device)
        else:
            n_in = Normalizer.identity((), self.device)
            n_tar = Normalizer.identity((), self.device)
        params = to_device(params, self.device)
        return TaskState(params=params, ema_params=None, normalizer_input=n_in,
                         normalizer_target=n_tar,
                         opt_state=(self.tx.init(params) if opt_state is None
                                    else to_device(opt_state, self.device)),
                         step=int(step))

    # -- normalization helpers (the reference's get_unnorm_* semantics) -----

    def _pair_target(self, state: TaskState, s):
        if self.norm_target:
            return s, state.normalizer_target(s, inverse=True)
        return state.normalizer_target(s), s

    def _pair_input(self, state: TaskState, u):
        if self.norm_input:
            return u, state.normalizer_input(u, inverse=True)
        return state.normalizer_input(u), u

    @staticmethod
    def _coords(x, t):
        """(B,) spacings pass through; gridded coordinates give None, so the
        model uses its own linspace grids."""
        if x.dim() == 1 and t.dim() == 1:
            return x, t
        return None, None

    def _predict(self, params, field, x, t):
        """The model on field[:, :time_history] as (B, X, T, C); returns
        (B, T, X, C)."""
        inp = field[:, :self.time_history].permute(0, 2, 1, 3)
        return functional_call(self.model, params, (inp, *self._coords(x, t)))

    def _metrics(self, split: str, pred, target, pred_un, target_un, pde, pde_gt):
        down = self.down_factor if split == "test" else 1
        return {f"{split}_loss": self.criterion(pred, target),
                f"{split}_mae_u": losses.downsampled_loss(pred, target, down),
                f"{split}_mae_u_un": losses.downsampled_loss(pred_un, target_un, down),
                f"{split}_corr": torch.mean(losses.correlation(pred, target)),
                f"{split}_mae_u_scaled": losses.scaled_mae_loss(pred, target),
                f"{split}_pde_loss": pde, f"{split}_pde_loss_gt": pde_gt}


class FnoStateReconstrTask(FnoTaskBase):
    """Reconstruct the unobserved state s from the observed field u over the
    first time_history steps. Batch (u, x, t, s) with u, s (B, T, X, C)."""

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        self._tn_mult = self.time_history / 128
        super().set_pde_loss_function(system, flip_xy)

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None):
        """Returns (new state, {"train_loss", "train_mae_u", "train_mae_u_un",
        "grad_norm"}), the norm before clipping."""
        u, x, t, s = batch
        s, s_unnorm = self._pair_target(state, s)
        s_gt = s[:, :self.time_history]

        def loss_fn(params):
            pred = self._predict(params, u, x, t)
            return self.criterion(pred, s_gt), pred

        new, loss, norm, pred = optimizer_step(self.tx, state, loss_fn)
        pred = pred.detach()
        pred_un = state.normalizer_target(pred, inverse=True)
        return new, {"train_loss": loss, "train_mae_u": mae(pred, s_gt),
                     "train_mae_u_un": mae(pred_un, s_unnorm[:, :self.time_history]),
                     "grad_norm": norm}

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator=None, split: str = "val"):
        """The reference's seven {split}_* metrics and the prediction (B,
        time_history, X, C); down_factor applies at `test` only."""
        u, x, t, s = batch
        s, s_unnorm = self._pair_target(state, s)
        t_hist = self.time_history
        s_gt, u_hist = s[:, :t_hist], u[:, :t_hist]
        pred = self._predict(state.params, u, x, t)
        pred_un = state.normalizer_target(pred, inverse=True)
        metrics = self._metrics(split, pred, s_gt, pred_un, s_unnorm[:, :t_hist],
                                self._pde(state, u_hist, pred),
                                self._pde(state, u_hist, s_gt))
        return metrics, pred

    def _pde(self, state: TaskState, cond, pred):
        x_un = torch.cat([state.normalizer_input(cond, inverse=True),
                          state.normalizer_target(pred, inverse=True)], dim=-1)
        m = self.pde_loss(x_un, x_un, state.normalizer_input,
                          state.normalizer_target, clamp_loss=False)
        return torch.sum(m) / cond.shape[0]


class FnoTimePredTask(FnoTaskBase):
    """Predict the future (u, s) from the first time_history steps of the
    field [u, s]; the PDE residual keeps Tn_mult 1, as the JAX task does."""

    def _split_unnorm(self, state: TaskState, pred, u_ch: int):
        u_pred, s_pred = pred[..., :u_ch], pred[..., u_ch:]
        u_un = state.normalizer_input(u_pred, inverse=True) if self.norm_input else u_pred
        s_un = state.normalizer_target(s_pred, inverse=True) if self.norm_target else s_pred
        return torch.cat([u_un, s_un], dim=-1)

    def _fields(self, state: TaskState, batch):
        u, x, t, s = batch
        u, u_unnorm = self._pair_input(state, u)
        s, s_unnorm = self._pair_target(state, s)
        return (torch.cat([u, s], dim=-1), torch.cat([u_unnorm, s_unnorm], dim=-1),
                x, t, u.shape[-1])

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None):
        field, full_un, x, t, u_ch = self._fields(state, batch)
        target = field[:, self.time_history:]

        def loss_fn(params):
            pred = self._predict(params, field, x, t)
            return self.criterion(pred, target), pred

        new, loss, norm, pred = optimizer_step(self.tx, state, loss_fn)
        pred = pred.detach()
        pred_un = self._split_unnorm(state, pred, u_ch)
        return new, {"train_loss": loss, "train_mae_u": mae(pred, target),
                     "train_mae_u_un": mae(pred_un, full_un[:, self.time_history:]),
                     "grad_norm": norm}

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator=None, split: str = "val"):
        """The seven {split}_* metrics and [history | prediction] unnormalized
        (B, T, X, C_u + C_s)."""
        field, full_un, x, t, u_ch = self._fields(state, batch)
        t_hist = self.time_history
        target = field[:, t_hist:]
        pred = self._predict(state.params, field, x, t)
        pred_un = self._split_unnorm(state, pred, u_ch)
        pred_full_un = torch.cat([full_un[:, :t_hist], pred_un], dim=1)
        metrics = self._metrics(split, pred, target, pred_un, full_un[:, t_hist:],
                                self._pde_unnorm(state, pred_full_un),
                                self._pde_unnorm(state, full_un))
        return metrics, pred_full_un

    def _pde_unnorm(self, state: TaskState, x_un):
        m = self.pde_loss(x_un, x_un, state.normalizer_input,
                          state.normalizer_target, clamp_loss=False)
        return torch.sum(m) / x_un.shape[0]


class FnoStateTimePredTask:
    """Two stages: reconstruct the states, then predict the future. Test
    only, from two trained states (the reference has test_step only)."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS, grad_clip=None,
                 steps_per_epoch=None):
        self.device = torch.device(device)
        self.model_state = FnoStateReconstrTask(hparams["hparams_state"], device)
        self.model_time = FnoTimePredTask(hparams["hparams_time"], device)
        self.time_history = hparams.get("time_history", 128)
        self.flip_xy = False
        self.down_factor = 1
        self.pde_loss, _ = get_pde_loss_function("swe", False)

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        """flip_xy orders the fields; the residual itself is not flipped, as
        in the JAX task."""
        self.flip_xy = flip_xy
        self.pde_loss, _ = get_pde_loss_function(system, False)

    @torch.no_grad()
    def test_step(self, state_reconstr: TaskState, state_time: TaskState, batch):
        """Returns the five test_* metrics and [history | prediction]
        unnormalized. Both normalizations come from state_reconstr, as in the
        JAX task."""
        u, x, t, s = batch
        state = state_reconstr
        task_s, task_t = self.model_state, self.model_time
        u, u_unnorm = task_t._pair_input(state, u)
        s, s_unnorm = task_t._pair_target(state, s)
        t_hist, down = self.time_history, self.down_factor
        s_ch, u_ch = s.shape[-1], u.shape[-1]

        s_hat = task_s._predict(state_reconstr.params, u, x, t)
        s_hat_un = state.normalizer_target(s_hat, inverse=True)
        mae_rec = losses.downsampled_loss(s_hat_un, s_unnorm[:, :t_hist], down)

        u_hist = u[:, :t_hist]
        field = torch.cat([s_hat, u_hist] if self.flip_xy else [u_hist, s_hat], dim=-1)
        pred = task_t._predict(state_time.params, field, x, t)

        mask = torch.ones_like(torch.cat([u_unnorm, s_unnorm], dim=-1))
        if self.flip_xy:
            full_un = torch.cat([s_unnorm, u_unnorm], dim=-1)
            pred_un = torch.cat([state.normalizer_target(pred[..., :s_ch], inverse=True),
                                 state.normalizer_input(pred[..., s_ch:], inverse=True)],
                                dim=-1)
            hist_un = torch.cat([s_hat_un, u_unnorm[:, :t_hist]], dim=-1)
            mask[:, :t_hist, :, s_ch:] = 0.0
            norm_a, norm_b = state.normalizer_target, state.normalizer_input
        else:
            full_un = torch.cat([u_unnorm, s_unnorm], dim=-1)
            pred_un = torch.cat([state.normalizer_input(pred[..., :u_ch], inverse=True),
                                 state.normalizer_target(pred[..., u_ch:], inverse=True)],
                                dim=-1)
            hist_un = torch.cat([u_unnorm[:, :t_hist], s_hat_un], dim=-1)
            mask[:, :t_hist, :, :u_ch] = 0.0
            norm_a, norm_b = state.normalizer_input, state.normalizer_target

        mae_pred = losses.downsampled_loss(pred_un, full_un[:, t_hist:], down)
        pred_full_un = torch.cat([hist_un, pred_un], dim=1)
        b = u.shape[0]
        pde = torch.sum(self.pde_loss(pred_full_un, pred_full_un, norm_a, norm_b,
                                      clamp_loss=False)) / b
        pde_gt = torch.sum(self.pde_loss(full_un, full_un, norm_a, norm_b,
                                         clamp_loss=False)) / b
        metrics = {"test_mae_un_rec": mae_rec, "test_mae_un_pred": mae_pred,
                   "test_mae_un": losses.masked_loss(pred_full_un, full_un, mask),
                   "test_pde_loss": pde, "test_pde_loss_gt": pde_gt}
        return metrics, pred_full_un


class Fno2dTask(FnoTaskBase):
    """Autoregressive FNO stepper over chunks of time_future frames, teacher
    forced in training (when teacher_forcing) and free running in eval.
    Batch (u, dx, dy, dt) with u (B, H, W, T) and (B,) spacings."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS, grad_clip=None,
                 steps_per_epoch=None):
        super().__init__(hparams, device, ops, grad_clip, steps_per_epoch)
        self.teacher_forcing = hparams.get("teacher_forcing", True)

    def _build_model(self):
        return Fno2d(self.cfg)

    def _rollout(self, params, u, dx, dy, dt, teacher_forcing: bool):
        t_hist, t_fut = self.cfg.time_history, self.cfg.time_future
        u_future = u[..., t_hist:]
        preds, inp = [], u[..., :t_hist]
        for i in range(u_future.shape[-1] // t_fut):
            y = functional_call(self.model, params, (inp, dx, dy, dt))
            preds.append(y)
            inp = u_future[..., i * t_fut:(i + 1) * t_fut] if teacher_forcing else y
        return torch.cat(preds, dim=-1), u_future

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None):
        u, dx, dy, dt = batch

        def loss_fn(params):
            pred, target = self._rollout(params, u, dx, dy, dt, self.teacher_forcing)
            return self.criterion(pred, target), pred - target

        new, loss, norm, diff = optimizer_step(self.tx, state, loss_fn)
        return new, {"train_loss": loss, "train_mae_loss": torch.mean(torch.abs(diff.detach())),
                     "grad_norm": norm}

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator=None, split: str = "val"):
        """The free-running rollout's loss and MAE. The keys are val_*
        whatever the split, as the JAX package's Fno2dTask returns them."""
        u, dx, dy, dt = batch
        pred, target = self._rollout(state.params, u, dx, dy, dt, False)
        return {"val_loss": self.criterion(pred, target),
                "val_mae_loss": mae(pred, target)}, pred
