"""OFormer tasks (port of m_cedm_tpu/tasks/oformer.py).

  OformerTask               space-time token reconstruction
  OformerTimePredTask       future prediction: history tokens in, future
                            tokens out, normalizers over the (u, s) channels
  OformerStateTimePredTask  reconstruct the history, then predict the
                            future: test-only, from two trained states

    task = build_task(hparams, device, target="m_cedm_tpu.tasks.OformerTask",
                      grad_clip=2.0, steps_per_epoch=None, max_epochs=None)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, batch, generator)
    metrics, grid_pred = task.eval_step(state, batch, split="val")

The reconstruction's batch = (x, y, node_type, pos, n_time) as the OFormer
datamodule gives it (data.oformer_data.tokenize_grid): x (B, 1, T*X, C_in),
y (B, 1, T*X, C_out), node_type (B, T*X, 1), pos (B, T*X, 2), n_time (B,).
The time prediction's = (x, y, node_type_inp, node_type_prop, input_pos,
prop_pos, n_time) with separate input (history) and propagate (future)
tokens (data.oformer_data.PlOformerSwpTimePredDatamodule).

Training is the MSE of `_criterion` (sum over channels, mean over the rest),
the global-norm clip, and AdamW with weight decay on every trainable
parameter, at a constant lr or, given a schedule length, on optax's
cosine one-cycle schedule. The state is functional: `train_step` returns a
new TaskState.

bf16 (`dtype: bfloat16` in the hparams, which run.py sets for
`trainer.precision=bf16`): the model computes in bf16 (models/oformer.py)
on params rounded inside the autograd graph (`compute_params`), so each
gradient is rounded to bf16 once on its way back; params, AdamW state,
normalizers, the Fourier matrix, the loss and the metrics stay fp32.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.oformer import (Embed, LayerNorm,
                                             OformerDecoderConfig,
                                             OformerEncoderConfig,
                                             OformerModel)
from m_cedm_tpu_torch.ops import losses
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.ops.schedules import cosine_onecycle
from m_cedm_tpu_torch.physics.pde_loss import get_pde_loss_function
from m_cedm_tpu_torch.tasks.base import (Optimizer, Params, TaskState,
                                         cast_floating, mae,
                                         normalizers_from_stats, optimizer_step,
                                         to_device)


def fp32_param_names(model: torch.nn.Module) -> frozenset:
    """The params a bf16 forward of `model` reads in fp32: LayerNorm's scale
    and bias and the embeddings, as flax keeps them in a bf16 model."""
    return frozenset(f"{name}.{p}" for name, m in model.named_modules()
                     if isinstance(m, (LayerNorm, Embed))
                     for p, _ in m.named_parameters(recurse=False))


def compute_params(params: Params, keep: frozenset, dtype: torch.dtype) -> Params:
    """The params as a `dtype` forward reads them: each floating tensor
    rounded to `dtype` (`cast_floating`) but those named in `keep`
    (`fp32_param_names`). On requires_grad masters the casts are part of the
    autograd graph, so each gradient is rounded to `dtype` once on its way
    back to fp32, as the transpose of JAX's cast rounds it."""
    cast = cast_floating({k: v for k, v in params.items() if k not in keep}, dtype)
    return {k: cast.get(k, v) for k, v in params.items()}


class OformerTask:
    """Space-time token reconstruction with the OFormer encoder/decoder."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS,
                 grad_clip: Optional[float] = 2.0,
                 steps_per_epoch: Optional[int] = None,
                 max_epochs: Optional[int] = None):
        hparams = copy.deepcopy(hparams)
        self.hparams = hparams
        # bf16 compute on fp32 masters, as the JAX task reads hparams['dtype']
        self.compute_dtype = (torch.bfloat16 if hparams.get("dtype", "float32")
                              in ("bfloat16", "bf16") else None)
        self.device = torch.device(device)
        self.enc_cfg = OformerEncoderConfig.from_hparams(hparams["encoder"])
        self.dec_cfg = OformerDecoderConfig.from_hparams(hparams["decoder"])
        self.model = OformerModel(self.enc_cfg, self.dec_cfg, ops).to(self.device)
        self.fp32_params = fp32_param_names(self.model) if self.compute_dtype else None
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
            n_in, n_tar = self._build_normalizers(norm_stats)
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

    def _build_normalizers(self, stats) -> Tuple[Normalizer, Normalizer]:
        return normalizers_from_stats(stats, "gauss", self.device)

    # -- forward ------------------------------------------------------------

    @staticmethod
    def _unpack(batch):
        """(x, y, node_type_inp, node_type_prop, input_pos, prop_pos): the
        same tokens in and out."""
        x, y, node_type, pos, _ = batch
        return x, y, node_type, node_type, pos, pos

    def apply(self, state: TaskState, params, x, nt_inp, nt_prop, in_pos, pr_pos,
              forward_steps: int, dropout_keep=None) -> torch.Tensor:
        """The model with `params` and the state's constants swapped in; with
        a compute dtype, params and x cast to it (the positions stay fp32).
        The prediction is fp32."""
        if self.compute_dtype is not None:
            params = compute_params(params, self.fp32_params, self.compute_dtype)
            x = x.to(self.compute_dtype)
        return functional_call(self.model, {**params, **state.constants},
                               (x, nt_inp, nt_prop, in_pos, pr_pos, forward_steps),
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
        x, y, *tokens = self._unpack(batch)
        c_steps = self._curriculum_forward_steps(state.step, int(y.shape[1]))
        y_norm, _ = self._pair_target(state, y[:, :c_steps])
        rate = self.dec_cfg.dropout
        if dropout_keep is None and rate > 0:
            b, t, n = x.shape[:3]
            shape = (b, n * (t // self.enc_cfg.time_window), self.enc_cfg.out_channels)
            dropout_keep = torch.rand(shape, generator=generator,
                                      device=x.device) < 1.0 - rate

        def loss_fn(params):
            pred = self.apply(state, params, x, *tokens, c_steps, dropout_keep)
            return self._criterion(pred, y_norm), None

        new, loss, norm, _ = optimizer_step(self.tx, state, loss_fn)
        return new, {"train_loss": loss, "grad_norm": norm}

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator=None, split: str = "val"):
        """One forward over every step of y; returns (metrics, grid_pred) with
        the reference keys {split}_loss, _mae_u, _mae_u_un, _corr,
        _mae_u_scaled and, for one-step targets, _pde_loss and _pde_loss_gt;
        grid_pred is the prediction as (B, n_time, X, C)."""
        x, y, *tokens = self._unpack(batch)
        n_time = int(batch[-1][0])
        y_norm, y_unnorm = self._pair_target(state, y)
        pred = self.apply(state, state.params, x, *tokens, int(y.shape[1]))
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


class OformerTimePredTask(OformerTask):
    """Future prediction: the history tokens in, the future tokens out. The
    normalizers span the concatenated (u, s) channels; the PDE residual of
    [history | prediction] is scaled by the per-state normalizers."""

    normalizer_state1: Optional[Normalizer] = None
    normalizer_state2: Optional[Normalizer] = None

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        self.pde_loss, _ = get_pde_loss_function(system, flip_xy)

    def _build_normalizers(self, stats) -> Tuple[Normalizer, Normalizer]:
        vec = lambda v: np.asarray(v, np.float32).reshape(-1)
        self.normalizer_state1 = Normalizer.gauss(
            np.float32(stats["input_mean"]), np.float32(stats["input_std"]), self.device)
        self.normalizer_state2 = Normalizer.gauss(
            np.float32(stats["target_mean"]), np.float32(stats["target_std"]), self.device)
        n = Normalizer.gauss(np.concatenate([vec(stats["input_mean"]),
                                             vec(stats["target_mean"])]),
                             np.concatenate([vec(stats["input_std"]),
                                             vec(stats["target_std"])]), self.device)
        return n, n

    @staticmethod
    def _unpack(batch):
        x, y, nt_inp, nt_prop, in_pos, pr_pos, _ = batch
        return x, y, nt_inp, nt_prop, in_pos, pr_pos

    def _pde_metrics(self, state, x, pred, y_norm, n_time: int, split: str):
        """Without statistics (no per-state normalizers) or for more than
        one step, none, as in the JAX task."""
        if pred.shape[1] != 1 or self.normalizer_state1 is None:
            return {}
        b, c = pred.shape[0], pred.shape[-1]
        pred_g = pred.reshape(b, n_time, -1, c)
        y_g = y_norm.reshape(b, n_time, -1, c)
        x_in = x.reshape(b, -1, pred_g.shape[2], x.shape[-1])[..., :c]

        def residual(future):
            full = state.normalizer_target(torch.cat([x_in, future], dim=1), inverse=True)
            return torch.sum(self.pde_loss(full, full, self.normalizer_state1,
                                           self.normalizer_state2, clamp_loss=False)) / b

        return {f"{split}_pde_loss": residual(pred_g),
                f"{split}_pde_loss_gt": residual(y_g)}


class OformerStateTimePredTask:
    """Two stages: reconstruct the unobserved state over the history window,
    then predict the future from [observed, reconstructed]. Test only, from
    two trained states."""

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS, grad_clip=None,
                 steps_per_epoch=None, max_epochs=None):
        self.device = torch.device(device)
        self.model_state = OformerTask(hparams["hparams_state"], device, ops)
        self.model_time = OformerTimePredTask(hparams["hparams_time"], device, ops)
        self.time_history = hparams.get("time_history", 64)
        self.down_factor = 1
        self.pde_loss, _ = get_pde_loss_function("swe", False)

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        self.pde_loss, _ = get_pde_loss_function(system, flip_xy)
        self.model_state.set_pde_loss_function(system, flip_xy)
        self.model_time.set_pde_loss_function(system, flip_xy)

    @torch.no_grad()
    def test_step(self, state_reconstr: TaskState, state_time: TaskState,
                  reconstr_batch, timepred_batch):
        """Stage 1 reconstructs the history window's tokens of the
        reconstruction batch; stage 2 predicts the time-prediction batch's
        future from [u_hist, s_hat, coords]. Returns the three test_* metrics
        and the prediction (B, 1, tokens, C)."""
        x, y, node_type, pos, n_time = reconstr_batch
        n_time, n_hist, b = int(n_time[0]), self.time_history, x.shape[0]

        def history(a):
            a = a.reshape(b, n_time, -1, a.shape[-1])[:, :n_hist]
            return a.reshape(b, -1, a.shape[-1])

        x_hist = history(x)[:, None]
        nt, ps = history(node_type), history(pos)
        s_hat = self.model_state.apply(state_reconstr, state_reconstr.params,
                                       x_hist, nt, nt, ps, ps, 1)

        _, yt, *tokens = self.model_time._unpack(timepred_batch)
        u_ch = x.shape[-1] - 2  # the t, x coordinate channels dropped
        state_in = torch.cat([x_hist[..., :u_ch], s_hat, x_hist[..., u_ch:]], dim=-1)
        pred = self.model_time.apply(state_time, state_time.params, state_in, *tokens, 1)

        y_hist = history(y)[:, None]
        _, y_unnorm = self.model_time._pair_target(state_time, yt)
        pred_un = state_time.normalizer_target(pred, inverse=True)
        mae_pred = mae(pred_un, y_unnorm)
        return {"test_mae_un_rec": mae(state_reconstr.normalizer_target(s_hat, inverse=True),
                                       state_reconstr.normalizer_target(y_hist, inverse=True)),
                "test_mae_un_pred": mae_pred, "test_mae_un": mae_pred}, pred
