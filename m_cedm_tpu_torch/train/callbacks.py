"""Host-side callbacks: prediction plots and sample dumps (port of
m_cedm_tpu/train/callbacks.py; numpy, and matplotlib imported when a plot is
drawn).

Parity targets (reference callbacks/custom_callbacks.py):
  PlotModelPredictions   (:17-120)  pred/target(/|error|) imshow panels
  PlotDiffusionTrajectory (:123-270) per-repeat trajectory panels
  SaveGeneratedSamples   (:273-355)  first-N test outputs -> *_gen.npy/_gt.npy
  SaveFullGeneratedSamples (:358-404) all test outputs

Callbacks receive host numpy via `on_eval_batch(outputs, batch_idx, split)`
and `on_eval_end(epoch, split)` hooks from the Trainer; figures are written
as PNGs under <out_dir>/plots (and to wandb when active). Everything runs on
the host.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from m_cedm_tpu_torch.config import register
from m_cedm_tpu_torch.utils import is_main_process


def _save_figure(fig, out_dir: str, name: str, wandb_run=None):
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=100,
                bbox_inches="tight")
    if wandb_run is not None:
        import wandb

        wandb_run.log({name: wandb.Image(fig)})


def _set_colorbar(fig, ax, im, add_colorbar):
    if add_colorbar:
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        divider = make_axes_locatable(ax)
        cax = divider.append_axes("right", size="4%", pad=0.05)
        fig.colorbar(im, cax=cax, orientation="vertical")


class Callback:
    out_dir: str = "plots"
    wandb_run = None

    def setup(self, out_dir: str, wandb_run=None):
        self.out_dir = os.path.join(out_dir, "plots")
        self.wandb_run = wandb_run

    def on_eval_batch(self, outputs: Dict, batch_idx: int, split: str):
        pass

    def on_eval_end(self, epoch: int, split: str):
        pass


@register("callbacks.custom_callbacks.PlotModelPredictions",
          "m_cedm_tpu.train.callbacks.PlotModelPredictions")
class PlotModelPredictions(Callback):
    """pred / target (/ |error|) imshow grids for supervised models."""

    def __init__(self, num_samples=5, log_every=100):
        self.num_samples = num_samples
        self.log_every = log_every
        self._pred = None
        self._gt = None

    def on_eval_batch(self, outputs, batch_idx, split):
        if "pred" not in outputs or "target" not in outputs:
            return
        pred = np.asarray(outputs["pred"])
        gt = np.asarray(outputs["target"])
        if split == "val":
            if batch_idx == 0:
                self._pred = pred[: self.num_samples]
                self._gt = gt[: self.num_samples]
        else:
            cur = 0 if self._gt is None else len(self._gt)
            take = max(self.num_samples - cur, 0)
            if take:
                self._pred = (pred[:take] if self._pred is None
                              else np.concatenate([self._pred, pred[:take]]))
                self._gt = (gt[:take] if self._gt is None
                            else np.concatenate([self._gt, gt[:take]]))

    def on_eval_end(self, epoch, split):
        if self._pred is None or not is_main_process():
            self._pred = self._gt = None
            return
        if split == "val" and epoch % self.log_every != 0:
            self._pred = self._gt = None
            return
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plot_error = split == "test"
        for i in range(len(self._pred)):
            pred_i, target_i = self._pred[i], self._gt[i]
            n_vars = pred_i.shape[-1]
            n_cols = 3 if plot_error else 2
            fig, axs = plt.subplots(n_vars, n_cols, figsize=(3 * n_cols, 3 * n_vars),
                                    squeeze=False, sharex=True, sharey=True)
            for j in range(n_vars):
                im1 = axs[j, 0].imshow(pred_i[..., j].T, cmap="jet")
                _set_colorbar(fig, axs[j, 0], im1, True)
                im2 = axs[j, 1].imshow(target_i[..., j].T, cmap="jet")
                _set_colorbar(fig, axs[j, 1], im2, True)
                if plot_error:
                    im3 = axs[j, 2].imshow(np.abs(pred_i - target_i)[..., j].T,
                                           cmap="Greys")
                    _set_colorbar(fig, axs[j, 2], im3, True)
            axs[0, 0].set_title("pred 0")
            axs[0, 1].set_title("target 0")
            _save_figure(fig, self.out_dir, f"{split}_prediction_{i:02d}_e{epoch}",
                         self.wandb_run)
            plt.close(fig)
        self._pred = self._gt = None


@register("callbacks.custom_callbacks.PlotDiffusionTrajectory",
          "m_cedm_tpu.train.callbacks.PlotDiffusionTrajectory")
class PlotDiffusionTrajectory(Callback):
    """Diffusion sample panels: per-repeat predictions + target + error.

    Accepts `traj`/`gt` outputs or per-task `traj_<name>`/`gt_<name>` pairs
    (the mcedm eval emits one pair per mask task)."""

    def __init__(self, num_samples=5, log_every=100):
        self.num_samples = num_samples
        self.log_every = log_every
        self._traj = None
        self._gt = None

    def _append(self, traj, gt, limit):
        take = min(limit, len(traj))
        if take <= 0:
            return
        if self._traj is None:
            self._traj, self._gt = traj[:take], gt[:take]
        else:
            self._traj = np.concatenate([self._traj, traj[:take]])
            self._gt = np.concatenate([self._gt, gt[:take]])

    def on_eval_batch(self, outputs, batch_idx, split):
        keys = [k for k in outputs if k.startswith("traj")]
        for k in keys:
            suffix = k[len("traj"):]
            gt_key = "gt" + suffix
            if gt_key not in outputs:
                continue
            traj = np.asarray(outputs[k])
            gt = np.asarray(outputs[gt_key])
            if split == "val" and batch_idx > 0:
                continue
            cur = 0 if self._gt is None else len(self._gt)
            # allow num_samples per task key (mcedm emits traj_u / traj_h)
            self._append(traj, gt, max(self.num_samples * len(keys) - cur, 0))

    def on_eval_end(self, epoch, split):
        if self._traj is None or not is_main_process():
            self._traj = self._gt = None
            return
        if split == "val" and epoch % self.log_every != 0:
            self._traj = self._gt = None
            return
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plot_error = split == "test"
        traj, gt = self._traj, self._gt
        for i in range(len(traj)):
            pred = traj[i, -1]  # last diffusion step
            target = gt[i]
            if pred.ndim < 4:
                pred = pred[:, :, None, :]  # add repeats axis
            n_vars = pred.shape[-1]
            n_repeats = pred.shape[2]
            n_cols = n_repeats + 2 if plot_error else n_repeats + 1
            fig, axs = plt.subplots(n_vars, n_cols,
                                    figsize=(3.5 * n_cols, 3 * n_vars),
                                    squeeze=False, sharex=True, sharey=True)
            for j in range(n_vars):
                vmin = min(pred[..., j].min(), target[..., j].min())
                vmax = max(pred[..., j].max(), target[..., j].max())
                for k in range(n_repeats):
                    im = axs[j, k].imshow(pred[..., k, j].T, vmin=vmin,
                                          vmax=vmax, cmap="jet")
                    _set_colorbar(fig, axs[j, k], im, True)
                im2 = axs[j, n_repeats].imshow(target[..., j].T, vmin=vmin,
                                               vmax=vmax, cmap="jet")
                _set_colorbar(fig, axs[j, n_repeats], im2, True)
                if plot_error:
                    err = np.abs(pred[..., -1, :] - target)[..., j]
                    im3 = axs[j, n_repeats + 1].imshow(err.T, cmap="Greys")
                    _set_colorbar(fig, axs[j, n_repeats + 1], im3, True)
            axs[0, 0].set_title("pred 0")
            axs[0, n_repeats].set_title("target 0")
            _save_figure(fig, self.out_dir, f"{split}_traj_{i:02d}_e{epoch}",
                         self.wandb_run)
            plt.close(fig)
        self._traj = self._gt = None


@register("callbacks.custom_callbacks.SaveGeneratedSamples",
          "m_cedm_tpu.train.callbacks.SaveGeneratedSamples")
class SaveGeneratedSamples(Callback):
    """Accumulate the first num_samples eval outputs; dump *_gen.npy/_gt.npy."""

    def __init__(self, num_samples=5, dirpath=None, traj_name="traj",
                 gt_name="gt"):
        self.num_samples = num_samples
        self.dirpath = dirpath
        self.traj_name = traj_name
        self.gt_name = gt_name
        self._traj = None
        self._gt = None

    def on_eval_batch(self, outputs, batch_idx, split):
        if self.traj_name not in outputs or self.gt_name not in outputs:
            return
        traj = np.asarray(outputs[self.traj_name])
        gt = np.asarray(outputs[self.gt_name])
        cur = 0 if self._gt is None else len(self._gt)
        take = max(self.num_samples - cur, 0)
        if split == "val":
            if batch_idx == 0:
                self._traj, self._gt = traj[: self.num_samples], gt[: self.num_samples]
        elif take:
            self._traj = (traj[:take] if self._traj is None
                          else np.concatenate([self._traj, traj[:take]]))
            self._gt = (gt[:take] if self._gt is None
                        else np.concatenate([self._gt, gt[:take]]))

    def on_eval_end(self, epoch, split):
        if self._traj is None or not is_main_process():
            self._traj = self._gt = None
            return
        out = self.dirpath or os.path.join(self.out_dir, "..", "samples")
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, f"{split}_gen.npy"), self._traj)
        np.save(os.path.join(out, f"{split}_gt.npy"), self._gt)
        self._traj = self._gt = None


@register("callbacks.custom_callbacks.SaveFullGeneratedSamples",
          "m_cedm_tpu.train.callbacks.SaveFullGeneratedSamples")
class SaveFullGeneratedSamples(SaveGeneratedSamples):
    """Accumulate ALL test outputs (no cap)."""

    def __init__(self, dirpath=None, traj_name="traj", gt_name="gt"):
        super().__init__(num_samples=int(1e9), dirpath=dirpath,
                         traj_name=traj_name, gt_name=gt_name)
