"""Diffusion tasks (port of m_cedm_tpu/tasks/diffusion.py):
DiffusionTaskBase, McedmTask (the paper's mixed-conditional EDM: training
and serving), and the serving path of the single-task conditional EDM
baseline CondEdmTask with the pieces of DdimTask / CondDdimTask it inherits.

    task = build_task(hparams, device)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, batch, generator)
    metrics, hu_mean = task.eval_step(state, batch, generator, mask,
                                      split="test", mask_name="u")
    ctask = build_task(cond_hparams, device, target=COND_EDM_TARGET, mega=True)
    metrics, u_mean = ctask.eval_step(cstate, batch, generator, split="test")

`mega=True` runs the U-Net's sampling forwards through the whole-block K7.
The state is functional, as in the JAX package: `train_step` returns a new
TaskState and leaves its argument as it was. The DDIM/RePaint samplers, the
conditional tasks' training and the other task classes come in later slices
(ROADMAP.md).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from m_cedm_tpu_torch.data.masks import TRAIN_MASK_SAMPLERS
from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.ops import losses
from m_cedm_tpu_torch.ops.losses import scale_each_min_max
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.ops.schedules import (alphas_cumprod_from_betas,
                                            edm_loss_weight, edm_precond_coeffs,
                                            edm_train_sigma, get_beta_schedule)
from m_cedm_tpu_torch.physics.pde_loss import get_pde_loss_function
from m_cedm_tpu_torch.samplers import edm as edm_samplers
from m_cedm_tpu_torch.tasks.base import (DataTransform, TaskState,
                                         apply_updates, ema_update, ensemble,
                                         fold_members, fold_noise, global_norm,
                                         mae, make_optimizer,
                                         normalizers_from_stats, to_device)

P_MEAN, P_STD, SIGMA_DATA = -1.2, 1.2, 1.0
SIGMA_MIN, SIGMA_MAX = 0.002, 80.0

DEFAULT_EDM_SAMPLER = dict(
    name="edm", type="edm", timesteps=50, sigma_min=0.002, sigma_max=80,
    rho=7, S_churn=15.0, S_min=0, S_max="inf", S_noise=1, n_samples=1,
    n_repeat=2, n_time_h=128, n_time_u=0, return_last=True,
    select_by_pde=False, use_gt_pde_select=True, guide_dx=False, w=0.0,
    plot_scaled=False)

DEFAULT_DDIM_SAMPLER = dict(
    name="ddim", type="ddim", timesteps=50, skip_type="uniform", eta=0.0,
    n_samples=1, n_repeat=5, n_time_h=128, n_time_u=0, return_last=True,
    select_by_pde=False, use_gt_pde_select=True, guide_dx=False, w=0.0,
    plot_scaled=False)


def _edm_precond(task, params, x_noise, sigma, cond):
    """D(x) = c_skip x + c_out F(c_in x, c_noise; cond): the EDM denoiser."""
    sigma = sigma.to(torch.float32).reshape(-1, 1, 1, 1)
    c_skip, c_out, c_in, c_noise = edm_precond_coeffs(sigma, SIGMA_DATA)
    f_x = task.net_apply(params, c_in * x_noise, c_noise.reshape(-1), cond)
    return c_skip * x_noise + c_out * f_x


class DiffusionTaskBase:
    """Shared machinery: backbone, transforms, optimizer, EMA, PDE loss.
    `mega` selects the U-Net's megakernel mode for the sampling forwards."""

    default_cond_p = 0.0
    # sampling-based validation runs every 100 epochs (mcedm.py:284)
    val_every = 100

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS,
                 grad_clip: Optional[float] = 1.0, mega: bool = False):
        hparams = copy.deepcopy(hparams)
        self.hparams = hparams
        self.device = torch.device(device)
        m = hparams["model"]
        self.h_ch, self.u_ch = self._channel_split(hparams)
        self.self_condition = m.get("self_cond", False)
        self.node_type = m.get("node_type", False)
        self.dx_cond = m.get("dx_cond", False)
        self.add_cond_mask = m.get("add_cond_mask", False)
        self.add_xt = m.get("add_xt", False)
        self.ema_enabled = m.get("ema", True)
        self.ema_rate = m.get("ema_rate", 0.999)
        self.cond_p = m.get("cond_p", self.default_cond_p)
        if m.get("dtype", "float32") in ("bfloat16", "bf16"):
            raise NotImplementedError("bf16 compute is not ported yet (see ROADMAP.md)")
        self._adjust_cond_channels(hparams)
        self.model, self.model_cfg = build_backbone(hparams, ops, mega=mega)
        self.model.to(self.device).eval()
        self.transform = DataTransform(hparams["data"])
        opt_cfg = hparams.get("optimization")
        # a serving-only config may leave the optimizer out
        self.tx = make_optimizer(opt_cfg, grad_clip) if opt_cfg else None
        self.pde_loss, _ = get_pde_loss_function("swe", flip_xy=False)
        self.sparams = hparams.get("sampler") or self.default_sampler_params()
        self.test_sparams = self.sparams
        # val/test subsampling factor; the training loop sets it from the
        # datamodule and builds the test's down mask from it
        self.down_factor = 1

    def set_pde_loss_function(self, system: str, flip_xy: bool):
        """The PDE residual of the metrics for the data's `system` (e.g.
        swe_per: Tn 0.128 on [-0.5, 0.5]) and its variable order."""
        self.pde_loss, _ = get_pde_loss_function(system, flip_xy)

    def set_test_sampler_params(self, sparams):
        self.test_sparams = sparams

    def default_sampler_params(self):
        return dict(DEFAULT_DDIM_SAMPLER)

    def _channel_split(self, hparams) -> Tuple[int, int]:
        ch = max(hparams["model"]["out_ch"] // 2, 1)
        return ch, ch

    def _adjust_cond_channels(self, hparams):
        pass

    def init_state(self, generator: Optional[torch.Generator], norm_stats=None,
                   params=None, *, ema_params=None, opt_state=None,
                   step: int = 0) -> TaskState:
        """A state on the task's device: `params` (a state_dict, e.g. from
        convert.jax_params_to_state_dict) or a fresh ADM init drawn from
        `generator`; identity normalizers unless `norm_stats` are given. The
        EMA starts as a copy of the params, the optimizer state fresh, unless
        `ema_params` / `opt_state` / `step` carry a state across (e.g. from
        convert.jax_train_state_to_torch)."""
        if params is None:
            self.model.reset_parameters(generator)
            params = self.model.state_dict()
        params = to_device(params, self.device)
        if norm_stats is not None:
            n_in, n_tar = normalizers_from_stats(
                norm_stats, self.transform.normalization, self.device)
        else:
            n_in = Normalizer.identity((), self.device)
            n_tar = Normalizer.identity((), self.device)
        ema = None
        if self.ema_enabled:
            ema = to_device(params if ema_params is None else ema_params, self.device)
        if opt_state is not None:
            opt_state = to_device(opt_state, self.device)
        elif self.tx is not None:
            opt_state = self.tx.init(params)
        return TaskState(params=params, ema_params=ema, normalizer_input=n_in,
                         normalizer_target=n_tar, opt_state=opt_state,
                         step=int(step))

    def _sample_params(self, state: TaskState):
        return state.ema_params if self.ema_enabled else state.params

    def net_apply(self, params, x, t, cond=None) -> torch.Tensor:
        """The backbone with `params` swapped in; fp32 in and out."""
        return functional_call(self.model, params, (x, t, cond)).float()

    def finish_step(self, state: TaskState, grads, metrics):
        """Optimizer update, then the EMA of the new params (`_finish_step`)."""
        if self.tx is None:
            raise ValueError("training needs the config's `optimization` section")
        updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
        ema = (ema_update(state.ema_params, params, self.ema_rate)
               if self.ema_enabled else None)
        return dataclasses.replace(state, params=params, ema_params=ema,
                                   opt_state=opt_state, step=state.step + 1), metrics

    def _pde_matrix_joint(self, state: TaskState, x_denoised,
                          x_gt_unnorm=None, clamp_loss=True):
        """PDE residual of a joint (h, u) normalized field."""
        h_ch, u_ch = self.h_ch, self.u_ch
        h_un, u_un = self.transform.inverse(
            state, x_denoised[..., :h_ch], x_denoised[..., h_ch:h_ch + u_ch])
        x_unnorm = torch.cat([h_un, u_un], dim=-1)
        gt = x_unnorm if x_gt_unnorm is None else x_gt_unnorm
        return self.pde_loss(x_unnorm, gt, state.normalizer_input,
                             state.normalizer_target, clamp_loss=clamp_loss)


class McedmTask(DiffusionTaskBase):
    """Mixed-conditional EDM (the paper's method)."""

    default_cond_p = 1.0
    train_mask_kind = "var"

    def default_sampler_params(self):
        return dict(DEFAULT_EDM_SAMPLER)

    def set_train_mask_kind(self, kind: Optional[str]):
        """The training masks' family ("var", "time" or "sparse"), from the
        datamodule's train_mask_kind; None keeps the current one."""
        if kind:
            self.train_mask_kind = kind

    def _adjust_cond_channels(self, hparams):
        m = hparams["model"]
        if m.get("add_cond_mask", False):
            m["cond_channels"] = m["cond_channels"] + m["in_channels"]
        if m.get("add_xt", False):
            m["cond_channels"] = m["cond_channels"] + 2

    def get_cond_in(self, x, mask, t_grid, x_grid, noise):
        """Observed values (+ optional mask channels / x,t grids) as cond;
        `noise` (x's shape) fills the missing region."""
        if self.add_cond_mask:
            cond_in = torch.cat([x * (1 - mask), 1.0 - mask], dim=-1)
        else:
            cond_in = x * (1 - mask) + noise * mask
        if self.add_xt:
            cond_in = torch.cat([cond_in, t_grid, x_grid], dim=-1)
        return cond_in

    def model_precond(self, params, x_noise, sigma, cond=None):
        return _edm_precond(self, params, x_noise, sigma, cond)

    def loss_and_grads(self, state: TaskState, batch,
                       generator: Optional[torch.Generator] = None, *,
                       mask=None, cond_noise=None, noise=None, rnd_normal=None,
                       keep=None):
        """The training loss of one batch and its gradients with respect to
        state.params (the body of the JAX train_step up to value_and_grad).
        batch = (h, t_grid, x_grid, u), each (B, T, X, 1). mask (B, T, X, C),
        cond_noise and noise (B, T, X, C), rnd_normal (B, 1, 1, 1) and keep
        (a 0/1 scalar: classifier-free conditioning kept) replace the
        generator's draws."""
        if self.dx_cond:
            raise NotImplementedError("dx conditioning is not ported yet "
                                      "(see ROADMAP.md)")
        h_un, t_grid, x_grid, u_un = batch
        b, t_dim, x_dim = h_un.shape[:3]
        dev = h_un.device

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev)

        if mask is None:
            sampler = TRAIN_MASK_SAMPLERS[self.train_mask_kind]
            mask = sampler(generator, b, t_dim, x_dim, self.h_ch,
                           self.u_ch).to(dev)
        x = self.transform.forward(state, h_un, u_un, generator)
        cond_in = self.get_cond_in(x, mask, t_grid, x_grid,
                                   normal(x.shape) if cond_noise is None else cond_noise)
        if keep is None:  # classifier-free cond dropout: rand >= cond_p -> zero
            keep = (torch.rand((), generator=generator, device=dev)
                    < self.cond_p).float()
        cond_in = cond_in * keep
        noise = normal(x.shape) if noise is None else noise
        rnd_normal = normal((b, 1, 1, 1)) if rnd_normal is None else rnd_normal
        sigma = edm_train_sigma(rnd_normal, P_MEAN, P_STD)
        weight = edm_loss_weight(sigma, SIGMA_DATA)
        x_noise = x + mask * noise * sigma

        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        self.model.train()
        with torch.enable_grad():
            d_x = self.model_precond(params, x_noise, sigma, cond_in)
            loss = losses.noise_estimation_loss(d_x * mask, x * mask, weight)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        """One optimizer step (the JAX McedmTask.train_step): masks, noising,
        EDM preconditioning, masked weighted L2, gradients, global-norm clip,
        the optimizer, and the EMA. Returns (new state, metrics) with
        metrics {"train_loss", "grad_norm"} (the norm before clipping).
        Keyword draws as in `loss_and_grads`."""
        loss, grads = self.loss_and_grads(state, batch, generator, **draws)
        return self.finish_step(state, grads, {"train_loss": loss,
                                               "grad_norm": global_norm(grads)})

    def _make_denoise_fn(self, params, cond, w: float):
        if self.dx_cond:
            raise NotImplementedError("dx conditioning is not ported yet "
                                      "(see ROADMAP.md)")

        def denoise(x, t_hat: float):
            sig = torch.full((x.shape[0],), t_hat, device=x.device,
                             dtype=torch.float32)
            if w is None or abs(w) < 1e-3 or cond is None:
                return self.model_precond(params, x, sig, cond)
            d_c = self.model_precond(params, x, sig, cond)
            d_u = self.model_precond(params, x, sig, None)
            return (w + 1) * d_c - w * d_u

        return denoise

    def sample_edm(self, state: TaskState, cond, mask,
                   generator: Optional[torch.Generator] = None, sparams=None,
                   return_last: bool = True, init_noise=None, churn_noise=None):
        """Heun EDM sampling with known-part clamping (mcedm.py:570-638)."""
        sp = sparams or self.test_sparams
        if sp.get("guide_dx", False):
            raise NotImplementedError("PDE guidance is not ported yet (see ROADMAP.md)")
        schedule = edm_samplers.make_edm_schedule(
            num_steps=sp.get("timesteps", 50),
            sigma_min=max(sp.get("sigma_min", 0.002), SIGMA_MIN),
            sigma_max=min(sp.get("sigma_max", 80), SIGMA_MAX),
            rho=sp.get("rho", 7.0),
            S_churn=sp.get("S_churn", 0.0),
            S_min=sp.get("S_min", 0.0),
            S_max=float(sp.get("S_max", "inf")),
            S_noise=sp.get("S_noise", 1.0))
        denoise = self._make_denoise_fn(self._sample_params(state), cond,
                                        sp.get("w", 0.0))
        known = cond[..., : self.h_ch + self.u_ch]
        return edm_samplers.heun_sample_masked(
            denoise, known, mask, schedule, generator, return_last=return_last,
            init_noise=init_noise, churn_noise=churn_noise)

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator: torch.Generator,
                  mask, split: str = "val", n_samples: int = 1,
                  mask_name: str = "u", down_mask=None, *, cond_noise=None,
                  init_noise=None, churn_noise=None):
        """Sample and score one mask task; returns (metrics, hu_mean) with the
        reference metric keys. batch = (h, t_grid, x_grid, u), each
        (B, T, X, 1); mask (T, X, C) or (B, T, X, C), 1 = to recover.
        cond_noise (B, T, X, C), init_noise (n_samples, B, T, X, C) and
        churn_noise (n_samples, N, B, T, X, C) replace the generator's draws.
        The members of the ensemble are sampled in chunks folded into the
        batch (`ensemble`); each member keeps its own draws."""
        h_un, t_grid, x_grid, u_un = batch
        h_ch, u_ch = self.h_ch, self.u_ch
        sp = self.test_sparams
        self.model.eval()

        state_gt = self.transform.forward(state, h_un, u_un)
        mask_b = torch.broadcast_to(mask, state_gt.shape)
        if cond_noise is None:
            cond_noise = torch.randn(state_gt.shape, generator=generator,
                                     device=state_gt.device)
        cond_in = self.get_cond_in(state_gt, mask_b, t_grid, x_grid, cond_noise)

        def draw(members):
            k = len(members)
            xs = self.sample_edm(
                state, fold_members(cond_in, k), fold_members(mask_b, k),
                generator, sp, return_last=True,
                init_noise=fold_noise(init_noise, members),
                churn_noise=fold_noise(churn_noise, members, per_step=True))
            return xs[:, -1].reshape((k,) + tuple(state_gt.shape))

        samples = ensemble(draw, n_samples)
        hu_mean = torch.mean(samples, dim=0)

        mask_loss = mask_b if down_mask is None else mask_b * down_mask
        loss_dim = None
        if split == "test":
            start = 0 if mask_name.startswith("h") else h_ch
            end = h_ch if mask_name.startswith("h") else h_ch + u_ch
            loss_dim = torch.arange(start, end, device=state_gt.device)
        loss_hu = losses.masked_loss(hu_mean, state_gt, mask_loss, loss_dim)
        h_last_un, u_last_un = self.transform.inverse(
            state, hu_mean[..., :h_ch], hu_mean[..., h_ch:h_ch + u_ch])
        hu_un = torch.cat([h_last_un, u_last_un], dim=-1)
        gt_un = torch.cat([h_un, u_un], dim=-1)
        loss_hu_un = losses.masked_loss(hu_un, gt_un, mask_loss, loss_dim)

        n_batch = h_un.shape[0]
        flat_samples = samples.reshape((-1,) + samples.shape[2:])
        pde_matrix = self._pde_matrix_joint(state, flat_samples, clamp_loss=False)
        pde_loss = torch.sum(pde_matrix) / n_samples / n_batch
        pde_gt = torch.sum(self._pde_matrix_joint(state, state_gt,
                                                  clamp_loss=False)) / n_batch
        metrics = {
            f"{split}_mae_{mask_name}": loss_hu,
            f"{split}_mae_{mask_name}_un": loss_hu_un,
            f"{split}_pde_loss_{mask_name}": pde_loss,
            f"{split}_pde_loss_gt": pde_gt,
        }
        return metrics, hu_mean


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


class DdimTask(DiffusionTaskBase):
    """The DDPM schedule the conditional baselines share (the JAX DdimTask's
    constructor and cond-channel rule); its joint sampling, training and
    evaluation are not ported yet."""

    default_cond_p = 0.0

    def __init__(self, hparams, device, ops: Ops = DEVICE_OPS,
                 grad_clip: Optional[float] = 1.0, mega: bool = False):
        d = hparams["diffusion"]
        self.betas = get_beta_schedule(
            d["beta_schedule"], beta_start=d["beta_start"], beta_end=d["beta_end"],
            num_diffusion_timesteps=d["num_diffusion_timesteps"])
        self.alphas_cumprod = alphas_cumprod_from_betas(self.betas)
        self.num_timesteps = len(self.betas)
        # DDPM-as-EDM sigma table (ddim.py:131-137), reversed to EDM order
        self.edm_steps = np.sqrt(
            (1.0 - self.alphas_cumprod) / self.alphas_cumprod)[::-1].copy()
        self.sigma_min = float(self.edm_steps[-1])
        self.sigma_max = float(self.edm_steps[0])
        super().__init__(hparams, device, ops, grad_clip, mega=mega)

    def _adjust_cond_channels(self, hparams):
        m = hparams["model"]
        if m.get("node_type", False):
            m["cond_channels"] = m["cond_channels"] + 1

    def train_step(self, *args, **kwargs):
        raise _not_ported(f"{type(self).__name__}.train_step")

    def eval_step(self, *args, **kwargs):
        raise _not_ported("the joint DDPM evaluation")

    def sample(self, *args, **kwargs):
        raise _not_ported("the DDIM sampler")

    def sample_edm(self, *args, **kwargs):
        raise _not_ported("DDPM-as-EDM sampling")


class CondDdimTask(DdimTask):
    """Conditional DDPM: h observed -> denoise u. Ported: the conditioning,
    the physics on the known state and the evaluation around a sampler."""

    default_cond_p = 0.8

    def _channel_split(self, hparams) -> Tuple[int, int]:
        return hparams["model"]["in_channels"], hparams["model"]["out_ch"]

    def get_cond_in(self, h, u, t_grid, x_grid):
        """The conditioning channels by configured width (ddim.py:1081-1116):
        h; h and u's initial condition; h and the grids; all three. Plus the
        boundary-node channel with node_type."""
        cond_ch = self.model_cfg.cond_channels - (1 if self.node_type else 0)
        h_ch, u_ch = self.h_ch, self.u_ch

        def u_ic():
            return u[:, 0:1].expand(-1, u.shape[1], -1, -1)

        if cond_ch == h_ch:
            cond_in = h
        elif cond_ch == h_ch + u_ch:
            cond_in = torch.cat([h, u_ic()], dim=-1)
        elif cond_ch == h_ch + 2:
            cond_in = torch.cat([h, t_grid, x_grid], dim=-1)
        elif cond_ch == h_ch + u_ch + 2:
            cond_in = torch.cat([h, u_ic(), t_grid, x_grid], dim=-1)
        else:
            raise ValueError(f"cond_channels {cond_ch} incompatible with h_ch {h_ch}")
        if self.node_type:
            b, t_dim, x_dim = h.shape[:3]
            nt = np.zeros((1, t_dim, x_dim, 1), np.float32)
            nt[:, 0] = nt[:, -1] = nt[:, :, 0] = nt[:, :, -1] = 1.0
            nt = torch.from_numpy(nt).to(h.device).expand(b, -1, -1, -1)
            cond_in = torch.cat([cond_in, nt], dim=-1)
        return cond_in

    def _pde_matrix_cond(self, state: TaskState, h_norm, u_denoised,
                         x_gt_unnorm=None, clamp_loss=True):
        """PDE residual with the conditioning as the known state, summed over
        the channels."""
        h = h_norm[..., :self.h_ch].float()
        h_un, u_un = self.transform.inverse(state, h, u_denoised.float())
        x_unnorm = torch.cat([h_un, u_un], dim=-1)
        gt = x_unnorm if x_gt_unnorm is None else x_gt_unnorm
        m = self.pde_loss(x_unnorm, gt, state.normalizer_input,
                          state.normalizer_target, clamp_loss=clamp_loss)
        return m.sum(dim=-1) if m.dim() > 3 else m

    def _inverse_u(self, state: TaskState, u):
        if self.transform.rescaled:
            u = (u + 1.0) / 2.0
        if self.transform.normalization == "min_max":
            u = torch.clamp(u, 0.0, 1.0)
        return state.normalizer_target(u, inverse=True)

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator: Optional[torch.Generator],
                  split: str = "val", n_samples: int = 1, *, init_noise=None,
                  churn_noise=None):
        """Sample u given h and score it (`_eval_impl`, diffusion.py:1080-1140);
        returns (metrics, u_mean) with the reference metric keys. batch =
        (h, t_grid, x_grid, u), each (B, T, X, 1). init_noise (n_samples, B,
        T, X, u_ch) and churn_noise (n_samples, N, B, T, X, u_ch) replace the
        generator's draws."""
        h_un, dxc, dtc, u_un = batch
        h_ch, u_ch = self.h_ch, self.u_ch
        sp = self.test_sparams
        if split == "test" and sp.get("select_by_pde", False):
            raise _not_ported("select_by_pde")
        self.model.eval()

        state_gt = self.transform.forward(state, h_un, u_un)
        h = state_gt[..., :h_ch]
        u = state_gt[..., h_ch:h_ch + u_ch]
        cond_in = self.get_cond_in(h, u, dxc, dtc)

        def draw(members):
            k = len(members)
            cond_k = fold_members(cond_in, k)
            if sp.get("type", "ddim") == "edm":
                xs = self.sample_edm(state, cond_k, generator, sp,
                                     guide_dx=bool(sp.get("guide_dx", False)),
                                     init_noise=fold_noise(init_noise, members),
                                     churn_noise=fold_noise(churn_noise, members,
                                                            per_step=True))
            else:
                xs = self.sample(state, cond_k, generator, sp)
            return xs[:, -1].reshape((k,) + tuple(u.shape))

        samples = ensemble(draw, n_samples)
        u_mean = torch.mean(samples, dim=0)

        u_last = u_mean[..., :u_ch]
        loss_u = mae(u_last, u)
        loss_u_un = mae(self._inverse_u(state, u_last), u_un)
        gt_scaled = scale_each_min_max(state_gt)
        xs_scaled = scale_each_min_max(samples.flatten(0, 1)).reshape(samples.shape)
        loss_u_scaled = mae(torch.mean(xs_scaled, dim=0),
                            gt_scaled[..., h_ch:h_ch + u_ch])
        corr_u = torch.mean(losses.correlation(u_mean, u))

        n_batch = h_un.shape[0]
        flat_h = h[None].expand((n_samples,) + h.shape).flatten(0, 1)
        pde_loss = torch.sum(self._pde_matrix_cond(
            state, flat_h, samples.flatten(0, 1), clamp_loss=False)) / n_samples / n_batch
        metrics = {
            f"{split}_mae_u": loss_u, f"{split}_mae_u_un": loss_u_un,
            f"{split}_mae_u_scaled": loss_u_scaled, f"{split}_corr_u": corr_u,
            f"{split}_pde_loss": pde_loss,
        }
        if split == "test":
            metrics["test_pde_loss_gt"] = torch.sum(self._pde_matrix_cond(
                state, h, u, clamp_loss=False)) / n_batch
        return metrics, u_mean


class CondEdmTask(CondDdimTask):
    """Conditional model trained with true EDM preconditioning; only the EDM
    sampler is supported (ddim.py:1647-1652). Ported: its serving path."""

    def default_sampler_params(self):
        return dict(DEFAULT_EDM_SAMPLER)

    def set_test_sampler_params(self, sparams):
        if sparams.get("type") != "edm":
            sparams = dict(DEFAULT_EDM_SAMPLER, n_samples=5)
        super().set_test_sampler_params(sparams)

    def model_precond(self, params, x_noise, sigma, cond=None):
        return _edm_precond(self, params, x_noise, sigma, cond)

    def _cond_denoise_fn(self, params, cond, w: float):
        """True EDM preconditioning (no c_in cond scaling, no sigma table)."""
        if w is not None and abs(w) >= 1e-3:
            raise _not_ported("classifier-free guidance (w != 0)")

        def denoise(x, sigma: float):
            sig = torch.full((x.shape[0],), sigma, device=x.device,
                             dtype=torch.float32)
            return self.model_precond(params, x, sig, cond)

        return denoise

    def sample_edm(self, state: TaskState, cond_in,
                   generator: Optional[torch.Generator] = None, sparams=None,
                   guide_dx: bool = False, return_last: bool = True,
                   init_noise=None, churn_noise=None):
        """Heun EDM sampling of u given the conditioning (ddim.py:1740-1768)."""
        if guide_dx:
            raise _not_ported("PDE guidance")
        sp = sparams or self.test_sparams
        schedule = edm_samplers.make_edm_schedule(
            num_steps=sp.get("timesteps", 50),
            sigma_min=max(sp.get("sigma_min", 0.002), SIGMA_MIN),
            sigma_max=min(sp.get("sigma_max", 80), SIGMA_MAX),
            rho=sp.get("rho", 7.0), S_churn=sp.get("S_churn", 0.0),
            S_min=sp.get("S_min", 0.0), S_max=float(sp.get("S_max", "inf")),
            S_noise=sp.get("S_noise", 1.0))
        denoise = self._cond_denoise_fn(self._sample_params(state), cond_in,
                                        sp.get("w", 0.0))
        return edm_samplers.heun_sample_cond(
            denoise, cond_in.shape[:3] + (self.u_ch,), schedule, generator,
            return_last=return_last, init_noise=init_noise,
            churn_noise=churn_noise, guidance_div_t=True,
            self_condition=self.self_condition, device=cond_in.device)

    def sample(self, *args, **kwargs):
        raise NotImplementedError(
            "Only EDM sampler is supported for the model with EDM pre-conditioning")
