"""Diffusion tasks (port of m_cedm_tpu/tasks/diffusion.py), each trained and
served: DiffusionTaskBase; McedmTask, the paper's mixed-conditional EDM; and
the paper's diffusion baselines: DdimTask, the unconditional joint DDPM over
(h, u) with self-conditioning and RePaint inpainting (DDPM-as-EDM Heun or
DDIM); CondDdimTask, single-task conditional DDPM (h observed, u sampled)
with classifier-free cond dropout, sampled by DDIM or DDPM-as-EDM Heun; and
CondEdmTask, the same with true EDM preconditioning.

    task = build_task(hparams, device)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, batch, generator)
    metrics, hu_mean = task.eval_step(state, batch, generator, mask,
                                      split="test", mask_name="u")
    ctask = build_task(cond_hparams, device, target=COND_EDM_TARGET, mega=True)
    metrics, u_mean = ctask.eval_step(cstate, batch, generator, split="test")

`mega=True` runs the ADM U-Net's sampling forwards through the whole-block
K7. The state is functional, as in the JAX package: `train_step` returns a
new TaskState and leaves its argument as it was. Every random draw of a
train or eval step can be injected by keyword (the JAX draws in the tests);
otherwise it comes from the generator, step by step. PDE guidance, dx
conditioning and `DdimTask.unroll_metrics` are not ported yet (ROADMAP.md).

bf16 (`model.dtype: bfloat16`, or `trainer.precision=bf16` through run.py),
as the JAX tasks run it: the params stay fp32 masters, the sampling params
are cast to bf16 once per sampler call (`_sample_params`; the vectors are
upcast again, exactly, since the kernels take them in fp32), and `net_apply`
casts x, cond and x_self_cond to bf16, keeps t fp32 and returns the net's
output as fp32, so preconditioning, the samplers and the losses stay fp32.
The ADM U-Net serves and trains in bf16 on its per-conv path (McedmTask,
CondEdmTask, and DdimTask and CondDdimTask on it). A train step differentiates
the fp32 master params through the compute cast in `net_apply`, so every
gradient passes the bf16 rounding of the transposed cast, as JAX's does; the
master params, the optimizer state and the EMA stay fp32. The megakernel
path (mega=True) serves in bf16 too, on K7's bf16 instance; the DDPM U-Net
in bf16 raises NotImplementedError naming ROADMAP.md.
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
from m_cedm_tpu_torch.samplers import ddim as ddim_samplers
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.ops.schedules import (alphas_cumprod_from_betas,
                                            edm_loss_weight, edm_precond_coeffs,
                                            edm_train_sigma, get_beta_schedule)
from m_cedm_tpu_torch.physics.pde_loss import get_pde_loss_function
from m_cedm_tpu_torch.samplers import edm as edm_samplers
from m_cedm_tpu_torch.tasks.base import (DataTransform, TaskState,
                                         apply_updates, cast_floating,
                                         ema_update, ensemble,
                                         fold_members, fold_noise, global_norm,
                                         mae, make_optimizer,
                                         normalizers_from_stats,
                                         scale_back_min_max, to_device)

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


def _edm_precond(task, params, x_noise, sigma, cond, x_self_cond=None):
    """D(x) = c_skip x + c_out F(c_in x, c_noise; cond): the EDM denoiser."""
    sigma = sigma.to(torch.float32).reshape(-1, 1, 1, 1)
    c_skip, c_out, c_in, c_noise = edm_precond_coeffs(sigma, SIGMA_DATA)
    f_x = task.net_apply(params, c_in * x_noise, c_noise.reshape(-1), cond,
                         x_self_cond)
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
        # mixed precision as in the JAX task: fp32 master params, compute in
        # compute_dtype (None: fp32)
        self.compute_dtype = (torch.bfloat16 if m.get("dtype", "float32")
                              in ("bfloat16", "bf16") else None)
        self._adjust_cond_channels(hparams)
        # the DDPM U-Net refuses bf16 in its forward
        self.model, self.model_cfg = build_backbone(hparams, ops, mega=mega)
        self.model.to(self.device).eval()
        self.transform = DataTransform(hparams["data"])
        opt_cfg = hparams.get("optimization")
        # a serving-only config may leave the optimizer out
        self.tx = make_optimizer(opt_cfg, grad_clip) if opt_cfg else None
        opt_cfg = opt_cfg or {}
        self.pde_loss_lambda = opt_cfg.get("pde_loss_lambda", 0.0)
        self.pde_loss_prop_t = opt_cfg.get("pde_loss_prop_t", False)
        self.use_gt_pde = opt_cfg.get("use_gt_pde", False)
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
        params = state.ema_params if self.ema_enabled else state.params
        # cast once, outside the sampler's loop
        if self.compute_dtype is not None:
            params = self._compute_params(params)
        return params

    def _compute_params(self, params):
        """The params as the net computes with them: every floating tensor
        rounded to the compute dtype by `cast_floating`, as the JAX task
        rounds them; the vectors (biases, norm scales), which the kernels
        and the norms take in fp32, upcast again. The upcast is exact, so
        this is JAX's function, with the casts made here once and not in
        every forward. In a train step the casts act on the requires_grad
        fp32 masters inside the autograd graph, so every gradient is rounded
        to the compute dtype once on its way back to fp32, as the transpose
        of JAX's cast rounds it."""
        params = cast_floating(params, self.compute_dtype)
        return {k: v.float() if v.is_floating_point() and v.dim() == 1 else v
                for k, v in params.items()}

    def net_apply(self, params, x, t, cond=None, x_self_cond=None) -> torch.Tensor:
        """The backbone with `params` swapped in; fp32 in and out. With a
        compute dtype, params, x, cond and x_self_cond are cast to it (t
        stays fp32), as the JAX task's net_apply does."""
        dt = self.compute_dtype
        if dt is not None:
            # the sampler's params come cast (`_sample_params`); a train
            # step's fp32 masters are cast here, in the autograd graph
            if any(v.dim() > 1 and v.is_floating_point() and v.dtype != dt
                   for v in params.values()):
                params = self._compute_params(params)
            x = x.to(dt)
            cond = None if cond is None else cond.to(dt)
            x_self_cond = None if x_self_cond is None else x_self_cond.to(dt)
        kw = {} if x_self_cond is None else {"x_self_cond": x_self_cond}
        return functional_call(self.model, params, (x, t, cond), kw).float()

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
    """Unconditional joint DDPM over (h, u) (diffusion.py:494-857): antithetic
    timesteps, self-conditioning and the optional PDE loss in training; the
    evaluation inpaints u from h by RePaint, with the DDPM-as-EDM Heun sampler
    (`type: edm`) or DDIM."""

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
        # the table as the JAX graph holds it, for the nearest-sigma lookup
        self._edm_steps32 = self.edm_steps.astype(np.float32)
        self.sigma_min = float(self.edm_steps[-1])
        self.sigma_max = float(self.edm_steps[0])
        super().__init__(hparams, device, ops, grad_clip, mega=mega)
        self._abar_table = torch.as_tensor(self.alphas_cumprod, dtype=torch.float32,
                                           device=self.device)

    def _adjust_cond_channels(self, hparams):
        m = hparams["model"]
        if m.get("node_type", False):
            m["cond_channels"] = m["cond_channels"] + 1

    # --- training ------------------------------------------------------------

    def _timesteps(self, n: int, generator, t_half=None) -> torch.Tensor:
        """Antithetic timesteps: n // 2 + 1 draws, then their mirrors
        T - t - 1, the first n of both (diffusion.py:920-921)."""
        if t_half is None:
            t_half = torch.randint(0, self.num_timesteps, (n // 2 + 1,),
                                   generator=generator, device=self.device)
        t_half = t_half.to(self.device, torch.int64)
        return torch.cat([t_half, self.num_timesteps - t_half - 1])[:n]

    def _self_cond(self, like: torch.Tensor, use_sc, generator, estimate):
        """The self-conditioning input of a train step: with probability 1/2
        (one uniform a step, or `use_sc`) `estimate()` run without gradients,
        else zeros; None when the model is not self-conditioned."""
        if not self.self_condition:
            return None
        if use_sc is None:
            use_sc = torch.rand((), generator=generator, device=like.device) < 0.5
        if bool(use_sc):
            with torch.no_grad():
                return estimate()
        return torch.zeros_like(like)

    def _grads(self, state: TaskState, loss_fn):
        """(metrics, gradients) of loss_fn(params) -> (loss, metrics) at
        state.params; the metrics are detached."""
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        self.model.train()
        with torch.enable_grad():
            loss, metrics = loss_fn(params)
            grads = torch.autograd.grad(loss, list(params.values()))
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def _add_pde_loss(self, loss, metrics, m, divisor):
        """loss + pde_loss_lambda * sum(m [/ divisor]), the PDE term of the
        train steps; `train_pde_loss` joins the metrics."""
        if self.pde_loss_prop_t:
            m = m / divisor
        pde = torch.sum(m)
        metrics["train_pde_loss"] = pde
        return loss + self.pde_loss_lambda * pde

    def _gt_un(self, batch):
        return torch.cat([batch[0], batch[3]], dim=-1) if self.use_gt_pde else None

    def loss_and_grads(self, state: TaskState, batch,
                       generator: Optional[torch.Generator] = None, *,
                       t_half=None, noise=None, use_sc=None):
        """The train step's loss and gradients (diffusion.py:521-569):
        (metrics {"train_loss"[, "train_pde_loss"]}, gradients). t_half
        (n // 2 + 1,) integers, noise (x's shape) and use_sc (a bool: the
        self-conditioning branch taken) replace the generator's draws."""
        h_un, _, _, u_un = batch
        x = self.transform.forward(state, h_un, u_un, generator)
        noise = (torch.randn(x.shape, generator=generator, device=x.device)
                 if noise is None else noise)
        t = self._timesteps(x.shape[0], generator, t_half)
        abar = self._abar_table[t].reshape(-1, 1, 1, 1)
        sa, sb = torch.sqrt(abar), torch.sqrt(1.0 - abar)
        x_noise = x * sa + noise * sb
        tf = t.float()

        def loss_fn(params):
            x_sc = self._self_cond(x_noise, use_sc, generator, lambda: (
                x_noise - self.net_apply(params, x_noise, tf) * sb) / sa)
            output = self.net_apply(params, x_noise, tf, None, x_sc)
            loss = losses.noise_estimation_loss(output, noise)
            metrics = {"train_loss": loss}
            if self.pde_loss_lambda > 0.0:
                x0_t = (x_noise - output * sb) / sa
                m = self._pde_matrix_joint(state, x0_t, self._gt_un(batch),
                                           clamp_loss=True)
                loss = self._add_pde_loss(loss, metrics, m,
                                          t.reshape(-1, 1, 1, 1).to(m.dtype) + 1.0)
            return loss, metrics

        return self._grads(state, loss_fn)

    def train_step(self, state: TaskState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        """One optimizer step: the loss of `loss_and_grads`, its gradients,
        the global-norm clip, the optimizer and the EMA. Returns (new state,
        metrics) with the gradient norm (before clipping) as `grad_norm`."""
        metrics, grads = self.loss_and_grads(state, batch, generator, **draws)
        metrics["grad_norm"] = global_norm(grads)
        return self.finish_step(state, grads, metrics)

    # --- samplers --------------------------------------------------------------

    def _eps_fn(self, params, w: float, cond=None):
        """eps(x, t, x_self_cond), blended with the unconditional prediction
        when |w| >= 1e-3 (classifier-free guidance)."""

        def eps(x, t: float, x_self_cond):
            t_b = torch.full((x.shape[0],), t, device=x.device, dtype=torch.float32)
            e_c = self.net_apply(params, x, t_b, cond, x_self_cond)
            if w is None or abs(w) < 1e-3:
                return e_c
            e_u = self.net_apply(params, x, t_b, None, x_self_cond)
            return (w + 1) * e_c - w * e_u

        return eps

    def _c_noise(self, sigma) -> Tuple[np.float32, float]:
        """(c_in, c_noise) of the eps net driven as an EDM denoiser:
        c_in = 1 / sqrt(sigma^2 + 1) and T - 1 - the index of the nearest
        table sigma, in float32 as the JAX graph computes them."""
        sigma = np.float32(sigma)
        c_in = np.float32(1) / np.sqrt(sigma * sigma + np.float32(1))
        idx = int(np.argmin(np.abs(self._edm_steps32 - sigma)))
        return c_in, float(self.num_timesteps - 1 - idx)

    def _ddpm_as_edm_denoise_fn(self, params, w: float):
        """The eps net as an EDM denoiser: c_skip 1, c_out -sigma
        (ddim.py:915-957). Like the JAX package's, it takes no guidance."""
        del w

        def denoise(x, sigma: float):
            c_in, c_noise = self._c_noise(sigma)
            t_b = torch.full((x.shape[0],), c_noise, device=x.device,
                             dtype=torch.float32)
            f_x = self.net_apply(params, float(c_in) * x, t_b, None)
            return x - float(np.float32(sigma)) * f_x

        return denoise

    def _time_mask(self, shape, n_time_h: int, n_time_u: int) -> torch.Tensor:
        """(1, T, X, C): 1 = known for the first n_time rows of each variable
        block (the opposite of the mcedm masks' convention)."""
        mask = np.zeros(tuple(shape[1:]), np.float32)
        mask[:n_time_h, :, :self.h_ch] = 1.0
        mask[:n_time_u, :, self.h_ch:self.h_ch + self.u_ch] = 1.0
        return torch.from_numpy(mask)[None].to(self.device)

    def _known_mask(self, hu, sp):
        return torch.broadcast_to(
            self._time_mask(hu.shape, sp.get("n_time_h", 128), sp.get("n_time_u", 0)),
            hu.shape)

    def _ddim_schedule(self, sp):
        return ddim_samplers.make_ddim_schedule(
            self.alphas_cumprod, sp.get("timesteps", 50),
            sp.get("skip_type", "uniform"), sp.get("eta", 0.0))

    def _table_edm_schedule(self, sp, **kw):
        """The Heun schedule rounded onto the DDPM sigma table."""
        return edm_samplers.make_edm_schedule(
            num_steps=sp.get("timesteps", 50),
            sigma_min=max(sp.get("sigma_min", 0.002), self.sigma_min),
            sigma_max=min(sp.get("sigma_max", 80), self.sigma_max),
            rho=sp.get("rho", 7.0), S_churn=sp.get("S_churn", 0.0),
            S_min=sp.get("S_min", 0.0), S_max=float(sp.get("S_max", "inf")),
            S_noise=sp.get("S_noise", 1.0), sigma_table=self.edm_steps, **kw)

    @staticmethod
    def _no_guide(sp, guide_dx=False):
        if guide_dx or sp.get("guide_dx", False):
            raise _not_ported("PDE guidance")

    def sample_edm(self, state: TaskState, hu, generator=None, sparams=None,
                   return_last: bool = True, init_noise=None, churn_noise=None,
                   repeat_noise=None):
        """Joint DDPM-as-EDM Heun sampling with RePaint harmonization
        (ddim.py:959-1051); hu clean normalized (B, T, X, C). Draws as in
        `heun_sample_repaint`."""
        sp = sparams or self.test_sparams
        self._no_guide(sp)
        schedule = self._table_edm_schedule(sp, alphas_cumprod=self.alphas_cumprod)
        denoise = self._ddpm_as_edm_denoise_fn(self._sample_params(state),
                                               sp.get("w", 0.0))
        return edm_samplers.heun_sample_repaint(
            denoise, hu, self._known_mask(hu, sp), schedule,
            n_repeat=sp.get("n_repeat", 1), generator=generator,
            return_last=return_last, init_noise=init_noise,
            churn_noise=churn_noise, repeat_noise=repeat_noise)

    def sample(self, state: TaskState, h, generator=None, sparams=None,
               return_last: bool = True, h_noise=None, u_noise=None, eta_noise=None):
        """Joint-model DDIM where the h block rides the known field's noisy
        trajectory and u is denoised (ddim.py:706-806); h clean normalized
        (B, T, X, h_ch)."""
        sp = sparams or self.test_sparams
        self._no_guide(sp)
        eps = self._eps_fn(self._sample_params(state), sp.get("w", 0.0))
        return ddim_samplers.ddim_sample_joint_h(
            eps, h, self._ddim_schedule(sp), h_ch=self.h_ch, generator=generator,
            self_condition=self.self_condition, return_last=return_last,
            h_noise=h_noise, u_noise=u_noise, eta_noise=eta_noise)

    def sample_with_repeat(self, state: TaskState, hu, generator=None, sparams=None,
                           return_last: bool = True, init_noise=None, eta_noise=None):
        """RePaint DDIM sampling (ddim.py:808-913); hu clean normalized."""
        sp = sparams or self.test_sparams
        self._no_guide(sp)
        eps = self._eps_fn(self._sample_params(state), sp.get("w", 0.0))
        return ddim_samplers.ddim_sample_repaint(
            eps, hu, self._known_mask(hu, sp), self._ddim_schedule(sp),
            n_repeat=sp.get("n_repeat", 1), generator=generator,
            self_condition=self.self_condition, return_last=return_last,
            init_noise=init_noise, eta_noise=eta_noise)

    def _select_best_by_pde(self, state: TaskState, samples, gt_unnorm,
                            use_gt: bool = True):
        """Per batch element, the sample with the smallest PDE residual
        (diffusion.py:676-696): each sample min-max rescaled to the ground
        truth's range, scored against the ground truth (use_gt) or itself.
        samples (S, B, T, X, C) -> (B, T, X, C)."""
        _, mn, mx = scale_each_min_max(gt_unnorm, return_min_max=True)
        errs = []
        for sample in samples:
            s_gt = scale_back_min_max(scale_each_min_max(sample), mn, mx)
            m = self.pde_loss(s_gt, gt_unnorm if use_gt else s_gt,
                              state.normalizer_input, state.normalizer_target,
                              clamp_loss=False)
            errs.append(torch.mean(m.reshape(m.shape[0], -1), dim=1))
        idx = torch.argmin(torch.stack(errs), dim=0)
        return samples[idx, torch.arange(samples.shape[1], device=samples.device)]

    def _draw_members(self, sample, like, init_noise, per_step: dict):
        """`ensemble`'s draw: k members folded into one sampler call on
        fold_members(like, k), each member with its own injected draws
        (init_noise (n, B, ...), per_step {name: (n, N, B, ...)})."""

        def draw(members):
            k = len(members)
            xs = sample(fold_members(like, k),
                        init_noise=fold_noise(init_noise, members),
                        **{name: fold_noise(v, members, per_step=True)
                           for name, v in per_step.items()})
            return xs[:, -1].reshape((k, like.shape[0]) + tuple(xs.shape[2:]))

        return draw

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator: Optional[torch.Generator],
                  split: str = "val", n_samples: int = 1, *, init_noise=None,
                  churn_noise=None, repeat_noise=None, eta_noise=None):
        """Inpaint (h, u) from the known region and score it (`_eval_impl`,
        diffusion.py:756-857); returns (metrics, hu_mean) with the JAX metric
        keys. batch = (h, t_grid, x_grid, u), each (B, T, X, 1). init_noise
        (n_samples, B, T, X, C), churn_noise (n_samples, N, B, ...),
        repeat_noise (n_samples, N * n_repeat, B, ...) and eta_noise
        (n_samples, N, B, ...) replace the generator's draws; the members are
        sampled in chunks folded into the batch (`ensemble`)."""
        h_un, _, _, u_un = batch
        h_ch, u_ch = self.h_ch, self.u_ch
        sp = self.test_sparams
        self.model.eval()

        state_gt = self.transform.forward(state, h_un, u_un)
        h = state_gt[..., :h_ch]
        u = state_gt[..., h_ch:h_ch + u_ch]
        if sp.get("type", "ddim") == "edm":
            draw = self._draw_members(
                lambda hu, **kw: self.sample_edm(state, hu, generator, sp, **kw),
                state_gt, init_noise, {"churn_noise": churn_noise,
                                       "repeat_noise": repeat_noise})
        else:
            draw = self._draw_members(
                lambda hu, **kw: self.sample_with_repeat(state, hu, generator, sp, **kw),
                state_gt, init_noise, {"eta_noise": eta_noise})
        samples = ensemble(draw, n_samples)
        gt_un = torch.cat([h_un, u_un], dim=-1)
        if split == "test" and sp.get("select_by_pde", False):
            hu_mean = self._select_best_by_pde(
                state, samples, gt_un, use_gt=bool(sp.get("use_gt_pde_select", True)))
        else:
            hu_mean = torch.mean(samples, dim=0)

        h_last, u_last = hu_mean[..., :h_ch], hu_mean[..., h_ch:h_ch + u_ch]
        h_last_un, u_last_un = self.transform.inverse(state, h_last, u_last)
        gt_scaled = scale_each_min_max(state_gt)
        xs_scaled_mean = torch.mean(
            scale_each_min_max(samples.flatten(0, 1)).reshape(samples.shape), dim=0)
        corr = losses.correlation(hu_mean, state_gt)
        n_batch = h_un.shape[0]
        pde_loss = torch.sum(self._pde_matrix_joint(
            state, samples.flatten(0, 1), clamp_loss=False)) / n_samples / n_batch
        p = split
        metrics = {
            f"{p}_mae_h": mae(h_last, h), f"{p}_mae_u": mae(u_last, u),
            f"{p}_mae_h_un": mae(h_last_un, h_un), f"{p}_mae_u_un": mae(u_last_un, u_un),
            f"{p}_mae_h_scaled": mae(xs_scaled_mean[..., :h_ch], gt_scaled[..., :h_ch]),
            f"{p}_mae_u_scaled": mae(xs_scaled_mean[..., h_ch:h_ch + u_ch],
                                     gt_scaled[..., h_ch:h_ch + u_ch]),
            f"{p}_corr_h": torch.mean(corr[:h_ch]),
            f"{p}_corr_u": torch.mean(corr[h_ch:h_ch + u_ch]),
            f"{p}_pde_loss": pde_loss,
        }
        if split != "test":
            return metrics, hu_mean
        # the unnormalized loss over the recovered region only
        n_time_h, n_time_u = int(sp.get("n_time_h", 128)), int(sp.get("n_time_u", 0))
        eval_mask = np.ones(tuple(gt_un.shape[1:]), np.float32)
        eval_mask[:n_time_h, :, :h_ch] = 0.0
        eval_mask[:n_time_u, :, h_ch:h_ch + u_ch] = 0.0
        eval_mask = torch.broadcast_to(torch.from_numpy(eval_mask).to(gt_un.device),
                                       gt_un.shape)
        metrics["test_mae_hu_un"] = losses.masked_loss(
            torch.cat([h_last_un, u_last_un], dim=-1), gt_un, eval_mask)
        metrics["test_pde_loss_gt"] = torch.sum(self._pde_matrix_joint(
            state, state_gt, clamp_loss=False)) / n_batch
        # known-region consistency checks when the time mask is partial
        t_all = state_gt.shape[1]
        for name, n_time, lo, hi in (("h", n_time_h, 0, h_ch),
                                     ("u", n_time_u, h_ch, h_ch + u_ch)):
            if 0 < n_time < t_all:
                last = hu_mean[..., lo:hi]
                metrics[f"test_{name}_known"] = mae(last[:, :n_time],
                                                    state_gt[:, :n_time, :, lo:hi])
                metrics[f"test_{name}_kn_scaled"] = mae(
                    xs_scaled_mean[:, :n_time, :, lo:hi], gt_scaled[:, :n_time, :, lo:hi])
                metrics[f"test_{name}_unkn_scaled"] = mae(
                    xs_scaled_mean[:, n_time:, :, lo:hi], gt_scaled[:, n_time:, :, lo:hi])
        return metrics, hu_mean


class CondDdimTask(DdimTask):
    """Conditional DDPM: h observed -> denoise u (diffusion.py:859-1150)."""

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

    def _train_inputs(self, state, batch, generator, keep):
        """(x, h, u, cond_in) of a conditional train step, the conditioning
        dropped to zeros unless `keep` (one uniform < cond_p a step)."""
        h_un, dxc, dtc, u_un = batch
        x = self.transform.forward(state, h_un, u_un, generator)
        h, u = x[..., :self.h_ch], x[..., self.h_ch:self.h_ch + self.u_ch]
        if keep is None:
            keep = (torch.rand((), generator=generator, device=x.device)
                    < self.cond_p).float()
        return x, h, u, self.get_cond_in(h, u, dxc, dtc) * keep

    def loss_and_grads(self, state: TaskState, batch,
                       generator: Optional[torch.Generator] = None, *,
                       t_half=None, noise=None, use_sc=None, keep=None):
        """The conditional train step's loss and gradients
        (diffusion.py:907-957); draws as in DdimTask's, with `keep` (a 0/1
        scalar: the conditioning kept) and noise of u's shape."""
        _, h, u, cond_in = self._train_inputs(state, batch, generator, keep)
        noise = (torch.randn(u.shape, generator=generator, device=u.device)
                 if noise is None else noise)
        t = self._timesteps(u.shape[0], generator, t_half)
        abar = self._abar_table[t].reshape(-1, 1, 1, 1)
        sa, sb = torch.sqrt(abar), torch.sqrt(1.0 - abar)
        u_noise = u * sa + noise * sb
        tf = t.float()

        def loss_fn(params):
            x_sc = self._self_cond(u_noise, use_sc, generator, lambda: (
                u_noise - self.net_apply(params, u_noise, tf, cond_in) * sb) / sa)
            output = self.net_apply(params, u_noise, tf, cond_in, x_sc)
            loss = losses.noise_estimation_loss(output, noise)
            metrics = {"train_loss": loss}
            if self.pde_loss_lambda > 0.0:
                x0_t = (u_noise - output * sb) / sa
                m = self._pde_matrix_cond(state, h, x0_t, self._gt_un(batch),
                                          clamp_loss=True)
                loss = self._add_pde_loss(loss, metrics, m,
                                          t.reshape(-1, 1, 1, 1).to(m.dtype) + 1.0)
            return loss, metrics

        return self._grads(state, loss_fn)

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

    def sample(self, state: TaskState, cond_in, generator=None, sparams=None,
               return_last: bool = True, init_noise=None, eta_noise=None):
        """Conditional DDIM sampling of u (ddim.py:1452-1530)."""
        sp = sparams or self.test_sparams
        self._no_guide(sp)
        eps = self._eps_fn(self._sample_params(state), sp.get("w", 0.0), cond_in)
        return ddim_samplers.ddim_sample_cond(
            eps, cond_in.shape[:3] + (self.u_ch,), self._ddim_schedule(sp),
            generator, self_condition=self.self_condition, return_last=return_last,
            init_noise=init_noise, eta_noise=eta_noise, device=cond_in.device)

    def _cond_denoise_fn(self, params, cond, w: float):
        """The DDPM net driven as an EDM denoiser with conditioning; a
        channel-concatenated cond is scaled by c_in (ddim.py:930-932)."""
        cat_condition = self.model_cfg.cat_cond

        def denoise(x, sigma: float):
            c_in, c_noise = self._c_noise(sigma)
            t_b = torch.full((x.shape[0],), c_noise, device=x.device,
                             dtype=torch.float32)
            x_in = float(c_in) * x
            f_x = self.net_apply(params, x_in, t_b,
                                 cond * float(c_in) if cat_condition else cond)
            if w is not None and abs(w) >= 1e-3:
                f_x = (w + 1) * f_x - w * self.net_apply(params, x_in, t_b, None)
            return x - float(np.float32(sigma)) * f_x

        return denoise

    def sample_edm(self, state: TaskState, cond_in, generator=None, sparams=None,
                   guide_dx: bool = False, return_last: bool = True,
                   init_noise=None, churn_noise=None):
        """Conditional DDPM-as-EDM Heun sampling (ddim.py:1532-1601)."""
        sp = sparams or self.test_sparams
        self._no_guide(sp, guide_dx)
        denoise = self._cond_denoise_fn(self._sample_params(state), cond_in,
                                        sp.get("w", 0.0))
        return edm_samplers.heun_sample_cond(
            denoise, cond_in.shape[:3] + (self.u_ch,), self._table_edm_schedule(sp),
            generator, return_last=return_last, init_noise=init_noise,
            churn_noise=churn_noise, guidance_div_t=True, device=cond_in.device)

    @torch.no_grad()
    def eval_step(self, state: TaskState, batch, generator: Optional[torch.Generator],
                  split: str = "val", n_samples: int = 1, *, init_noise=None,
                  churn_noise=None, eta_noise=None):
        """Sample u given h and score it (`_eval_impl`, diffusion.py:1080-1140);
        returns (metrics, u_mean) with the JAX metric keys. batch = (h,
        t_grid, x_grid, u), each (B, T, X, 1). init_noise (n_samples, B, T, X,
        u_ch), churn_noise (n_samples, N, B, ...) of the Heun sampler and
        eta_noise (n_samples, N, B, ...) of DDIM replace the generator's
        draws."""
        h_un, dxc, dtc, u_un = batch
        h_ch, u_ch = self.h_ch, self.u_ch
        sp = self.test_sparams
        self.model.eval()

        state_gt = self.transform.forward(state, h_un, u_un)
        h = state_gt[..., :h_ch]
        u = state_gt[..., h_ch:h_ch + u_ch]
        cond_in = self.get_cond_in(h, u, dxc, dtc)
        if sp.get("type", "ddim") == "edm":
            draw = self._draw_members(
                lambda c, **kw: self.sample_edm(state, c, generator, sp, **kw),
                cond_in, init_noise, {"churn_noise": churn_noise})
        else:
            draw = self._draw_members(
                lambda c, **kw: self.sample(state, c, generator, sp, **kw),
                cond_in, init_noise, {"eta_noise": eta_noise})
        samples = ensemble(draw, n_samples)
        h_rep = h[None].expand((n_samples,) + tuple(h.shape))
        if split == "test" and sp.get("select_by_pde", False):
            # score the joint [h | u_sample] field (ddim.py:1259-1273)
            best = self._select_best_by_pde(
                state, torch.cat([h_rep, samples], dim=-1),
                torch.cat([h_un, u_un], dim=-1),
                use_gt=bool(sp.get("use_gt_pde_select", True)))
            u_mean = best[..., h_ch:h_ch + u_ch]
        else:
            u_mean = torch.mean(samples, dim=0)

        u_last = u_mean[..., :u_ch]
        gt_scaled = scale_each_min_max(state_gt)
        xs_scaled = scale_each_min_max(samples.flatten(0, 1)).reshape(samples.shape)
        n_batch = h_un.shape[0]
        pde_loss = torch.sum(self._pde_matrix_cond(
            state, h_rep.flatten(0, 1), samples.flatten(0, 1),
            clamp_loss=False)) / n_samples / n_batch
        metrics = {
            f"{split}_mae_u": mae(u_last, u),
            f"{split}_mae_u_un": mae(self._inverse_u(state, u_last), u_un),
            f"{split}_mae_u_scaled": mae(torch.mean(xs_scaled, dim=0),
                                         gt_scaled[..., h_ch:h_ch + u_ch]),
            f"{split}_corr_u": torch.mean(losses.correlation(u_mean, u)),
            f"{split}_pde_loss": pde_loss,
        }
        if split == "test":
            metrics["test_pde_loss_gt"] = torch.sum(self._pde_matrix_cond(
                state, h, u, clamp_loss=False)) / n_batch
        return metrics, u_mean


class CondEdmTask(CondDdimTask):
    """Conditional model trained with true EDM preconditioning; only the EDM
    sampler is supported (ddim.py:1647-1652)."""

    def default_sampler_params(self):
        return dict(DEFAULT_EDM_SAMPLER)

    def set_test_sampler_params(self, sparams):
        if sparams.get("type") != "edm":
            sparams = dict(DEFAULT_EDM_SAMPLER, n_samples=5)
        super().set_test_sampler_params(sparams)

    def model_precond(self, params, x_noise, sigma, cond=None, x_self_cond=None):
        return _edm_precond(self, params, x_noise, sigma, cond, x_self_cond)

    def loss_and_grads(self, state: TaskState, batch,
                       generator: Optional[torch.Generator] = None, *,
                       rnd_normal=None, noise=None, use_sc=None, keep=None):
        """The EDM train step's loss and gradients (diffusion.py:1180-1226):
        sigma = exp(P_mean + P_std rnd_normal), u + noise sigma, the weighted
        loss of D(x) against u. rnd_normal (B, 1, 1, 1), noise (u's shape),
        use_sc and keep replace the generator's draws."""
        _, h, u, cond_in = self._train_inputs(state, batch, generator, keep)
        dev = u.device
        noise = (torch.randn(u.shape, generator=generator, device=dev)
                 if noise is None else noise)
        rnd_normal = (torch.randn((u.shape[0], 1, 1, 1), generator=generator,
                                  device=dev) if rnd_normal is None else rnd_normal)
        sigma = edm_train_sigma(rnd_normal, P_MEAN, P_STD)
        weight = edm_loss_weight(sigma, SIGMA_DATA)
        u_noise = u + noise * sigma

        def loss_fn(params):
            x_sc = self._self_cond(u_noise, use_sc, generator, lambda: (
                self.model_precond(params, u_noise, sigma, cond_in)))
            d_x = self.model_precond(params, u_noise, sigma, cond_in, x_sc)
            loss = losses.noise_estimation_loss(d_x, u, weight)
            metrics = {"train_loss": loss}
            if self.pde_loss_lambda > 0.0:
                m = self._pde_matrix_cond(state, h, d_x, self._gt_un(batch),
                                          clamp_loss=True)
                loss = self._add_pde_loss(loss, metrics, m, sigma + 1.0)
            return loss, metrics

        return self._grads(state, loss_fn)

    def _cond_denoise_fn(self, params, cond, w: float):
        """True EDM preconditioning (no c_in cond scaling, no sigma table),
        with the optional self-conditioning input x_sc (ddim.py:1770-1773)."""

        def denoise(x, sigma: float, x_sc=None):
            sig = torch.full((x.shape[0],), sigma, device=x.device,
                             dtype=torch.float32)
            d_c = self.model_precond(params, x, sig, cond, x_sc)
            if w is None or abs(w) < 1e-3:
                return d_c
            d_u = self.model_precond(params, x, sig, None, x_sc)
            return (w + 1) * d_c - w * d_u

        return denoise

    def sample_edm(self, state: TaskState, cond_in, generator=None, sparams=None,
                   guide_dx: bool = False, return_last: bool = True,
                   init_noise=None, churn_noise=None):
        """Heun EDM sampling of u given the conditioning (ddim.py:1740-1768)."""
        sp = sparams or self.test_sparams
        self._no_guide(sp, guide_dx)
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

    def sample_with_repeat(self, *args, **kwargs):
        raise NotImplementedError(
            "Only EDM sampler is supported for the model with EDM pre-conditioning")
