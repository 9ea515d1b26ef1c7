"""Heun (EDM) samplers (port of m_cedm_tpu/samplers/edm.py): the masked
sampler with known-part clamping (McedmTask), the plain conditional one
(CondEdmTask, CondDdimTask), whose conditioning lives in the denoiser, with
its self-conditioning carry, and the joint model's RePaint loop (DdimTask).

The schedule constants are computed on the host in float64 numpy and stored
as float32, exactly as in the JAX package (`make_edm_schedule` is a copy, so
the two schedules are identical). The loop is a Python loop over the steps;
scalar step arithmetic is done in float32 like the JAX graph. Random draws
come from a `torch.Generator`, or are injected (`init_noise`, `churn_noise`)
so tests can replay the JAX package's draws. Draws are taken step by step,
never all ahead of the loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EdmSchedule:
    """Static per-step schedule constants (host numpy, float64 -> float32)."""
    t_cur: np.ndarray    # (N,)
    t_hat: np.ndarray    # (N,) after churn + rounding
    t_next: np.ndarray   # (N,)
    is_last: np.ndarray  # (N,) bool
    S_noise: float
    alpha_t0: float = 1.0
    alpha_next: Optional[np.ndarray] = None
    repeat_t_hat: Optional[np.ndarray] = None

    @property
    def num_steps(self) -> int:
        return len(self.t_cur)


def _round_to_table(values: np.ndarray, table: Optional[np.ndarray]) -> np.ndarray:
    if table is None:
        return values
    idx = np.abs(values[:, None] - table[None, :]).argmin(axis=1)
    return table[idx]


def make_edm_schedule(num_steps: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0, S_churn: float = 0.0, S_min: float = 0.0,
                      S_max: float = float("inf"), S_noise: float = 1.0,
                      sigma_table: Optional[np.ndarray] = None,
                      alphas_cumprod: Optional[np.ndarray] = None) -> EdmSchedule:
    """All static schedule constants, in float64 on the host.

    sigma_table: discrete training sigmas for DDPM-as-EDM rounding; None =
    identity rounding. alphas_cumprod: DDPM alpha-bar table for the repaint
    variant's known-part renoising."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    t = _round_to_table(t, sigma_table)
    t_steps = np.concatenate([t, [0.0]])

    gamma_base = min(S_churn / num_steps, np.sqrt(2.0) - 1.0)
    gammas = np.where((t_steps[:-1] >= S_min) & (t_steps[:-1] <= S_max), gamma_base, 0.0)
    t_hat = _round_to_table(t_steps[:-1] * (1.0 + gammas), sigma_table)

    alpha_next = None
    alpha_t0 = 1.0
    repeat_t_hat = None
    if alphas_cumprod is not None:
        ext = np.concatenate([[1.0], np.asarray(alphas_cumprod, np.float64)])

        def alpha_at(sig):
            # reference quirk: alphas indexed at int(sigma) + 1 on [1, abar]
            idx = np.clip(sig.astype(np.int64) + 1, 0, len(ext) - 1)
            return ext[idx]

        alpha_next = alpha_at(t_steps[1:])
        alpha_t0 = float(alpha_at(np.asarray([t_steps[0]]))[0])
        gamma1 = np.sqrt(2.0) - 1.0
        repeat_t_hat = _round_to_table(t_steps[1:] * (1.0 + gamma1), sigma_table)

    return EdmSchedule(
        t_cur=t_steps[:-1].astype(np.float32),
        t_hat=t_hat.astype(np.float32),
        t_next=t_steps[1:].astype(np.float32),
        is_last=(np.arange(num_steps) == num_steps - 1),
        S_noise=float(S_noise),
        alpha_t0=alpha_t0,
        alpha_next=None if alpha_next is None else alpha_next.astype(np.float32),
        repeat_t_hat=None if repeat_t_hat is None else repeat_t_hat.astype(np.float32),
    )


def _heun_step(denoise_fn: Callable, x_hat: torch.Tensor, t_hat: float,
               t_next: float, is_last: bool,
               update_mask: Optional[torch.Tensor] = None):
    """Euler step plus second-order correction; returns (x_next, denoised).

    On the last step (t_next == 0) the JAX version evaluates the correction
    and blends it out; here it is skipped, with the same result. PDE
    guidance (the JAX version's guidance_fn) is not ported yet."""
    t_hat, t_next = np.float32(t_hat), np.float32(t_next)
    dt = float(t_next - t_hat)  # float32 difference, as in the JAX graph
    denoised = denoise_fn(x_hat, float(t_hat))
    d_cur = (x_hat - denoised) / float(t_hat)
    upd = dt * d_cur
    if update_mask is not None:
        upd = upd * update_mask
    x_next = x_hat + upd
    if is_last:
        return x_next, denoised
    denoised2 = denoise_fn(x_next, float(t_next))
    d_prime = (x_next - denoised2) / float(t_next)
    upd2 = dt * (0.5 * d_cur + 0.5 * d_prime)
    if update_mask is not None:
        upd2 = upd2 * update_mask
    return x_hat + upd2, denoised


def heun_sample_masked(denoise_fn: Callable, known: torch.Tensor,
                       mask: torch.Tensor, schedule: EdmSchedule,
                       generator: Optional[torch.Generator] = None,
                       return_last: bool = True,
                       init_noise: Optional[torch.Tensor] = None,
                       churn_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mixed-conditional Heun sampler: the observed region (mask == 0) is held
    at its clean known values; churn noise and Heun updates apply only where
    mask == 1. known/mask: (B, H, W, C). denoise_fn(x, sigma) -> D(x).

    init_noise (B, H, W, C) and churn_noise (N, B, H, W, C) replace the
    generator's draws. Returns (B, 1, H, W, C), or (B, N, H, W, C) of every
    step's state when return_last is False."""

    def normal():
        return torch.randn(known.shape, generator=generator, device=known.device,
                           dtype=torch.float32)

    noise = init_noise if init_noise is not None else normal()
    x = noise * float(schedule.t_cur[0])
    x = known * (1.0 - mask) + x * mask
    return _heun_loop(denoise_fn, x, schedule, normal, churn_noise, mask,
                      return_last)


def _heun_loop(denoise_fn: Callable, x: torch.Tensor, schedule: EdmSchedule,
               normal: Callable[[], torch.Tensor],
               churn_noise: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], return_last: bool,
               self_condition: bool = False) -> torch.Tensor:
    """The steps both samplers share from their initial state x: churn noise
    (where mask == 1, or everywhere without a mask), then `_heun_step`. With
    `self_condition`, denoise_fn(x, sigma, x_sc) gets the previous step's
    Euler-step estimate (zeros at the first step)."""
    states = []
    x_sc = torch.zeros_like(x) if self_condition else None
    for i in range(schedule.num_steps):
        t_cur, t_hat = schedule.t_cur[i], schedule.t_hat[i]
        churn = float(np.sqrt(np.maximum(t_hat * t_hat - t_cur * t_cur,
                                         np.float32(0.0))))
        eps = churn_noise[i] if churn_noise is not None else normal()
        step_noise = churn * schedule.S_noise * eps
        x_hat = x + (step_noise if mask is None else step_noise * mask)
        fn = (denoise_fn if x_sc is None
              else (lambda xx, tt, sc=x_sc: denoise_fn(xx, tt, sc)))
        x, denoised = _heun_step(fn, x_hat, t_hat, schedule.t_next[i],
                                 bool(schedule.is_last[i]), update_mask=mask)
        if self_condition:
            x_sc = denoised
        if not return_last:
            states.append(x)
    if return_last:
        return x[:, None]
    return torch.stack(states, dim=1)


def heun_sample_cond(denoise_fn: Callable, shape, schedule: EdmSchedule,
                     generator: Optional[torch.Generator] = None,
                     guidance_fn: Optional[Callable] = None,
                     return_last: bool = True,
                     init_noise: Optional[torch.Tensor] = None,
                     churn_noise: Optional[torch.Tensor] = None,
                     guidance_div_t: bool = True, self_condition: bool = False,
                     device="cpu") -> torch.Tensor:
    """Plain conditional Heun sampler: the state of `shape` (B, H, W, C) is
    drawn and updated everywhere; denoise_fn(x, sigma) -> D(x) holds the
    conditioning. With `self_condition` it is denoise_fn(x, sigma, x_sc), the
    previous step's estimate carried as in the JAX scan (edm.py:191-235).
    init_noise (B, H, W, C) and churn_noise (N, B, H, W, C) replace the
    generator's draws. Returns (B, 1, H, W, C), or every step's state
    (B, N, H, W, C) when return_last is False.

    guidance_div_t divides a PDE-guidance term by t_hat (ddim.py:1578,1590);
    PDE guidance is not ported yet."""
    if guidance_fn is not None:
        raise NotImplementedError("PDE guidance is not ported yet (see ROADMAP.md)")
    del guidance_div_t  # it scales only the guidance term

    def normal():
        return torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=torch.float32)

    x = (init_noise if init_noise is not None else normal()) * float(schedule.t_cur[0])
    return _heun_loop(denoise_fn, x, schedule, normal, churn_noise, None,
                      return_last, self_condition)


def heun_sample_repaint(denoise_fn: Callable, known: torch.Tensor,
                        mask: torch.Tensor, schedule: EdmSchedule,
                        n_repeat: int = 1,
                        generator: Optional[torch.Generator] = None,
                        guidance_fn: Optional[Callable] = None,
                        return_last: bool = True,
                        init_noise: Optional[torch.Tensor] = None,
                        churn_noise: Optional[torch.Tensor] = None,
                        repeat_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint-model Heun loop with RePaint harmonization (edm.py:238-298):
    after each Heun step the known region (mask == 1: observed, the opposite
    of the mcedm masks) is re-inserted at the DDPM noise level alpha_next of
    the step, and the n_repeat rounds re-noise back up to repeat_t_hat in
    between; on the last step the clean known part is inserted. Needs a
    schedule built with alphas_cumprod.

    known: clean (B, H, W, C); denoise_fn(x, sigma) -> D(x). init_noise
    (B, H, W, C, the one known-part noise), churn_noise (N, B, H, W, C) and
    repeat_noise (N * n_repeat, B, H, W, C; entry i * n_repeat + r re-noises
    after round r of step i, and the last round's is not used) replace the
    generator's draws."""
    if schedule.alpha_next is None:
        raise ValueError("repaint needs a schedule built with alphas_cumprod")
    if guidance_fn is not None:
        raise NotImplementedError("PDE guidance is not ported yet (see ROADMAP.md)")

    def normal():
        return torch.randn(known.shape, generator=generator, device=known.device,
                           dtype=torch.float32)

    one = np.float32(1.0)
    hu_noise = init_noise if init_noise is not None else normal()
    a0 = np.float32(schedule.alpha_t0)
    known_t0 = known * float(np.sqrt(a0)) + hu_noise * float(np.sqrt(one - a0))
    x = (known_t0 * mask + hu_noise * (1.0 - mask)) * float(schedule.t_cur[0])
    free = 1.0 - mask
    states = []
    for i in range(schedule.num_steps):
        t_cur, t_hat = schedule.t_cur[i], schedule.t_hat[i]
        t_next, is_last = schedule.t_next[i], bool(schedule.is_last[i])
        churn = float(np.sqrt(np.maximum(t_hat * t_hat - t_cur * t_cur, np.float32(0))))
        eps = churn_noise[i] if churn_noise is not None else normal()
        x_hat = x + churn * schedule.S_noise * eps
        a_next, rep = schedule.alpha_next[i], schedule.repeat_t_hat[i]
        known_t = (float(np.sqrt(a_next)) * known
                   + float(np.sqrt(one - a_next)) * hu_noise)
        churn_re = float(np.sqrt(np.maximum(rep * rep - t_next * t_next, np.float32(0))))
        for r in range(n_repeat):
            x_next, _ = _heun_step(denoise_fn, x_hat, t_hat, t_next, is_last)
            x_next = known_t * mask + x_next * free
            if r < n_repeat - 1:
                eps = (repeat_noise[i * n_repeat + r] if repeat_noise is not None
                       else normal())
                x_hat = x_next + churn_re * schedule.S_noise * eps
                t_hat = rep
        if is_last:
            x_next = known * mask + x_next * free
        x = x_next
        if not return_last:
            states.append(x)
    if return_last:
        return x[:, None]
    return torch.stack(states, dim=1)
