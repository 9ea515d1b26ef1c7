"""DDIM / RePaint samplers (port of m_cedm_tpu/samplers/ddim.py):

  ddim_sample_cond     conditional DDIM from pure noise (CondDdimTask)
  ddim_sample_repaint  RePaint inpainting with the unconditional joint model
                       (DdimTask, the evaluation's DDIM sampler)
  ddim_sample_joint_h  the joint model with the h block riding a fixed noisy
                       trajectory of the known field (DdimTask.sample)

The schedule (the sub-sequence of training timesteps and its alpha-bar
pairs) is computed on the host in float64 and stored as float32, as in the
JAX package (`make_ddim_schedule` is a copy); scalar step arithmetic is
float32 like the JAX graph. Self-conditioning carries the previous x0
estimate. `eps_fn(x, t, x_self_cond) -> predicted noise` holds the
conditioning and the guidance blend. Random draws come from a
`torch.Generator`, step by step, or are injected (`init_noise`,
`eta_noise`, ...) so tests can replay the JAX package's draws. With eta 0
(every shipped config) no step draws anything. PDE guidance (`guidance_fn`)
is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DdimSchedule:
    """Per-(reversed)-step constants: timestep fed to the net, alpha-bar
    pairs, and a_init, the alpha-bar at the last training timestep (T - 1)
    that noises the known field at initialization (ddim.py:735)."""
    t: np.ndarray        # (N,) float32 timestep
    at: np.ndarray       # (N,) alpha_bar(t)
    at_next: np.ndarray  # (N,) alpha_bar(t_next), alpha_bar(-1) = 1
    eta: float
    a_init: Optional[float] = None

    @property
    def num_steps(self) -> int:
        return len(self.t)


def make_ddim_schedule(alphas_cumprod: np.ndarray, timesteps: int,
                       skip_type: str = "uniform", eta: float = 0.0) -> DdimSchedule:
    num_train = len(alphas_cumprod)
    if skip_type == "uniform":
        skip = num_train // timesteps
        seq = list(range(0, num_train, skip))
    elif skip_type == "quad":
        seq = [int(s) for s in np.linspace(0, np.sqrt(num_train * 0.8), timesteps) ** 2]
    else:
        raise NotImplementedError(skip_type)
    seq_next = [-1] + seq[:-1]
    ext = np.concatenate([[1.0], np.asarray(alphas_cumprod, np.float64)])
    rev = np.asarray(list(reversed(seq)), np.int64)
    at = ext[rev + 1]
    at_next = ext[np.asarray(list(reversed(seq_next)), np.int64) + 1]
    return DdimSchedule(t=rev.astype(np.float32), at=at.astype(np.float32),
                        at_next=at_next.astype(np.float32), eta=float(eta),
                        a_init=float(ext[-1]))


def _no_guidance(guidance_fn) -> None:
    if guidance_fn is not None:
        raise NotImplementedError("PDE guidance is not ported yet (see ROADMAP.md)")


def _x0(xt, et, at):
    """The x0 estimate (xt - et sqrt(1 - at)) / sqrt(at), float32 scalars."""
    return (xt - et * float(np.sqrt(np.float32(1) - at))) / float(np.sqrt(at))


def _ddim_update(x0_t, et, at, at_next, eta: float, z: Callable[[], torch.Tensor]):
    """x at t_next from the x0 estimate and the predicted noise; `z()` draws
    the eta > 0 branch's noise."""
    one = np.float32(1)
    if abs(eta) > 1e-10:
        c1 = np.float32(eta) * np.sqrt((one - at / at_next) * (one - at_next) / (one - at))
        c2 = np.sqrt((one - at_next) - c1 * c1)
        return float(np.sqrt(at_next)) * x0_t + float(c1) * z() + float(c2) * et
    return float(np.sqrt(at_next)) * x0_t + float(np.sqrt(one - at_next)) * et


def _drawer(shape, generator, device, injected: Optional[torch.Tensor]):
    """The i-th draw: injected[i], or a fresh normal draw of `shape`."""
    def draw(i):
        if injected is not None:
            return injected[i]
        return torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=torch.float32)
    return draw


def _finish(x, states, return_last):
    return x[:, None] if return_last else torch.stack(states, dim=1)


def _a_init(schedule: DdimSchedule):
    """(sqrt(a_T), sqrt(1 - a_T)) in float32, as the JAX graph rounds them."""
    a_t = schedule.a_init if schedule.a_init is not None else float(schedule.at[0])
    return float(np.sqrt(np.float32(a_t))), float(np.sqrt(np.float32(1.0 - a_t)))


def ddim_sample_cond(eps_fn: Callable, shape, schedule: DdimSchedule,
                     generator: Optional[torch.Generator] = None,
                     self_condition: bool = False, guidance_fn=None,
                     return_last: bool = True,
                     init_noise: Optional[torch.Tensor] = None,
                     eta_noise: Optional[torch.Tensor] = None,
                     device="cpu") -> torch.Tensor:
    """Conditional DDIM from pure noise of `shape` (B, H, W, C). init_noise
    (B, H, W, C) and eta_noise (N, B, H, W, C; eta > 0 only) replace the
    generator's draws. Returns (B, 1, H, W, C), or every step's state."""
    _no_guidance(guidance_fn)
    x = (init_noise if init_noise is not None
         else torch.randn(tuple(shape), generator=generator, device=device,
                          dtype=torch.float32))
    draw = _drawer(x.shape, generator, x.device, eta_noise)
    x0_prev = torch.zeros_like(x)
    states = []
    for i in range(schedule.num_steps):
        at, at_next = schedule.at[i], schedule.at_next[i]
        et = eps_fn(x, float(schedule.t[i]), x0_prev if self_condition else None)
        x0_t = _x0(x, et, at)
        x = _ddim_update(x0_t, et, at, at_next, schedule.eta, lambda: draw(i))
        x0_prev = x0_t
        if not return_last:
            states.append(x)
    return _finish(x, states, return_last)


def ddim_sample_repaint(eps_fn: Callable, known: torch.Tensor, mask: torch.Tensor,
                        schedule: DdimSchedule, n_repeat: int = 1,
                        generator: Optional[torch.Generator] = None,
                        self_condition: bool = False, guidance_fn=None,
                        return_last: bool = True,
                        init_noise: Optional[torch.Tensor] = None,
                        eta_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RePaint inpainting with an unconditional joint model (ddim.py:100-166):
    known clean (B, H, W, C), mask 1 = observed. Each step runs n_repeat
    rounds of denoise, clamp the known part of x0, re-noise to level t; then
    the DDIM update to t_next, with the known part re-inserted at the t_next
    noise level. init_noise (B, H, W, C, the one noise draw) and eta_noise
    (N, B, H, W, C) replace the generator's draws."""
    _no_guidance(guidance_fn)
    noise = (init_noise if init_noise is not None
             else torch.randn(known.shape, generator=generator, device=known.device,
                              dtype=torch.float32))
    draw = _drawer(known.shape, generator, known.device, eta_noise)
    sa, sb = _a_init(schedule)
    free = 1.0 - mask
    x = (known * sa + noise * sb) * mask + noise * free
    x0_prev = torch.zeros_like(x)
    states = []
    one = np.float32(1)
    for i in range(schedule.num_steps):
        t, at, at_next = float(schedule.t[i]), schedule.at[i], schedule.at_next[i]
        xt = x
        for _ in range(n_repeat):
            et = eps_fn(xt, t, x0_prev if self_condition else None)
            x0_t = known * mask + _x0(xt, et, at) * free
            xt = float(np.sqrt(at)) * x0_t + float(np.sqrt(one - at)) * et
            x0_prev = x0_t
        x = _ddim_update(x0_t, et, at, at_next, schedule.eta, lambda: draw(i))
        known_t = float(np.sqrt(at_next)) * known + float(np.sqrt(one - at_next)) * noise
        x = known_t * mask + x * free
        if not return_last:
            states.append(x)
    return _finish(x, states, return_last)


def ddim_sample_joint_h(eps_fn: Callable, h: torch.Tensor, schedule: DdimSchedule,
                        h_ch: int = 1, generator: Optional[torch.Generator] = None,
                        self_condition: bool = False, guidance_fn=None,
                        return_last: bool = True,
                        h_noise: Optional[torch.Tensor] = None,
                        u_noise: Optional[torch.Tensor] = None,
                        eta_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint-model DDIM where the h block rides the fixed noisy trajectory
    sqrt(at_next) h + sqrt(1 - at_next) h_noise and u is denoised
    (ddim.py:169-223). h clean (B, H, W, h_ch); the u block has h's shape.
    h_noise, u_noise (each h's shape) and eta_noise (N, B, H, W, 2 h_ch)
    replace the generator's draws."""
    _no_guidance(guidance_fn)

    def normal(shape):
        return torch.randn(tuple(shape), generator=generator, device=h.device,
                           dtype=torch.float32)

    h_noise = h_noise if h_noise is not None else normal(h.shape)
    u_noise = u_noise if u_noise is not None else normal(h.shape)
    sa, sb = _a_init(schedule)
    x = torch.cat([h * sa + h_noise * sb, u_noise], dim=-1)
    draw = _drawer(x.shape, generator, h.device, eta_noise)
    x0_prev = torch.zeros_like(x)
    states = []
    one = np.float32(1)
    for i in range(schedule.num_steps):
        at, at_next = schedule.at[i], schedule.at_next[i]
        et = eps_fn(x, float(schedule.t[i]), x0_prev if self_condition else None)
        x0_t = _x0(x, et, at)
        x_next = _ddim_update(x0_t, et, at, at_next, schedule.eta, lambda: draw(i))
        h_t = float(np.sqrt(at_next)) * h + float(np.sqrt(one - at_next)) * h_noise
        x = torch.cat([h_t[..., :h_ch], x_next[..., h_ch:]], dim=-1)
        x0_prev = x0_t
        if not return_last:
            states.append(x)
    return _finish(x, states, return_last)
