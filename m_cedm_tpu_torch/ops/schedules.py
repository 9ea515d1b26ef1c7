"""Diffusion noise schedules and embedding primitives (PyTorch port of
m_cedm_tpu/ops/schedules.py).

Host-side grids (beta schedules, the Karras sigma grid) stay float64 numpy
returned as float32, exactly as in the JAX package, so schedules match bit for
bit. Device-side functions take and return float32 tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """DDPM beta schedule. Returns float32 numpy (host-side, static)."""
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(n, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, n)
        betas = 1.0 / (np.exp(-x) + 1.0) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    return betas.astype(np.float32)


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    """Cumulative product of (1 - beta): the DDPM alpha-bar table."""
    return np.cumprod(1.0 - betas.astype(np.float64), axis=0).astype(np.float32)


def karras_sigma_grid(num_steps: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) grid with appended t_N = 0, (num_steps + 1,) f32."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1.0 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))) ** rho
    return np.concatenate([t, np.zeros(1)]).astype(np.float32)


def edm_precond_coeffs(sigma: torch.Tensor, sigma_data: float = 1.0):
    """EDM preconditioning coefficients (c_skip, c_out, c_in, c_noise)."""
    sigma = sigma.to(torch.float32)
    s2 = sigma * sigma
    d2 = sigma_data * sigma_data
    c_skip = d2 / (s2 + d2)
    c_out = sigma * sigma_data * (1.0 / torch.sqrt(s2 + d2))
    c_in = 1.0 / torch.sqrt(d2 + s2)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def edm_train_sigma(rnd_normal: torch.Tensor, p_mean: float = -1.2,
                    p_std: float = 1.2) -> torch.Tensor:
    """Log-normal training sigma: sigma = exp(N(P_mean, P_std))."""
    return torch.exp(rnd_normal * p_std + p_mean)


def edm_loss_weight(sigma: torch.Tensor, sigma_data: float = 1.0) -> torch.Tensor:
    """lambda(sigma) = (sigma^2 + sigma_data^2) / (sigma * sigma_data)^2."""
    return (sigma * sigma + sigma_data * sigma_data) / (sigma * sigma_data) ** 2


def ddpm_as_edm_coeffs(sigma: torch.Tensor):
    """(c_skip, c_out, c_in) wrapping a DDPM eps-prediction net as an EDM
    denoiser; c_noise is the caller's sigma-table lookup."""
    sigma = sigma.to(torch.float32)
    return torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma * sigma + 1.0)


def sinusoidal_timestep_embedding(timesteps: torch.Tensor,
                                  embedding_dim: int) -> torch.Tensor:
    """DDPM sinusoidal embedding [sin | cos]: (B,) -> (B, embedding_dim)."""
    timesteps = timesteps.to(torch.float32)
    half = embedding_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = timesteps[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def fourier_positional_embedding(x: torch.Tensor, num_channels: int,
                                 max_positions: int = 10000,
                                 endpoint: bool = False) -> torch.Tensor:
    """ADM noise-level embedding [cos | sin]: (B,) -> (B, num_channels)."""
    x = x.to(torch.float32)
    half = num_channels // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = freqs / (half - (1 if endpoint else 0))
    freqs = (1.0 / max_positions) ** freqs
    args = x[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


def cosine_onecycle(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                    div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule as a function of the step count (an int
    or an integer tensor, on the card for a train step) returning an fp32
    tensor: cosine from peak / div_factor up to peak over the first
    int(pct_start * steps) counts, then down to peak / (div_factor *
    final_div_factor) at `transition_steps`, constant after. Segment values
    are float64 on the host, as optax's are, and the interpolation is fp32."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs a positive transition_steps")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        out = torch.where(count >= bounds[-1], float(values[-1]), 0.0)
        for i in range(2):
            start, end = float(values[i]), float(values[i + 1])
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            interp = end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)
            inside = (bounds[i] <= count) & (count < bounds[i + 1])
            out = out + torch.where(inside, interp, 0.0)
        return out

    return schedule
