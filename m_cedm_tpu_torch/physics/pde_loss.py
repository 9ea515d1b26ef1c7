"""PDE residual losses on (B, T, X, C) tensors (port of
m_cedm_tpu/physics/pde_loss.py, without the guidance gradients).

Guidance gradients (`return_d=True`) belong to configs with guide_dx or
dx_cond, which the flagship does not set; they raise NotImplementedError
(listed in ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import torch


def flip_state(pred, gt, h_ch: int, u_ch: int):
    """Swap the (h, u) channel blocks (used when the datamodule flipped x/y)."""
    pred = torch.cat([pred[..., h_ch:u_ch + h_ch], pred[..., :h_ch]], dim=-1)
    gt = torch.cat([gt[..., h_ch:u_ch + h_ch], gt[..., :h_ch]], dim=-1)
    return pred, gt


def _no_guidance(return_d: bool) -> None:
    if return_d:
        raise NotImplementedError("PDE guidance gradients are not ported yet "
                                  "(see ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class SweFvLoss:
    """One-step FORCE finite-volume residual of the 1D shallow-water
    equations: the predicted trajectory (B, T, X, 2) is advanced one FV step
    at every time slice and compared with the ground truth, scaled by the
    normalizer variances."""
    Tn: float = 0.128
    x_min: float = -2.5
    x_max: float = 2.5
    n_ghosts: int = 2
    flip_xy: bool = False
    g: float = 1.0
    eps: float = 1e-8

    def step(self, s_t: torch.Tensor, dt: float) -> torch.Tensor:
        """One FORCE step applied to every time slice. s_t: (B, T, X, 2)."""
        n_g = self.n_ghosts
        dx = (self.x_max - self.x_min) / s_t.shape[2]
        s_ext = torch.cat([s_t[:, :, :1].repeat_interleave(n_g, dim=2), s_t,
                           s_t[:, :, -1:].repeat_interleave(n_g, dim=2)], dim=2)
        h = s_ext[..., 0]
        hu = s_ext[..., 1] * s_ext[..., 0]

        hm = 0.5 * (h[..., :-1] + h[..., 1:]) - 0.5 * dt * (hu[..., 1:] - hu[..., :-1]) / dx
        flux = hu ** 2 / (h + self.eps) + 0.5 * self.g * h ** 2
        hum = 0.5 * (hu[..., :-1] + hu[..., 1:]) - 0.5 * dt * (flux[..., 1:] - flux[..., :-1]) / dx

        h_next = 0.5 * (hm[..., :-1] + hm[..., 1:]) - 0.5 * dt * (hum[..., 1:] - hum[..., :-1]) / dx
        flux_m = hum ** 2 / (hm + self.eps) + 0.5 * self.g * hm ** 2
        hu_next = 0.5 * (hum[..., :-1] + hum[..., 1:]) - 0.5 * dt * (flux_m[..., 1:] - flux_m[..., :-1]) / dx

        h_out = h_next[..., n_g - 1:-(n_g - 1)] if n_g > 1 else h_next
        hu_out = hu_next[..., n_g - 1:-(n_g - 1)] if n_g > 1 else hu_next
        u_out = hu_out / (h_out + self.eps)
        return torch.stack([h_out, u_out], dim=-1)

    def _scale(self, normalizer_h, normalizer_u) -> torch.Tensor:
        sh = normalizer_h.divide.to(torch.float32).reshape(-1)
        su = normalizer_u.divide.to(torch.float32).reshape(-1)
        scale = torch.cat([su, sh] if self.flip_xy else [sh, su], dim=-1)
        return scale ** 2

    def residual(self, pred, gt, normalizer_h, normalizer_u) -> torch.Tensor:
        """Per-element squared residual of a one-step FV advance vs gt."""
        dt = self.Tn / pred.shape[1]
        pred_next = self.step(pred, dt)
        pred_next_ic = torch.cat([pred[:, 0:1], pred_next[:, :-1]], dim=1)
        pred_next_ic = torch.nan_to_num(pred_next_ic)
        return (pred_next_ic - gt) ** 2 / self._scale(normalizer_h, normalizer_u)

    def __call__(self, pred, gt, normalizer_h, normalizer_u, return_d=False,
                 calc_prob=False, clamp_loss=False) -> torch.Tensor:
        _no_guidance(return_d)
        if self.flip_xy:
            pred, gt = flip_state(pred, gt, normalizer_h.num_channels,
                                  normalizer_u.num_channels)
        loss = self.residual(pred, gt, normalizer_h, normalizer_u)
        return torch.clamp(loss, max=1.0) if clamp_loss else loss


@dataclasses.dataclass(frozen=True)
class DarcyLoss:
    """Central-difference residual of -div(a grad u) = 1 on the unit square;
    channels C = (a, u), interior-only stencil."""
    flip_xy: bool = False
    D: float = 1.0
    eps: float = 1e-8

    def residual(self, pred) -> torch.Tensor:
        size = pred.shape[1]
        a = pred[..., 0]
        u = pred[..., 1]
        dx = self.D / size
        dy = dx
        ux = (u[:, 2:, 1:-1] - u[:, :-2, 1:-1]) / (2 * dx)
        uy = (u[:, 1:-1, 2:] - u[:, 1:-1, :-2]) / (2 * dy)
        a_in = a[:, 1:-1, 1:-1]
        aux = a_in * ux
        auy = a_in * uy
        auxx = (aux[:, 2:, 1:-1] - aux[:, :-2, 1:-1]) / (2 * dx)
        auyy = (auy[:, 1:-1, 2:] - auy[:, 1:-1, :-2]) / (2 * dy)
        return (-(auxx + auyy) - 1.0) ** 2

    def __call__(self, pred, gt, normalizer_h, normalizer_u, return_d=False,
                 calc_prob=False, clamp_loss=False) -> torch.Tensor:
        _no_guidance(return_d)
        if self.flip_xy:
            pred, gt = flip_state(pred, gt, normalizer_h.num_channels,
                                  normalizer_u.num_channels)
        loss = self.residual(pred)
        loss = loss / (loss.shape[1] * loss.shape[2])
        return torch.clamp(loss, max=1.0) if clamp_loss else loss


def get_pde_loss_function(system: str, flip_xy: bool, Tn_mult: float = 1.0):
    """system -> (FV loss, simulator-oracle loss). The PyClaw-backed oracle
    is host-side tooling that is not ported; the FV loss stands in for it,
    as the reference does when PyClaw is missing."""
    if system == "swe_per":
        loss = SweFvLoss(Tn=0.128 * Tn_mult, x_min=-0.5, x_max=0.5, flip_xy=flip_xy)
    elif system == "darcy":
        loss = DarcyLoss(flip_xy=flip_xy)
    else:
        loss = SweFvLoss(Tn=1.28 * Tn_mult, flip_xy=flip_xy)
    return loss, loss
