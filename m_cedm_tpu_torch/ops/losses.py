"""Loss zoo on (B, H, W, C) tensors (port of m_cedm_tpu/ops/losses.py)."""
from __future__ import annotations

import torch


def _elementwise(pred, target, kind: str):
    diff = pred - target
    if kind in ("l2", "mse"):
        return diff * diff
    if kind == "l1":
        return torch.abs(diff)
    if kind == "smooth_l1":
        a = torch.abs(diff)
        return torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5)
    raise ValueError(f"unknown loss kind {kind!r}")


def multi_loss(pred, target, kind: str = "mse", reduction: str = "mean"):
    """Sum over the channel axis, then reduce over spatial dims and batch."""
    m = torch.sum(_elementwise(pred, target, kind), dim=-1)
    if reduction == "mean":
        return torch.mean(torch.mean(m, dim=(1, 2)))
    if reduction == "sum":
        return torch.sum(m)
    return m


def noise_estimation_loss(pred, target, weight=1.0, reduction: str = "mean"):
    """weight * MSE summed over (H, W, C), then reduced over batch."""
    d = pred - target
    per_sample = torch.sum(weight * d * d, dim=(1, 2, 3))
    if reduction == "mean":
        return torch.mean(per_sample)
    if reduction == "sum":
        return torch.sum(per_sample)
    return per_sample


def masked_loss(pred, target, mask, loss_dim=None, kind: str = "l1"):
    """Masked error normalized by the mask count; loss_dim optionally
    restricts to a set of channel indices."""
    pred = pred * mask
    target = target * mask
    if loss_dim is not None:
        pred = pred[..., loss_dim]
        target = target[..., loss_dim]
        mask = mask[..., loss_dim]
    return torch.sum(_elementwise(pred, target, kind)) / torch.sum(mask)


def downsampled_loss(pred, target, down_factor: int = 1, kind: str = "l1"):
    """Error on a 2^(down_factor-1)-strided subgrid of (H, W)."""
    if down_factor > 1:
        each = 2 ** (down_factor - 1)
        pred = pred[:, ::each, ::each]
        target = target[:, ::each, ::each]
    return torch.mean(_elementwise(pred, target, kind))


def correlation(pred, target, reduction: str = "none"):
    """Per-channel Pearson correlation over flattened (H, W), averaged over B."""
    b, c = pred.shape[0], pred.shape[-1]
    x = pred.reshape(b, -1, c)
    y = target.reshape(b, -1, c)
    xb = x - torch.mean(x, dim=1, keepdim=True)
    yb = y - torch.mean(y, dim=1, keepdim=True)
    cov = torch.sum(yb * xb, dim=1)
    denom = torch.sqrt(torch.sum(xb * xb, dim=1) * torch.sum(yb * yb, dim=1))
    denom = torch.where(denom == 0, denom + 1e-7, denom)
    corr = torch.mean(cov / denom, dim=0)
    if reduction == "mean":
        return torch.mean(corr)
    if reduction == "sum":
        return torch.sum(corr)
    return corr


def _scale_min_max(state):
    b, c = state.shape[0], state.shape[-1]
    flat = state.reshape(b, -1, c)
    mn = torch.amin(flat, dim=1, keepdim=True)
    mx = torch.amax(flat, dim=1, keepdim=True)
    return ((flat - mn) / (mx - mn)).reshape(state.shape)


def scaled_mae_loss(pred, target, keep_channels: bool = False):
    """L1 between per-sample min-max-rescaled fields."""
    err = torch.abs(_scale_min_max(pred) - _scale_min_max(target))
    if keep_channels:
        return torch.mean(err, dim=(0, 1, 2))
    return torch.mean(err)


def lp_loss(pred, target, p: int = 2, reduction: str = "mean"):
    """Relative Lp norm per sample (FNO convention)."""
    b = pred.shape[0]
    diff = torch.linalg.vector_norm((pred - target).reshape(b, -1), ord=p, dim=1)
    ynorm = torch.linalg.vector_norm(target.reshape(b, -1), ord=p, dim=1)
    rel = diff / ynorm
    if reduction == "mean":
        return torch.mean(rel)
    if reduction == "sum":
        return torch.sum(rel)
    return rel
