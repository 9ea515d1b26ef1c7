"""Shared task infrastructure: the state holder, the optimizers and the EMA
update, normalizer construction and data transforms (port of
m_cedm_tpu/tasks/base.py).

The optimizers reproduce the JAX package's optax chains exactly, as plain
PyTorch over dicts of tensors: `clip_by_global_norm` (no epsilon, unlike
torch's clip_grad_norm_), Adam with an integer step count in its bias
correction and eps outside the square root, AdamW, RMSProp and SGD with
momentum 0.9 at optax's defaults, and `add_decayed_weights`. Like optax they
are pure: `update` returns new tensors and never writes its arguments. They
run as torch._foreach_* ops over the list of parameter tensors, a few
launches per step instead of a dozen per tensor. The learning rate may be a
schedule of the Adam step count, read before the count's increment, as
optax's scale_by_schedule reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from m_cedm_tpu_torch.ops.normalizer import Normalizer


Params = Dict[str, torch.Tensor]
ADAM_B2 = 0.999  # fixed in the JAX package's make_optimizer


@dataclasses.dataclass
class TaskState:
    """Parameters (a state_dict), their EMA copy (a separate set of tensors),
    the optimizer state, the step count, the two normalizers, and the frozen
    buffers the model reads but never trains (the OFormer's Fourier matrix;
    the JAX package's 'constants' collection)."""
    params: Params
    ema_params: Optional[Params]
    normalizer_input: Normalizer
    normalizer_target: Normalizer
    opt_state: Optional[Dict[str, Any]] = None
    step: int = 0
    constants: Optional[Params] = None


def cast_floating(params: Params, dtype: torch.dtype) -> Params:
    """The floating tensors of a params dict cast to a compute dtype, the
    others as they are (m_cedm_tpu/tasks/diffusion.py::cast_floating); a
    tensor already of that dtype is returned itself."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tree.values()))))


def _lin(a: List[torch.Tensor], s: float, b: List[torch.Tensor], t: float):
    """s * a + t * b per tensor, each product rounded before the sum, as
    optax writes it (one fused launch per op over the whole list)."""
    return torch._foreach_add(torch._foreach_mul(a, s), torch._foreach_mul(b, t))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style gradient transformation chain over dicts of tensors:
    `init(params) -> state`, `update(grads, state, params) -> (updates,
    state)`; new params are `params + updates` (optax.apply_updates). Each
    formula is optax's, in its order of operations, applied to the whole
    list of tensors at once with torch._foreach_* ops."""
    name: str
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]]
    weight_decay: float = 0.0
    b1: float = 0.9
    eps: float = 1e-8
    grad_clip: Optional[float] = None

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        if self.name in ("Adam", "AdamW"):
            device = next(iter(params.values())).device
            return {"count": torch.zeros((), dtype=torch.int32, device=device),
                    "mu": zeros(), "nu": zeros()}
        if self.name == "RMSProp":
            return {"nu": zeros()}
        return {"trace": zeros()}

    def update(self, grads: Params, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any]]:
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        keys = list(grads)
        u = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        old = {name: [state[name][k] for k in keys]
               for name in ("mu", "nu", "trace") if name in state}
        if self.grad_clip:  # clip_by_global_norm: where(|g| < max, g, g / |g| * max)
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            one = torch.ones_like(norm)
            u = torch._foreach_mul(
                torch._foreach_div(u, torch.where(keep, one, norm)),
                torch.where(keep, one, torch.full_like(norm, self.grad_clip)))
        if self.weight_decay and self.name in ("Adam", "RMSProp"):
            # add_decayed_weights ahead of the scaling
            u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        if self.name in ("Adam", "AdamW"):  # scale_by_adam, eps_root = 0
            mu = _lin(u, 1 - self.b1, old["mu"], self.b1)
            nu = _lin(torch._foreach_mul(u, u), 1 - ADAM_B2, old["nu"], ADAM_B2)
            count = state["count"] + 1
            b1, b2 = (torch.tensor(b, dtype=torch.float32, device=count.device)
                      for b in (self.b1, ADAM_B2))
            mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
            nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
            u = torch._foreach_div(mu_hat, torch._foreach_add(
                torch._foreach_sqrt(nu_hat), self.eps))
            if self.name == "AdamW" and self.weight_decay:
                u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
            state = {"count": count, "mu": dict(zip(keys, mu)),
                     "nu": dict(zip(keys, nu))}
        elif self.name == "RMSProp":  # scale_by_rms(decay 0.9, eps 1e-8)
            nu = _lin(torch._foreach_mul(u, u), 1 - 0.9, old["nu"], 0.9)
            u = torch._foreach_mul(u, torch._foreach_rsqrt(torch._foreach_add(nu, 1e-8)))
            state = {"nu": dict(zip(keys, nu))}
        else:  # SGD: trace(decay 0.9)
            trace = torch._foreach_add(u, torch._foreach_mul(old["trace"], 0.9))
            u, state = trace, {"trace": dict(zip(keys, trace))}
        return dict(zip(keys, torch._foreach_mul(u, -lr))), state


def make_optimizer(opt_cfg, grad_clip: Optional[float] = None) -> Optimizer:
    """The JAX package's make_optimizer (Adam, AdamW, RMSProp or SGD, with
    weight decay and the global-norm clip ahead of it)."""
    name = opt_cfg.get("optimizer", "Adam")
    if name not in ("Adam", "AdamW", "RMSProp", "SGD"):
        raise NotImplementedError(f"Optimizer {name} not understood.")
    return Optimizer(name=name, lr=opt_cfg["lr"],
                     weight_decay=opt_cfg.get("weight_decay", 0.0),
                     b1=opt_cfg.get("beta1", 0.9), eps=opt_cfg.get("eps", 1e-8),
                     grad_clip=grad_clip)


def to_device(tree, device):
    """A fresh fp32 copy of a (nested) dict of tensors on `device` (integer
    tensors keep their type): a state never shares a tensor with its
    source."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    dtype = torch.float32 if tree.is_floating_point() else tree.dtype
    return tree.detach().to(device, dtype).clone()


def apply_updates(params: Params, updates: Params) -> Params:
    keys = list(params)
    return dict(zip(keys, torch._foreach_add([params[k] for k in keys],
                                             [updates[k] for k in keys])))


def optimizer_step(tx: Optimizer, state: "TaskState", loss_fn: Callable):
    """One step of `tx` on loss_fn(params) -> (loss, aux), differentiated
    with respect to a detached copy of the state's params. Returns the new
    state (params, optimizer state, step + 1), the loss, the gradient's
    global norm before any clipping, and aux as loss_fn returned it."""
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(params)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    new = dataclasses.replace(state, params=apply_updates(state.params, updates),
                              opt_state=opt_state, step=state.step + 1)
    return new, loss.detach(), global_norm(grads), aux


def ema_update(ema_params: Params, params: Params, rate: float) -> Params:
    """shadow <- shadow * rate + params * (1 - rate), as new tensors."""
    keys = list(ema_params)
    return dict(zip(keys, _lin([ema_params[k] for k in keys], rate,
                               [params[k] for k in keys], 1.0 - rate)))


def normalizers_from_stats(stats, normalization: str,
                           device="cpu") -> Tuple[Normalizer, Normalizer]:
    """Input/target normalizers from datamodule stats (PlMcedm.setup)."""

    def squeeze(v):
        v = np.asarray(v, np.float32)
        return v.reshape(()) if v.size == 1 else v

    if normalization == "min_max":
        return (Normalizer.min_max(squeeze(stats["input_min"]),
                                   squeeze(stats["input_min_max"]), device),
                Normalizer.min_max(squeeze(stats["target_min"]),
                                   squeeze(stats["target_min_max"]), device))
    return (Normalizer.gauss(squeeze(stats["input_mean"]),
                             squeeze(stats["input_std"]), device),
            Normalizer.gauss(squeeze(stats["target_mean"]),
                             squeeze(stats["target_std"]), device))


class DataTransform:
    """normalize -> (dequantize) -> (rescale), and its inverse."""

    def __init__(self, data_cfg):
        self.normalization = data_cfg.get("normalization", "gauss")
        self.uniform_dequantization = data_cfg.get("uniform_dequantization", False)
        self.gaussian_dequantization = data_cfg.get("gaussian_dequantization", False)
        self.rescaled = data_cfg.get("rescaled", False)

    def forward(self, state: TaskState, h, u,
                generator: Optional[torch.Generator] = None):
        h = state.normalizer_input(h)
        u = state.normalizer_target(u)
        x = torch.cat([h, u], dim=-1)
        if self.uniform_dequantization:
            x = x / 256.0 * 255.0 + torch.rand(
                x.shape, generator=generator, device=x.device) / 256.0
        if self.gaussian_dequantization:
            x = x + torch.randn(x.shape, generator=generator, device=x.device) * 0.01
        if self.rescaled:
            x = 2 * x - 1.0
        return x

    def inverse(self, state: TaskState, h, u):
        if self.rescaled:
            h = (h + 1.0) / 2.0
            u = (u + 1.0) / 2.0
        if self.normalization == "min_max":
            h = torch.clamp(h, 0.0, 1.0)
            u = torch.clamp(u, 0.0, 1.0)
        return (state.normalizer_input(h, inverse=True),
                state.normalizer_target(u, inverse=True))


ENSEMBLE_CHUNK = 4  # members folded into one sampler call (chunked_ensemble)


def ensemble_chunks(n: int, chunk: int = ENSEMBLE_CHUNK) -> List[range]:
    """The members of each sampler call, split as the JAX package's
    `chunked_ensemble` splits its keys: all n at once when n <= chunk or n is
    not a multiple of chunk, else runs of `chunk`."""
    if n <= chunk or n % chunk:
        return [range(n)]
    return [range(s, s + chunk) for s in range(0, n, chunk)]


def ensemble(draw: Callable[[range], torch.Tensor], n: int,
             chunk: int = ENSEMBLE_CHUNK) -> torch.Tensor:
    """The (n, B, ...) ensemble from `draw(members) -> (len(members), B,
    ...)`, one call per chunk of `ensemble_chunks`; `draw` folds its members
    into the batch of one sampler call (`fold_members`)."""
    return torch.cat([draw(members) for members in ensemble_chunks(n, chunk)], dim=0)


def fold_members(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, ...) -> (k B, ...): k copies along the batch, member-major (row
    m B + b is member m of item b)."""
    return x.repeat((k,) + (1,) * (x.dim() - 1))


def fold_noise(noise: Optional[torch.Tensor], members: range, per_step: bool = False
               ) -> Optional[torch.Tensor]:
    """The caller's draws for `members`, in the folded batch's order:
    init noise (n, B, ...) -> (k B, ...); churn noise (n, N, B, ...) ->
    (N, k B, ...) with `per_step`."""
    if noise is None:
        return None
    sel = noise[members.start:members.stop]
    if per_step:
        sel = sel.transpose(0, 1)
        return sel.reshape((sel.shape[0], -1) + tuple(sel.shape[3:]))
    return sel.reshape((-1,) + tuple(sel.shape[2:]))


def scale_back_min_max(scaled: torch.Tensor, mn: torch.Tensor,
                       mx: torch.Tensor) -> torch.Tensor:
    """The inverse of `scale_each_min_max` with its (B, 1, C) minima and
    maxima (tasks/base.py:135-138 of the JAX package)."""
    b, c = scaled.shape[0], scaled.shape[-1]
    return (scaled.reshape(b, -1, c) * (mx - mn) + mn).reshape(scaled.shape)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))
