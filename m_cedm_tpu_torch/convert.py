"""JAX (flax) parameters and train states -> the port's: the ADM U-Net and
the OFormer.

The JAX tree is a nested mapping of arrays, `['params'][<module>][<leaf>]`
with the flax module names (conv_in, map_layer0/1, out_norm, out_conv, and
per block enc_{r}x{r}_block{i}, enc_{r}x{r}_down, dec_{r}x{r}_in{0,1},
dec_{r}x{r}_up, dec_{r}x{r}_block{i} holding norm0, conv0, affine, norm1,
conv1, skip, GroupNorm_0, qkv, proj). Layouts:

  3x3 conv kernel  HWIO (3, 3, C, O)  -> weight, unchanged
  1x1 conv kernel  (1, 1, C, O)       -> weight (C, O)
  Dense kernel     (in, out)          -> weight (out, in)
  norm scale/bias                     -> weight/bias

The OFormer's modules carry the flax names (encoder.s_transformer.attn_0.
to_qkv, decoder.prop_mlp0, ...), so the same walk converts its 'params'
collection; its frozen 'constants' collection (decoder/fourier_features/B)
becomes the model's buffers, unchanged.

`jax_train_state_to_torch` carries a whole JAX TrainState across: params,
ema_params, constants, the optax Adam state (count, mu, nu; the entries of
'constants' dropped) and step, so a JAX state continues in the port
(McedmTask.init_state and OformerTask.init_state take each piece).

This is the only bridge between the two packages; it needs numpy, not JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

_MODULE_NAMES = {"GroupNorm_0": "attn_norm"}


def _leaf(name: str, arr: np.ndarray):
    if name == "scale":
        return "weight", arr
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4 and arr.shape[:2] == (1, 1):
            return "weight", arr.reshape(arr.shape[2:])
        return "weight", arr
    return name, arr


def jax_params_to_state_dict(params: Mapping, collection: str = "params"
                             ) -> Dict[str, torch.Tensor]:
    """Convert a flax parameter tree (with or without its outer collections)
    into a state_dict for the port's module of the same names; of a tree with
    collections, `collection` is taken ('constants' for the OFormer's
    buffers)."""
    tree = params[collection] if collection in params else params
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + _MODULE_NAMES.get(key, key) + ".")
            else:
                leaf, arr = _leaf(key, np.asarray(val, np.float32))
                out[prefix + leaf] = torch.from_numpy(np.array(arr))

    walk(tree, "")
    return out


def _adam_state(opt_state) -> Optional[Any]:
    """The ScaleByAdamState inside an optax chain's state (nested tuples of
    named tuples), found by its fields; None if there is none."""
    if hasattr(opt_state, "_fields") and {"count", "mu", "nu"} <= set(opt_state._fields):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _counts(opt_state):
    """Every `count` in an optax chain's state (Adam's and a schedule's)."""
    if hasattr(opt_state, "_fields") and "count" in opt_state._fields:
        return [int(np.asarray(opt_state.count))]
    if isinstance(opt_state, tuple):
        return [c for sub in opt_state for c in _counts(sub)]
    return []


def jax_train_state_to_torch(state) -> Dict[str, Any]:
    """A JAX TrainState (or anything with its attributes) -> the keyword
    arguments of the task's init_state: params, ema_params, opt_state
    ({"count", "mu", "nu"}, for the Adam and AdamW chains), step and, for a
    model with frozen buffers, constants. The port keeps one count, so the
    chain's counts (Adam's, a learning-rate schedule's) must agree. The
    normalizers are rebuilt from the data statistics, as the JAX task does."""
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise NotImplementedError("only the Adam / AdamW optimizer state is "
                                  "carried across (see ROADMAP.md)")
    if len(set(_counts(state.opt_state))) != 1:
        raise ValueError(f"optimizer counts disagree: {_counts(state.opt_state)}")
    extra = ({"constants": jax_params_to_state_dict(state.params, "constants")}
             if "constants" in state.params else {})
    return {
        **extra,
        "params": jax_params_to_state_dict(state.params),
        "ema_params": (None if state.ema_params is None
                       else jax_params_to_state_dict(state.ema_params)),
        "opt_state": {"count": torch.tensor(int(np.asarray(adam.count)),
                                            dtype=torch.int32),
                      "mu": jax_params_to_state_dict(adam.mu),
                      "nu": jax_params_to_state_dict(adam.nu)},
        "step": int(np.asarray(state.step)),
    }
