"""Hydra-compatible configuration (the port's own copy of
m_cedm_tpu/config.py; the port imports nothing of the JAX package).

Top-level configs under `configs/` compose five groups (model / datamodule /
trainer / callbacks / diff_sampler) through a `defaults:` list, CLI
dot-overrides change any node, and `_target_:` keys name what to build:

    cfg, hydra = compose("configs", "config_adm_edm_mcedm_res32.yaml",
                         ["system=swe_per", "trainer.max_epochs=1"],
                         return_hydra=True)
    datamodule = instantiate(cfg.datamodule)
    task = instantiate(cfg.model, device="cuda", grad_clip=1.0)

Supported: `defaults:` composition (group: name entries; `override
hydra/...` and `_self_` entries are accepted and ignored), dot-path CLI
overrides with YAML-typed values (and `key=null`), `+key=value` to add new
keys, `${interp}` against top-level keys and `${now:...}` timestamps.

`instantiate` resolves a `_target_` through the port's registry only: every
name under `configs/` (and the reference's torch class paths, as aliases)
maps to a factory of the port, or to one that raises NotImplementedError
naming ROADMAP.md. Unlike the JAX package it never imports a dotted path,
which would load JAX.
"""
from __future__ import annotations

import datetime
import importlib
import os
import re
from typing import Any, Callable, Dict, List, Optional

import yaml


class DotDict(dict):
    """dict with attribute access, applied recursively on load."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def get(self, key, default=None):
        return dict.get(self, key, default)


def to_dotdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return DotDict({k: to_dotdict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [to_dotdict(v) for v in obj]
    return obj


def to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    return obj


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def _lookup(expr: str, root: dict):
    """(found, value) of a dotted path under root."""
    node: Any = root
    for part in expr.split("."):
        if not (isinstance(node, dict) and part in node):
            return False, None
        node = node[part]
    return True, node


def _resolve_interp(value: Any, root: dict) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value)
        if full and not full.group(1).startswith("now:"):
            # a whole-string interpolation keeps the referenced value's type
            found, node = _lookup(full.group(1), root)
            return node if found else value

        def repl(m):
            expr = m.group(1)
            if expr.startswith("now:"):
                return datetime.datetime.now().strftime(expr[4:])
            found, node = _lookup(expr, root)
            # left unresolved when missing (e.g. hydra.job.num)
            return str(node) if found else m.group(0)

        return _INTERP_RE.sub(repl, value)
    if isinstance(value, dict):
        return {k: _resolve_interp(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_interp(v, root) for v in value]
    return value


def _parse_override_value(raw: str) -> Any:
    if raw == "null":
        return None
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_override(cfg: dict, dotted_key: str, raw_value: str) -> None:
    additive = dotted_key.startswith("+")
    key = dotted_key[1:] if additive else dotted_key
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if additive:
                node[p] = DotDict()
            else:
                raise KeyError(f"override path {key!r}: missing group {p!r}")
        node = node[p]
    leaf = parts[-1]
    if not additive and leaf not in node:
        raise KeyError(
            f"override key {key!r} not found (use +{key}=... to add new keys)")
    node[leaf] = _parse_override_value(raw_value)


def compose(config_dir: str, config_name: str,
            overrides: Optional[List[str]] = None,
            return_hydra: bool = False):
    """Compose a top-level config as `hydra.main` would.

    return_hydra=True also returns the config's `hydra:` block (run/sweep
    dirs, sweeper settings) with its interpolations resolved against the
    composed job config; hydra consumes that node rather than exposing it in
    the job config, and so do the entry points (run.py, eval_model.py)."""
    if not config_name.endswith(".yaml"):
        config_name += ".yaml"
    top = _load_yaml(os.path.join(config_dir, config_name))
    defaults = top.pop("defaults", [])

    # group selections (e.g. `callbacks=callbacks_save_model`) apply during
    # composition, as in hydra
    group_overrides, remaining_cli = {}, []
    for ov in overrides or []:
        if "=" in ov:
            k, v = ov.split("=", 1)
            if ("." not in k and not k.startswith("+")
                    and os.path.isdir(os.path.join(config_dir, k))):
                group_overrides[k] = v
                continue
        remaining_cli.append(ov)

    merged: dict = {}
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, top)
            continue
        if not isinstance(entry, dict):
            continue
        (group, name), = entry.items()
        if group.startswith("override"):
            continue  # hydra plugin overrides (sweeper/logging): not applicable
        name = group_overrides.get(group, name)
        if name is None:
            continue
        if not str(name).endswith(".yaml"):
            name = f"{name}.yaml"
        group_cfg = _load_yaml(os.path.join(config_dir, group, str(name)))
        merged = _deep_merge(merged, {group: group_cfg})
    if "_self_" not in defaults:
        merged = _deep_merge(merged, top)

    hydra_block = merged.pop("hydra", None) or {}
    cfg = to_dotdict(merged)
    for ov in remaining_cli:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key=value")
        k, v = ov.split("=", 1)
        apply_override(cfg, k, v)

    plain = to_plain(cfg)
    cfg = to_dotdict(_resolve_interp(plain, plain))
    if return_hydra:
        # hydra-internal refs (${hydra.job.num}) stay unresolved
        return cfg, to_dotdict(_resolve_interp(to_plain(hydra_block), plain))
    return cfg


# --------------------------------------------------------------------------
# _target_ instantiation
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable] = {}

# the modules whose factories the registry holds; imported on first lookup
# (they import this module, so not at its import)
_FACTORY_MODULES = (
    "m_cedm_tpu_torch.tasks",
    "m_cedm_tpu_torch.data.datamodule",
    "m_cedm_tpu_torch.data.oformer_data",
    "m_cedm_tpu_torch.train.callbacks",
    "m_cedm_tpu_torch.train.checkpoint",
    "m_cedm_tpu_torch.train.loop",
)


def register(*targets: str):
    """Register a factory under one or more `_target_` names. The reference's
    torch class paths (e.g. `models.mcedm.PlMcedm`) are registered as
    aliases, so unmodified reference configs also resolve."""

    def deco(fn):
        for t in targets:
            _REGISTRY[t] = fn
        return fn

    return deco


def resolve_target(target: str) -> Callable:
    """The factory registered under `target`; KeyError if there is none."""
    for name in _FACTORY_MODULES:
        importlib.import_module(name)
    if target not in _REGISTRY:
        raise KeyError(f"_target_ {target!r} has no factory in the port "
                       f"(see ROADMAP.md)")
    return _REGISTRY[target]


def instantiate(cfg: dict, **kwargs):
    """Build a config node: its keys but `_target_`, then `kwargs`, as keyword
    arguments of the target's factory."""
    cfg = dict(cfg)
    target = cfg.pop("_target_", None)
    if target is None:
        raise ValueError("config node has no _target_")
    return resolve_target(target)(**{**cfg, **kwargs})
