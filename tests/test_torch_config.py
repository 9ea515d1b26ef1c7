"""The port's config composition and `_target_` registry against the JAX
package's: every top-level config under configs/ with list, `+key`, nested
and group overrides composes to the same plain dict (and the same `hydra:`
block, with the clock pinned on both sides), every `_target_` under
configs/ resolves in the port's registry without importing a dotted path,
and the dataset path router routes as the JAX one does.
"""
import datetime
import glob
import os
import re

import pytest
import yaml

import m_cedm_tpu.config as jconfig
import m_cedm_tpu.utils as jutils
import m_cedm_tpu_torch.config as tconfig
import m_cedm_tpu_torch.utils as tutils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
TOP_CONFIGS = sorted(os.path.basename(p)
                     for p in glob.glob(os.path.join(CONFIG_DIR, "config_*.yaml")))
TARGETS = sorted({m.group(1) for p in glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"),
                                                recursive=True)
                  for m in re.finditer(r"_target_:\s*(\S+)", open(p).read())})
OVERRIDES = [
    "system=swe_per",                               # top-level scalar
    "trainer.max_epochs=3",                         # nested
    "+trainer.limit=7",                             # additive
    "+extra.block.value=[1, 2]",                    # additive nested list
    "seed=null",
]
MODEL_OVERRIDES = ["model.hparams.name=renamed"]


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture
def fixed_clock(monkeypatch):
    """`${now:...}` reads the clock: pin it in both packages."""
    class _Module:
        datetime = _FixedClock
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "datetime", _Module)


def test_every_top_config_is_covered():
    assert len(TOP_CONFIGS) == 8 and len(TARGETS) == 16


@pytest.mark.parametrize("name", TOP_CONFIGS)
def test_compose_equals_jax(name, fixed_clock):
    overrides = OVERRIDES + MODEL_OVERRIDES
    if "mcedm" in name:  # a list override and a group selection
        overrides += ["model.hparams.model.ch_mult=[1,2]",
                      "callbacks=callbacks_save_model"]
    got, got_hydra = tconfig.compose(CONFIG_DIR, name, overrides, return_hydra=True)
    want, want_hydra = jconfig.compose(CONFIG_DIR, name, overrides, return_hydra=True)
    assert jconfig.to_plain(want) == tconfig.to_plain(got)
    assert jconfig.to_plain(want_hydra) == tconfig.to_plain(got_hydra)
    assert "2026-01-02-03-04-05" in got_hydra.run.dir
    assert got.trainer.limit == 7 and got.extra.block.value == [1, 2]
    assert got.model.hparams.name == "renamed"  # attribute access, as in JAX


def test_compose_without_hydra_and_bad_overrides():
    name = "config_adm_edm_mcedm_res32.yaml"
    cfg = tconfig.compose(CONFIG_DIR, name[:-5])  # the .yaml suffix is optional
    assert cfg.model.hparams.model.ch == 64 and "hydra" not in cfg
    with pytest.raises(KeyError, match="not found"):
        tconfig.compose(CONFIG_DIR, name, ["trainer.no_such_key=1"])
    with pytest.raises(ValueError, match="key=value"):
        tconfig.compose(CONFIG_DIR, name, ["trainer.max_epochs"])


@pytest.mark.parametrize("target", TARGETS)
def test_every_config_target_resolves(target):
    factory = tconfig.resolve_target(target)
    assert callable(factory)


def test_instantiate_never_imports_a_dotted_path():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        tconfig.instantiate({"_target_": "os.path.join"})
    with pytest.raises(ValueError, match="_target_"):
        tconfig.instantiate({"a": 1})


def test_checkpoint_callback_node_builds(tmp_path):
    cb = yaml.safe_load(open(os.path.join(CONFIG_DIR, "callbacks", "default.yaml")))
    from m_cedm_tpu_torch.train.checkpoint import CheckpointManager

    node = dict(cb["model_checkpoint"], dirpath=str(tmp_path / "checkpoints"))
    mgr = tconfig.instantiate(node)
    assert isinstance(mgr, CheckpointManager) and mgr.monitor == "val_mae_u"
    assert mgr.max_to_keep == 2


@pytest.mark.parametrize("system", ["swe", "swe_per", "darcy", "other"])
@pytest.mark.parametrize("res,n_train", [(128, 1000), (64, 500)])
def test_override_data_folders_equals_jax(system, res, n_train):
    got = tutils.override_data_folders(tconfig.DotDict(), "root", system, res, n_train)
    want = jutils.override_data_folders(jconfig.DotDict(), "root", system, res, n_train)
    assert dict(got) == dict(want)
