"""The port's serving slice end to end: McedmTask.eval_step against the JAX
McedmTask.eval_step (5 Heun steps with S_churn 15, res 32, seeded non-zero
params applied to both sides through convert.py), with the JAX cond and
sample noise reproduced from its key by the same jax.random.split chain
(diffusion.py:440-448, edm.py:163-180) and injected into the port. Plus the
package's JAX-free runtime and chip_smoke.py's copy of the flagship hparams.

Tolerance: the four metrics to rtol 1e-5 (measured about 2e-6) and the
sample mean to 1e-5 of its scale (the state passes through sigma 80).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.data.masks import eval_masks_var
from m_cedm_tpu_torch.tasks import MCEDM_TARGET, McedmTask, build_task
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, B, STEPS = 32, 2, 5
# depth well above zero: the SWE residual divides by h, so a sampled depth
# near zero would turn last-ulp sample differences into large metric ones
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1,
         "target_std": 0.3}


def hparams(res=RES, attn=8, ch_mult=(1, 1, 1), steps=STEPS):
    return {
        "name": "adm_edm_mcedm",
        "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True,
                  "out_ch": 2, "ch": 64, "ch_mult": list(ch_mult),
                  "num_res_blocks": 1, "attn_resolutions": [attn],
                  "dropout": 0.0, "resolution": res, "ema": True, "cond_p": 1.0,
                  "dx_cond": False, "self_cond": False, "add_cond_mask": False,
                  "add_xt": False},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": "Adam", "lr": 2e-4},
        "sampler": {"timesteps": steps, "sigma_min": 0.002, "sigma_max": 80,
                    "rho": 7, "S_churn": 15.0, "S_min": 0, "S_max": "inf",
                    "S_noise": 1, "w": 0.0, "guide_dx": False},
    }


def swe_batch(seed, b=B, res=RES):
    rs = np.random.RandomState(seed)
    h = (rs.randn(b, res, res, 1) * 0.1 + 4.0).astype(np.float32)
    u = (rs.randn(b, res, res, 1) * 0.2).astype(np.float32)
    tg = np.broadcast_to(np.linspace(0, 1, res)[None, :, None, None], h.shape)
    xg = np.broadcast_to(np.linspace(0, 1, res)[None, None, :, None], h.shape)
    return h, tg.astype(np.float32), xg.astype(np.float32), u


def seeded(params, seed):
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, params))


def jax_eval_draws(key, shape, n_steps):
    """cond noise, then the single ensemble member's init and churn draws."""
    k_cond, k_sample = jax.random.split(key)
    (k,) = jax.random.split(k_sample, 1)
    k_init, k_loop = jax.random.split(k)
    churn = [np.array(jax.random.normal(jax.random.split(kk)[0], shape, jnp.float32))
             for kk in jax.random.split(k_loop, n_steps)]
    return (np.array(jax.random.normal(k_cond, shape)),
            np.array(jax.random.normal(k_init, shape, jnp.float32))[None],
            np.stack(churn)[None])


@pytest.mark.parametrize("split,mask_name", [("test", "u"), ("val", "h")])
def test_eval_step_matches_jax(split, mask_name):
    hp = hparams()
    jtask = JaxMcedmTask(to_dotdict(hp))
    jstate = jtask.init_state(jax.random.PRNGKey(0), STATS)
    params = seeded(jstate.params, 0)
    jstate = jstate.replace(params=params, ema_params=params)
    batch = swe_batch(1)
    mask = eval_masks_var(RES, RES)[mask_name]
    key = jax.random.PRNGKey(3)
    m_j, hu_j = jtask.eval_step(jstate, tuple(map(jnp.asarray, batch)), key,
                                jnp.asarray(mask), split=split,
                                mask_name=mask_name)

    task = build_task(hp, "cpu")
    state = task.init_state(None, STATS, params=jax_params_to_state_dict(params))
    cond, init, churn = map(torch.from_numpy,
                            jax_eval_draws(key, (B, RES, RES, 2), STEPS))
    m_t, hu_t = task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                               torch.from_numpy(mask), split=split,
                               mask_name=mask_name, cond_noise=cond,
                               init_noise=init, churn_noise=churn)
    assert sorted(m_t) == sorted(m_j)  # jit returns the dict key-sorted
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    hu_j = np.asarray(hu_j)
    assert np.abs(hu_t.numpy() - hu_j).max() <= 1e-5 * np.abs(hu_j).max()
    h_un = hu_j[..., 0] * STATS["input_std"] + STATS["input_mean"]
    assert h_un.min() > 0.5, "sampled depth too close to zero for this check"


def test_eval_step_from_generator():
    """The entry point as a user calls it: fresh init, torch.Generator draws."""
    res = 16
    task = build_task(hparams(res=res, attn=8, ch_mult=(1, 1), steps=2), "cpu")
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch = tuple(map(torch.from_numpy, swe_batch(2, res=res)))
    mask = torch.from_numpy(eval_masks_var(res, res)["u"])
    runs = [task.eval_step(state, batch, torch.Generator().manual_seed(5), mask,
                           split="test", mask_name="u") for _ in range(2)]
    (m1, hu1), (m2, hu2) = runs
    assert set(m1) == {"test_mae_u", "test_mae_u_un", "test_pde_loss_u",
                       "test_pde_loss_gt"}
    assert all(np.isfinite(float(v)) for v in m1.values())
    assert torch.equal(hu1, hu2) and hu1.shape == (B, res, res, 2)
    # the observed channel h is clamped to the ground truth
    gt = task.transform.forward(state, batch[0], batch[3])
    torch.testing.assert_close(hu1[..., 0], gt[..., 0], rtol=0, atol=1e-5)


def test_task_registry():
    hp = hparams()
    assert isinstance(build_task(hp, "cpu"), McedmTask)
    assert isinstance(build_task(hp, "cpu", target="models.mcedm.PlMcedm"), McedmTask)
    assert MCEDM_TARGET == yaml.safe_load(open(os.path.join(
        REPO, "configs/model/adm_edm_mcedm_res32.yaml")))["_target_"]
    # every task family is ported (the DDPM tasks are held by
    # tests/test_torch_ddim_task.py::test_registry_and_entry_point, the FNO's
    # by tests/test_torch_fno_task.py::test_registry); an unknown name raises
    fno = yaml.safe_load(open(os.path.join(REPO, "configs/model/fnostatereconstr2d.yaml")))
    assert type(build_task(fno["hparams"], "cpu", target=fno["_target_"])).__name__ == \
        "FnoStateReconstrTask"
    with pytest.raises(KeyError, match="registry"):
        build_task(hp, "cpu", target="m_cedm_tpu.tasks.NoSuchTask")


@pytest.mark.parametrize("dtype,fp32", [("float32", True), (None, True),
                                       ("bfloat16", False)])
def test_compute_dtype(dtype, fp32):
    """fp32 unless the config asks for bf16, as the JAX task reads it. A
    bf16 McedmTask serves (tests/test_torch_bf16_task.py) and trains
    (tests/test_torch_bf16_train.py): its train step keeps the master
    params, the Adam moments and the EMA in fp32."""
    hp = hparams()
    hp["model"]["dtype"] = dtype
    task = build_task(hp, "cpu")
    assert isinstance(task, McedmTask)
    assert task.compute_dtype == (None if fp32 else torch.bfloat16)
    if not fp32:
        state = task.init_state(torch.Generator().manual_seed(0), STATS)
        batch = tuple(map(torch.from_numpy, swe_batch(4)))
        state, metrics = task.train_step(state, batch, torch.Generator().manual_seed(1))
        assert all(np.isfinite(float(v)) for v in metrics.values())
        for tree in (state.params, state.ema_params, state.opt_state["mu"],
                     state.opt_state["nu"]):
            assert all(v.dtype == torch.float32 for v in tree.values())


def test_port_runtime_imports_no_jax():
    """Importing every module of the port and running a CPU forward, a
    sampling step and a train step of the flagship, an eval of the
    conditional EDM baseline on the megakernel path, a train step and a
    RePaint DDIM eval of the DDPM joint model, an eval and a train step of
    the OFormer, an eval and a train step of the OFormer's time prediction
    and of the FNO, and the CLI (run.main, then eval_model.main, with
    --device cpu on h5 data the port writes itself, for the flagship and
    the FNO config) must leave JAX, flax, optax, orbax and m_cedm_tpu
    unloaded."""
    code = r"""
import pkgutil, importlib, sys, torch
import m_cedm_tpu_torch
for m in pkgutil.walk_packages(m_cedm_tpu_torch.__path__, "m_cedm_tpu_torch."):
    importlib.import_module(m.name)
from m_cedm_tpu_torch.tasks import build_task
hp = {"name": "adm_edm_mcedm", "model": {"in_channels": 2, "cond_channels": 2,
      "cat_cond": True, "out_ch": 2, "ch": 64, "ch_mult": [1, 1],
      "num_res_blocks": 1, "attn_resolutions": [8], "resolution": 16},
      "data": {}, "sampler": {"timesteps": 2, "S_churn": 15.0},
      "optimization": {"optimizer": "Adam", "lr": 2e-4}}
task = build_task(hp, "cpu")
st = task.init_state(torch.Generator().manual_seed(0))
x = torch.ones(1, 16, 16, 1)
m, _ = task.eval_step(st, (x, x, x, x), torch.Generator(), torch.ones(16, 16, 2))
assert all(torch.isfinite(v) for v in m.values())
st, m = task.train_step(st, (x, x, x, x), torch.Generator().manual_seed(1))
assert st.step == 1 and all(torch.isfinite(v) for v in m.values())
from m_cedm_tpu_torch.kernels.fused_block import fused_unet_block, fused_unet_block_plain
from m_cedm_tpu_torch.tasks import COND_EDM_TARGET, CondEdmTask
from m_cedm_tpu_torch.tasks.diffusion import CondDdimTask, DdimTask
chp = dict(hp, name="adm_edm_cond_h", model=dict(hp["model"], in_channels=1,
           cond_channels=1, out_ch=1), sampler=dict(hp["sampler"], type="edm"),
           diffusion={"beta_schedule": "linear",
           "beta_start": 1e-4, "beta_end": 0.02, "num_diffusion_timesteps": 1000})
ctask = build_task(chp, "cpu", target=COND_EDM_TARGET, mega=True)
assert isinstance(ctask, CondEdmTask) and ctask.model.mega
cst = ctask.init_state(torch.Generator().manual_seed(0))
r = torch.rand(1, 16, 16, 1, generator=torch.Generator().manual_seed(2))
m, u = ctask.eval_step(cst, (x + r, x, x, r), torch.Generator(), split="test")
assert u.shape == (1, 16, 16, 1) and all(torch.isfinite(v) for v in m.values())
dhp = dict(chp, name="ddim", model=dict(hp["model"], ch=32, cond_channels=0,
           cat_cond=False, self_cond=True), sampler={"type": "ddim", "timesteps": 2,
           "n_repeat": 2, "n_time_h": 8})
dtask = build_task(dhp, "cpu", target="m_cedm_tpu.tasks.DdimTask")
assert isinstance(dtask, DdimTask) and type(dtask.model).__name__ == "DdpmUNet"
dst = dtask.init_state(torch.Generator().manual_seed(0))
dst, m = dtask.train_step(dst, (x + r, x, x, r), torch.Generator().manual_seed(3))
assert dst.step == 1 and all(torch.isfinite(v) for v in m.values())
m, hu = dtask.eval_step(dst, (x + r, x, x, r), torch.Generator(), split="test")
assert hu.shape == (1, 16, 16, 2) and all(torch.isfinite(v) for v in m.values())
import numpy as np
from m_cedm_tpu_torch.data.oformer_data import tokenize_grid
enc = {"input_channels": 3, "in_emb_dim": 16, "out_channels": 16, "depth": 2, "res": 4}
ohp = {"encoder": enc, "decoder": {"latent_channels": 16, "res": 4}, "lr": 1e-3}
otask = build_task(ohp, "cpu", target="m_cedm_tpu.tasks.OformerTask")
ost = otask.init_state(torch.Generator().manual_seed(0))
g = np.linspace(0, 1, 4, dtype=np.float32)[None].repeat(2, 0)
f = np.random.RandomState(0).rand(2, 2, 4, 4, 1)
tok = tokenize_grid(f[0] + 1, f[1], g, g,
                    {"input_mean": 0, "input_std": 1, "target_mean": 0, "target_std": 1})
ob = tuple(torch.from_numpy(np.ascontiguousarray(tok[k]))
           for k in ("x", "y", "node_type", "pos", "n_time"))
m, grid = otask.eval_step(ost, ob)
assert grid.shape == (2, 4, 4, 1) and all(torch.isfinite(v) for v in m.values())
ost, m = otask.train_step(ost, ob, torch.Generator().manual_seed(1))
assert ost.step == 1 and all(torch.isfinite(v) for v in m.values())
thp = {"encoder": dict(enc, input_channels=4), "decoder": {"latent_channels": 16,
       "res": 4, "out_channels": 2}, "lr": 1e-3}
ttask = build_task(thp, "cpu", target="m_cedm_tpu.tasks.OformerTimePredTask")
tst = ttask.init_state(torch.Generator().manual_seed(0), {"input_mean": 0.0,
                       "input_std": 1.0, "target_mean": 0.0, "target_std": 1.0})
ttask.set_pde_loss_function("swe_per", False)
n = 8
tb = (torch.rand(2, 1, n, 4), torch.rand(2, 1, n, 2), torch.zeros(2, n, 1, dtype=torch.int32),
      torch.zeros(2, n, 1, dtype=torch.int32), torch.rand(2, n, 2), torch.rand(2, n, 2),
      torch.full((2,), 2, dtype=torch.int32))
m, grid = ttask.eval_step(tst, tb)
assert grid.shape == (2, 2, 4, 2) and "val_pde_loss" in m
tst, m = ttask.train_step(tst, tb, torch.Generator().manual_seed(1))
assert tst.step == 1 and all(torch.isfinite(v) for v in m.values())
fhp = {"modes_1": 2, "modes_2": 2, "width": 8, "num_layers": 1, "time_history": 8,
       "lr": 1e-3}
ftask = build_task(fhp, "cpu", target="m_cedm_tpu.tasks.FnoStateReconstrTask")
fst = ftask.init_state(torch.Generator().manual_seed(0))
fb = (torch.rand(2, 8, 8, 1), torch.rand(2, 8), torch.rand(2, 8), torch.rand(2, 8, 8, 1))
fst, m = ftask.train_step(fst, fb)
assert fst.step == 1 and all(torch.isfinite(v) for v in m.values())
m, pred = ftask.eval_step(fst, fb)
assert pred.shape == (2, 8, 8, 1) and len(m) == 7
import json, os, shutil, tempfile
from m_cedm_tpu_torch import eval_model, run
from m_cedm_tpu_torch.data.h5_io import write_store
tmp = tempfile.mkdtemp()
try:
    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(tmp, "1D_swp_128_per"))
    for split, n in (("train", 4), ("test", 2)):
        write_store(os.path.join(tmp, "1D_swp_128_per", f"1D_swp_128_per_{split}.h5"),
                    1.0 + 0.1 * rs.rand(n, 16, 16, 1), 0.1 * rs.randn(n, 16, 16, 1),
                    np.linspace(-0.5, 0.5, 16), np.linspace(0, 0.128, 16))
    tiny = ["system=swe_per", "trainer.max_epochs=1", "datamodule.batch_size=2",
            "model.hparams.model.resolution=16", "model.hparams.model.ch=16",
            "model.hparams.model.attn_resolutions=[8]",
            "model.hparams.model.ch_mult=[1,1]", "diff_sampler.timesteps=2",
            "callbacks=callbacks_save_model", f"dataroot={tmp}"]
    cfg = ["--device", "cpu", "--config-name=config_adm_edm_mcedm_res32.yaml"]
    run.main(cfg + tiny + [f"hydra.run.dir={tmp}/run"])
    eval_model.main(cfg + tiny + [f"ckpt_path={tmp}/run", f"hydra.run.dir={tmp}/ev"])
    recs = [json.loads(l) for l in open(os.path.join(tmp, "ev", "metrics.jsonl"))]
    assert "test_mae_u" in recs[-1]
    fno = ["--device", "cpu", "--config-name=config_fnostatereconstrabs2d.yaml",
           "system=swe_per", "trainer.max_epochs=1", "datamodule.batch_size=2",
           "model.hparams.width=8", "model.hparams.num_layers=1",
           "model.hparams.modes_1=2", "model.hparams.modes_2=2",
           "model.hparams.time_history=16", "callbacks=callbacks_save_model",
           f"dataroot={tmp}"]
    run.main(fno + [f"hydra.run.dir={tmp}/fno"])
    eval_model.main(fno + [f"ckpt_path={tmp}/fno", f"hydra.run.dir={tmp}/fno_ev"])
    recs = [json.loads(l) for l in open(os.path.join(tmp, "fno_ev", "metrics.jsonl"))]
    assert "test_mae_u_scaled" in recs[-1]
finally:
    shutil.rmtree(tmp)
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                                      "optax", "orbax", "m_cedm_tpu")]
assert not bad, bad
print("ok")
"""
    # one intra-op thread, as torch_threads gives the in-process tests
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_hparams_equal_flagship_yaml():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs/model/adm_edm_mcedm_res32.yaml")) as f:
        want = yaml.safe_load(f)["hparams"]
    assert chip_smoke.FLAGSHIP_HPARAMS == want


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
