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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_task(hp, "cpu", target="m_cedm_tpu.tasks.DdimTask")


@pytest.mark.parametrize("dtype,ported", [("float32", True), (None, True),
                                          ("bfloat16", False)])
def test_compute_dtype(dtype, ported):
    """fp32 unless the config asks for bf16, as the JAX task reads it; bf16
    compute is a later slice."""
    hp = hparams()
    hp["model"]["dtype"] = dtype
    if ported:
        assert isinstance(build_task(hp, "cpu"), McedmTask)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_task(hp, "cpu")


def test_port_runtime_imports_no_jax():
    """Importing every module of the port and running a CPU forward, a
    sampling step and a train step of the flagship and an eval and a train
    step of the OFormer must leave JAX, flax, optax and m_cedm_tpu
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
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                                      "optax", "m_cedm_tpu")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
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
