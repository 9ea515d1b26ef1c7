"""Port parity of the conditional EDM baseline (`CondEdmTask`,
configs/model/adm_edm_cond_h_res32.yaml): h observed, u sampled.

- `heun_sample_cond` against the JAX sampler, with an analytic denoiser
  written identically in both frameworks and the JAX draws reproduced by the
  same jax.random.split chain (edm.py:191-235) and injected into the port.
- `CondEdmTask.eval_step` against the JAX task's (res 32, ch 64 with
  attention at 16, 3 Heun steps, S_churn 15, seeded non-zero params applied
  to both sides through convert.py), on the port's per-conv path and on its
  megakernel path (`mega=True`; on the CPU K7's plain version).
- `get_cond_in` at its four widths, with and without the boundary-node
  channel; the registry; select_by_pde, guidance and training as a user
  runs them, the PDE guidance that is not ported yet; chip_smoke.py's copy
  of the config's hparams.

Tolerances: the sampler trajectory to 1e-5 of the state's scale (it starts
at sigma 80); the metrics to rtol 1e-5 (the correlation, which lies in
[-1, 1] and is near 0 for random weights, to 1e-5 absolute) and the sample
mean, the end of a sampler trajectory, to 1e-4 of its scale.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.samplers import edm as jedm
from m_cedm_tpu.tasks import CondEdmTask as JaxCondEdmTask
from m_cedm_tpu.tasks.base import TrainState, normalizers_from_stats
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.samplers import edm as tedm
from m_cedm_tpu_torch.tasks import COND_EDM_TARGET, CondEdmTask, build_task
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, B, STEPS = 32, 2, 3
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1,
         "target_std": 0.3}
SCHED = dict(num_steps=5, sigma_min=0.002, sigma_max=80.0, rho=7.0, S_churn=15.0)
SHAPE = (2, 8, 6, 1)


def hparams(res=RES, ch=64, cond_channels=1, node_type=False, steps=STEPS):
    return {
        "name": "adm_edm_cond_h",
        "model": {"in_channels": 1, "cond_channels": cond_channels,
                  "cat_cond": True, "out_ch": 1, "ch": ch, "ch_mult": [1, 1],
                  "num_res_blocks": 1, "attn_resolutions": [res // 2],
                  "dropout": 0.0, "resolution": res, "ema": True,
                  "self_cond": False, "dx_cond": False, "node_type": node_type},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": "Adam", "lr": 2e-4},
        "sampler": {"name": "edm", "type": "edm", "timesteps": steps,
                    "sigma_min": 0.002, "sigma_max": 80, "rho": 7,
                    "S_churn": 15.0, "S_min": 0, "S_max": "inf", "S_noise": 1,
                    "w": 0.0, "guide_dx": False, "select_by_pde": False},
        "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001,
                      "beta_end": 0.02, "num_diffusion_timesteps": 1000},
    }


def jax_denoise(x, t, key=None):
    return x / (1.0 + t * t) + 0.5 * jnp.tanh(x / (1.0 + t))


def torch_denoise(x, t):
    return x / (1.0 + t * t) + 0.5 * torch.tanh(x / (1.0 + t))


def jax_cond_draws(key, shape, n_steps):
    """heun_sample_cond's initial and per-step churn noise from its key."""
    k_init, k_loop = jax.random.split(key)
    churn = [np.array(jax.random.normal(jax.random.split(k)[0], shape, jnp.float32))
             for k in jax.random.split(k_loop, n_steps)]
    return np.array(jax.random.normal(k_init, shape, jnp.float32)), np.stack(churn)


def test_heun_sample_cond_matches_jax():
    schedule = jedm.make_edm_schedule(**SCHED)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jedm.heun_sample_cond(jax_denoise, key, SHAPE, schedule,
                                            return_last=False))
    init, churn = jax_cond_draws(key, SHAPE, schedule.num_steps)
    got = tedm.heun_sample_cond(torch_denoise, SHAPE, tedm.make_edm_schedule(**SCHED),
                                return_last=False, init_noise=torch.from_numpy(init),
                                churn_noise=torch.from_numpy(churn)).numpy()
    assert got.shape == want.shape == (SHAPE[0], 5) + SHAPE[1:]
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    last = tedm.heun_sample_cond(torch_denoise, SHAPE, tedm.make_edm_schedule(**SCHED),
                                 init_noise=torch.from_numpy(init),
                                 churn_noise=torch.from_numpy(churn))
    np.testing.assert_array_equal(last[:, 0].numpy(), got[:, -1])


def test_heun_sample_cond_generator_and_refusals():
    schedule = tedm.make_edm_schedule(**SCHED)

    def run(seed):
        return tedm.heun_sample_cond(torch_denoise, SHAPE, schedule,
                                     torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (SHAPE[0], 1) + SHAPE[1:]
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the self-conditioning carry runs (tests/test_torch_ddim.py holds it to
    # JAX's): the denoiser gets the previous step's estimate
    carried = []

    def sc_denoise(x, t, x_sc):
        carried.append(x_sc)
        return torch_denoise(x, t) + 0.1 * torch.sin(x_sc)

    sc = tedm.heun_sample_cond(sc_denoise, SHAPE, schedule,
                               torch.Generator().manual_seed(0), self_condition=True)
    assert sc.shape == a.shape and not torch.equal(sc, a)
    assert not carried[0].any() and carried[-1].any()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tedm.heun_sample_cond(torch_denoise, SHAPE, schedule, guidance_fn=torch_denoise)


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

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def jax_eval():
    hp = hparams()
    jtask = JaxCondEdmTask(to_dotdict(hp))
    # the state init_state builds, with the parameters' shapes traced only
    # (an eager flax init of the U-Net takes seconds) and seeded values
    x0 = jnp.zeros((1, RES, RES, 1), jnp.float32)
    params = seeded(jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0), x0,
                                   jnp.ones((1,), jnp.float32), x0), 0)
    n_in, n_tar = normalizers_from_stats(STATS, "gauss")
    jstate = TrainState(params=params, ema_params=params, opt_state=None,
                        step=jnp.zeros((), jnp.int32), normalizer_input=n_in,
                        normalizer_target=n_tar)
    batch = swe_batch(1)
    key = jax.random.PRNGKey(3)
    metrics, u_mean = jtask.eval_step(jstate, tuple(map(jnp.asarray, batch)), key,
                                      split="test")
    (k,) = jax.random.split(key, 1)  # the one ensemble member's key
    init, churn = jax_cond_draws(k, (B, RES, RES, 1), STEPS)
    return (hp, params, batch, {k_: float(v) for k_, v in metrics.items()},
            np.asarray(u_mean), init[None], churn[None])


@pytest.mark.parametrize("mega", [False, True], ids=["per-conv", "mega"])
def test_eval_step_matches_jax(jax_eval, mega):
    hp, params, batch, m_j, u_j, init, churn = jax_eval
    task = build_task(hp, "cpu", target=COND_EDM_TARGET, mega=mega)
    assert task.model.mega == mega and (task.h_ch, task.u_ch) == (1, 1)
    state = task.init_state(None, STATS, params=jax_params_to_state_dict(params))
    m_t, u_t = task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                              split="test", init_noise=torch.from_numpy(init),
                              churn_noise=torch.from_numpy(churn))
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        # a correlation lies in [-1, 1]: its error is measured against 1
        np.testing.assert_allclose(float(m_t[k]), m_j[k], rtol=1e-5,
                                   atol=1e-5 if "corr" in k else 0.0, err_msg=k)
    assert u_t.shape == u_j.shape == (B, RES, RES, 1)
    # a sampler trajectory: 1e-4 of scale (ROADMAP.md's parity method)
    assert np.abs(u_t.numpy() - u_j).max() <= 1e-4 * np.abs(u_j).max()


def test_eval_step_from_generator():
    """The entry point as a user calls it: fresh init, torch.Generator draws,
    the validation split (no ground-truth PDE metric)."""
    task = build_task(hparams(res=16, ch=16, steps=2), "cpu", target=COND_EDM_TARGET,
                      mega=True)
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch = tuple(map(torch.from_numpy, swe_batch(2, res=16)))
    runs = [task.eval_step(state, batch, torch.Generator().manual_seed(5))
            for _ in range(2)]
    (m1, u1), (m2, u2) = runs
    assert set(m1) == {"val_mae_u", "val_mae_u_un", "val_mae_u_scaled",
                       "val_corr_u", "val_pde_loss"}
    assert all(np.isfinite(float(v)) for v in m1.values())
    assert torch.equal(u1, u2) and u1.shape == (B, 16, 16, 1)


@pytest.mark.parametrize("width", ["h", "h+u", "h+grid", "h+u+grid"])
@pytest.mark.parametrize("node_type", [False, True])
def test_get_cond_in_matches_jax(width, node_type):
    cond_ch = {"h": 1, "h+u": 2, "h+grid": 3, "h+u+grid": 4}[width]
    hp = hparams(res=16, ch=16, cond_channels=cond_ch, node_type=node_type)
    jtask = JaxCondEdmTask(to_dotdict(hp))
    task = build_task(hp, "cpu", target=COND_EDM_TARGET)
    assert task.model_cfg.cond_channels == jtask.model_cfg.cond_channels
    h, tg, xg, u = swe_batch(4, res=16)
    want = np.asarray(jtask.get_cond_in(*map(jnp.asarray, (h, u, tg, xg))))
    got = task.get_cond_in(*map(torch.from_numpy, (h, u, tg, xg))).numpy()
    assert got.shape == want.shape == (B, 16, 16, cond_ch + node_type)
    np.testing.assert_array_equal(got, want)


def test_get_cond_in_refuses_other_widths():
    task = build_task(hparams(res=16, ch=16, cond_channels=5), "cpu",
                      target=COND_EDM_TARGET)
    x = torch.zeros(1, 16, 16, 1)
    with pytest.raises(ValueError, match="cond_channels 5"):
        task.get_cond_in(x, x, x, x)


def test_registry_config_and_unported_paths():
    with open(os.path.join(REPO, "configs/model/adm_edm_cond_h_res32.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["_target_"] == COND_EDM_TARGET
    hp = hparams(res=16, ch=16)
    for target in (COND_EDM_TARGET, "models.ddim.PlCondEdm"):
        assert isinstance(build_task(hp, "cpu", target=target), CondEdmTask)
    task = build_task(hp, "cpu", target=COND_EDM_TARGET)
    # a non-EDM sampler config falls back to the EDM defaults, as in JAX
    jtask = JaxCondEdmTask(to_dotdict(hp))
    for t in (task, jtask):
        t.set_test_sampler_params({"type": "ddim", "timesteps": 7})
    assert task.test_sparams == dict(jtask.test_sparams)
    assert task.test_sparams["n_samples"] == 5 and task.test_sparams["type"] == "edm"
    with pytest.raises(NotImplementedError, match="Only EDM sampler"):
        task.sample()
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch = tuple(map(torch.from_numpy, swe_batch(2, res=16)))
    # select_by_pde and guidance (w != 0) run, and so does training
    # (tests/test_torch_ddim_eval.py and test_torch_ddim_task.py hold them
    # to JAX's); PDE guidance still raises
    for opt in ({"select_by_pde": True, "n_samples": 2}, {"w": 1.0}):
        task.set_test_sampler_params(dict(hp["sampler"], **opt))
        m, u = task.eval_step(state, batch, torch.Generator().manual_seed(1),
                              split="test", n_samples=opt.get("n_samples", 1))
        assert u.shape == (B, 16, 16, 1) and all(torch.isfinite(v) for v in m.values())
    task.set_test_sampler_params(dict(hp["sampler"], guide_dx=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task.eval_step(state, batch, None, split="test")
    state, m = task.train_step(state, batch, torch.Generator().manual_seed(2))
    assert state.step == 1 and all(torch.isfinite(v) for v in m.values())


def test_chip_smoke_hparams_equal_cond_h_yaml():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs/model/adm_edm_cond_h_res32.yaml")) as f:
        want = yaml.safe_load(f)["hparams"]
    assert chip_smoke.COND_EDM_HPARAMS == want
    task = build_task(want, "cpu", target=COND_EDM_TARGET)
    assert (task.h_ch, task.u_ch, task.model_cfg.total_in_channels) == (1, 1, 2)
