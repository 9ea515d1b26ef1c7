"""The paper's diffusion baselines in the port against the JAX package, for
each of the five model configs (configs/model/{ddim_res32, ddim_cond_h_res32,
edm_cond_h_res32, adm_cond_h_res32, adm_edm_cond_h_res32}.yaml) cut to res
16, ch 64 (32 groups of two channels, as at full width; the ADM's one
64-wide head), ch_mult [1, 1], attention at 8, with seeded non-zero
parameters:

- three train steps from one converted JAX state, each with the JAX step's
  draws from its key (antithetic timesteps, noise, the EDM sigma, the cond
  dropout and the self-conditioning branch, both branches taken where the
  model self-conditions) handed to the port by keyword, one case with
  pde_loss_lambda 0.1 and pde_loss_prop_t;
- the PDE residual the metrics read, the registry, the DDPM-as-EDM sigma
  index against JAX's float32 argmin, and the entry point as a user calls
  it (generator draws).

tests/test_torch_ddim_eval.py holds eval_step (both sampler families) with
this file's helpers.

Tolerances: the loss to 1e-5 relative at step 1 (same params, summation
order only) and 1e-4 after; Adam moves an entry by about lr whatever its gradient's
size, so params are held to 2 * lr * steps absolute (an entry whose
gradient is near zero can take the other sign on rounding) and to 1e-4 of
their scale for all but a 1e-3 share of entries; mu and nu to 1e-4 of their
scale; the PDE residual to 1e-6 on identical fields.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import CondDdimTask as JCondDdim
from m_cedm_tpu.tasks import CondEdmTask as JCondEdm
from m_cedm_tpu.tasks import DdimTask as JDdim
from m_cedm_tpu.tasks.base import TrainState, normalizers_from_stats
from m_cedm_tpu_torch.convert import jax_train_state_to_torch
from m_cedm_tpu_torch.tasks import (COND_DDIM_TARGET, DDIM_TARGET, CondDdimTask,
                                    CondEdmTask, DdimTask, build_task)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, CH, B, STEPS, LR, TRAIN_STEPS, N_SAMPLES = 16, 64, 2, 3, 2e-4, 3, 5
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1,
         "target_std": 0.3}
CONFIGS = ["ddim_res32", "ddim_cond_h_res32", "edm_cond_h_res32",
           "adm_cond_h_res32", "adm_edm_cond_h_res32"]
JAX_TASKS = {"m_cedm_tpu.tasks.DdimTask": JDdim, "m_cedm_tpu.tasks.CondDdimTask": JCondDdim,
             "m_cedm_tpu.tasks.CondEdmTask": JCondEdm}


def model_config(name, **opt):
    """(target, hparams) of configs/model/<name>.yaml at the test's size."""
    with open(os.path.join(REPO, "configs", "model", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    hp = cfg["hparams"]
    hp["model"].update(resolution=RES, ch=CH, ch_mult=[1, 1], attn_resolutions=[8])
    hp["sampler"].update(timesteps=STEPS, n_samples=N_SAMPLES, n_time_h=8, w=0.5)
    hp["optimization"].update(opt)
    return cfg["_target_"], hp


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
        if len(a.shape) > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_state(jtask, seed):
    """The state init_state builds, with the parameters' shapes traced only
    and seeded non-zero values."""
    cfg = jtask.model_cfg
    x0 = jnp.zeros((1, RES, RES, cfg.in_channels), jnp.float32)
    c0 = (jnp.zeros((1, RES, RES, cfg.cond_channels), jnp.float32)
          if cfg.cond_channels else None)
    params = seeded(jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0), x0,
                                   jnp.ones((1,), jnp.float32), c0), seed)
    n_in, n_tar = normalizers_from_stats(STATS, "gauss")
    return TrainState(params=params, ema_params=params, opt_state=jtask.tx.init(params),
                      step=jnp.zeros((), jnp.int32), normalizer_input=n_in,
                      normalizer_target=n_tar)


def jax_train_draws(jtask, key, n):
    """The JAX train step's draws from its key, as the port's keywords
    (tasks/diffusion.py:521-524, :910-932, :1183-1205)."""
    k = jax.random.split(key, 4)
    uniform = lambda kk: bool(jax.random.uniform(kk) < 0.5)
    if isinstance(jtask, JCondEdm):
        k_sigma, k_noise, k_sc, k_condp = k
        d = {"rnd_normal": np.array(jax.random.normal(k_sigma, (n, 1, 1, 1)))}
    else:
        k_t, k_noise, k_sc, k_condp = k
        d = {"t_half": np.array(jax.random.randint(k_t, (n // 2 + 1,), 0,
                                                   jtask.num_timesteps))}
    ch = jtask.u_ch if isinstance(jtask, JCondDdim) else jtask.h_ch + jtask.u_ch
    d["noise"] = np.array(jax.random.normal(k_noise, (n, RES, RES, ch)))
    if jtask.self_condition:
        d["use_sc"] = uniform(k_sc)
    if isinstance(jtask, JCondDdim):
        d["keep"] = np.float32(jax.random.uniform(k_condp) < jtask.cond_p)
    return {k_: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
            for k_, v in d.items()}


def train_keys(jtask, n_steps):
    """Step keys whose self-conditioning branch goes taken, not taken,
    taken (any keys when the model does not self-condition)."""
    want = [True, False, True]
    keys, seed = [], 100
    while len(keys) < n_steps:
        key = jax.random.PRNGKey(seed)
        seed += 1
        if (not jtask.self_condition or bool(jax.random.uniform(
                jax.random.split(key, 4)[2]) < 0.5) == want[len(keys)]):
            keys.append(key)
    return keys


def close(got, want, tol, name, floor=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


# the PDE term (pde_loss_lambda 0.1, pde_loss_prop_t) on the three DDPM
# U-Net tasks, with use_gt_pde on the joint model's
TRAIN_CASES = [
    ("ddim_res32", {"pde_loss_lambda": 0.1, "pde_loss_prop_t": True,
                    "use_gt_pde": True}),
    ("ddim_cond_h_res32", {"pde_loss_lambda": 0.1, "pde_loss_prop_t": True}),
    ("edm_cond_h_res32", {"pde_loss_lambda": 0.1, "pde_loss_prop_t": True}),
    ("adm_cond_h_res32", {}),
    ("adm_edm_cond_h_res32", {}),
]


@pytest.mark.parametrize("name,opt", TRAIN_CASES, ids=[n for n, _ in TRAIN_CASES])
def test_train_steps_match_jax(name, opt):
    target, hp = model_config(name, **opt)
    jtask = JAX_TASKS[target](to_dotdict(copy.deepcopy(hp)))
    jstate = jax_state(jtask, 0)
    task = build_task(hp, "cpu", target=target)
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    batch = swe_batch(1)
    jbatch = tuple(map(jnp.asarray, batch))
    tbatch = tuple(map(torch.from_numpy, batch))
    branches = []
    for step, key in enumerate(train_keys(jtask, TRAIN_STEPS)):
        draws = jax_train_draws(jtask, key, B)
        branches.append(draws.get("use_sc"))
        jstate, m_j = jtask.train_step(jstate, jbatch, key)
        state, m_t = task.train_step(state, tbatch, None, **draws)
        assert set(m_t) == set(m_j) | {"grad_norm"}
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=1e-5 if step == 0 else 1e-4,
                                       err_msg=f"{k} step {step}")
    if task.self_condition:
        assert branches == [True, False, True]
    if opt:
        assert "train_pde_loss" in m_t
    want = jax_train_state_to_torch(jstate)
    assert state.step == want["step"] == TRAIN_STEPS
    for k, p in want["params"].items():
        if k.endswith("attn_0.k.bias") or k.endswith("attn_1.k.bias"):
            # the key bias adds q . b to every logit of a query: softmax
            # cancels it, so its gradient is 0 in exact arithmetic and both
            # sides hold rounding noise (about 1e-11), which Adam scales to lr
            assert float(state.opt_state["mu"][k].abs().max()) <= 1e-9, k
            continue
        diff = np.abs(state.params[k].numpy() - p.numpy())
        assert diff.max() <= 2 * LR * TRAIN_STEPS, k
        assert (diff > 1e-4 * max(np.abs(p.numpy()).max(), 1e-3)).mean() <= 1e-3, k
        for mom in ("mu", "nu"):
            close(state.opt_state[mom][k].numpy(), want["opt_state"][mom][k].numpy(),
                  1e-4, f"{mom} {k}")


@pytest.mark.parametrize("name", ["ddim_res32", "ddim_cond_h_res32"])
def test_pde_residual_matches_jax(name):
    """The PDE residual the eval metrics and select_by_pde read, on the same
    fields of an untrained net's sample amplitude (tens of the data's
    scale), against JAX's."""
    target, hp = model_config(name)
    jtask = JAX_TASKS[target](to_dotdict(copy.deepcopy(hp)))
    task = build_task(hp, "cpu", target=target)
    jstate = jax_state(jtask, 3)
    state = task.init_state(None, STATS)
    rs = np.random.RandomState(9)
    h = rs.randn(4, RES, RES, 1).astype(np.float32)
    x = (20.0 * rs.randn(4, RES, RES, task.h_ch + task.u_ch)).astype(np.float32)
    if isinstance(task, CondDdimTask):
        want = jtask._pde_matrix_cond(jstate, jnp.asarray(h), jnp.asarray(x[..., :1]),
                                      clamp_loss=False)
        got = task._pde_matrix_cond(state, torch.from_numpy(h),
                                    torch.from_numpy(x[..., :1]), clamp_loss=False)
    else:
        want = jtask._pde_matrix_joint(jstate, jnp.asarray(x), clamp_loss=False)
        got = task._pde_matrix_joint(state, torch.from_numpy(x), clamp_loss=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_sigma_index_matches_jax_float32_argmin():
    target, hp = model_config("ddim_res32")
    task = build_task(hp, "cpu", target=target)
    steps32 = jnp.asarray(task.edm_steps)
    sched = task._table_edm_schedule(dict(hp["sampler"], timesteps=50))
    for sigma in np.concatenate([sched.t_hat, sched.t_next[:-1], [0.5, 3.0, 79.0]]):
        c_in, c_noise = task._c_noise(sigma)
        want = task.num_timesteps - 1 - int(jnp.argmin(jnp.abs(steps32 - jnp.float32(sigma))))
        assert c_noise == want
        assert c_in == np.float32(1.0 / jnp.sqrt(jnp.float32(sigma) ** 2 + 1.0))


def test_registry_and_entry_point():
    for name in CONFIGS:
        target, hp = model_config(name)
        task = build_task(hp, "cpu", target=target)
        assert type(task).__name__ == JAX_TASKS[target].__name__
    target, hp = model_config("ddim_res32")
    for t in (DDIM_TARGET, "models.ddim.PlDdim"):
        assert type(build_task(hp, "cpu", target=t)) is DdimTask
    _, chp = model_config("ddim_cond_h_res32")
    for t in (COND_DDIM_TARGET, "models.ddim.PlCondDdim"):
        assert type(build_task(chp, "cpu", target=t)) is CondDdimTask
    # as a user calls it: fresh init, generator draws, both branches of the
    # self-conditioning, the validation split
    task = build_task(hp, "cpu", target=target)
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch = tuple(map(torch.from_numpy, swe_batch(3)))
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        state, metrics = task.train_step(state, batch, gen)
        assert set(metrics) == {"train_loss", "grad_norm"}
        assert all(np.isfinite(float(v)) for v in metrics.values())
    runs = [task.eval_step(state, batch, torch.Generator().manual_seed(5))
            for _ in range(2)]
    (m1, x1), (m2, x2) = runs
    assert torch.equal(x1, x2) and x1.shape == (B, RES, RES, 2)
    assert all(k.startswith("val_") for k in m1)


def test_unported_sampler_options_raise():
    target, hp = model_config("ddim_cond_h_res32")
    task = build_task(hp, "cpu", target=target)
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch = tuple(map(torch.from_numpy, swe_batch(3)))
    task.set_test_sampler_params(dict(hp["sampler"], guide_dx=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task.eval_step(state, batch, None, split="test")
    edm = build_task(model_config("edm_cond_h_res32")[1], "cpu",
                     target="m_cedm_tpu.tasks.CondEdmTask")
    assert isinstance(edm, CondEdmTask)
    with pytest.raises(NotImplementedError, match="Only EDM sampler"):
        edm.sample()


@pytest.mark.parametrize("name,attr", [("ddim_res32", "DDIM_HPARAMS"),
                                       ("ddim_cond_h_res32", "DDIM_COND_HPARAMS"),
                                       ("edm_cond_h_res32", "EDM_COND_HPARAMS"),
                                       ("adm_cond_h_res32", "ADM_COND_HPARAMS")])
def test_chip_smoke_hparams_equal_the_yamls(name, attr):
    import sys

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs", "model", f"{name}.yaml")) as f:
        assert getattr(chip_smoke, attr) == yaml.safe_load(f)["hparams"]
    with open(os.path.join(REPO, "configs", "diff_sampler", "ddim_sampler.yaml")) as f:
        assert chip_smoke.DDIM_SAMPLER == yaml.safe_load(f)
