"""eval_step of the paper's diffusion baselines in the port against the JAX
package's, at tests/test_torch_ddim_task.py's sizes: both sampler families
where the task has both (DDPM-as-EDM Heun with RePaint or with the
conditioning; DDIM RePaint or conditional DDIM), with w 0.5, select_by_pde
and five ensemble members folded into the batch, each member's draws
replayed from JAX's key chain (tests/test_torch_ddim.py's helpers); n_time_h
8 of T 16 for the joint model, so the known-region keys appear.

Tolerances: the metrics to rtol 1e-5 (a correlation near 0 to 1e-5
absolute, the known region's errors, 0 up to rounding, to 1e-6 absolute);
test_pde_loss as JAX's PDE residual of the port's own samples (see the
test); the returned mean sample to 1e-4 of its scale.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.tasks import DDIM_TARGET, CondDdimTask, build_task
from test_torch_ddim import (ddim_cond_draws, ddim_repaint_draws,
                             heun_cond_draws, heun_repaint_draws)
from test_torch_ddim_task import (B, JAX_TASKS, N_SAMPLES, RES, STATS, STEPS,
                                  close, jax_state, model_config, swe_batch)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DDIM_SAMPLER = {"name": "ddim", "type": "ddim", "timesteps": STEPS,
                "skip_type": "uniform", "eta": 0.0, "n_samples": N_SAMPLES,
                "n_repeat": 2, "n_time_h": 8, "n_time_u": 0, "select_by_pde": False,
                "use_gt_pde_select": True, "guide_dx": False, "w": 0.5}


def jax_eval_draws(task, sp, key, n):
    """Each ensemble member's draws from its key (split(key, n)), stacked as
    the port's eval_step takes them."""
    per = []
    for k in jax.random.split(key, n):
        if isinstance(task, CondDdimTask):
            shape = (B, RES, RES, task.u_ch)
            if sp["type"] == "edm":
                init, churn = heun_cond_draws(k, shape, STEPS)
                per.append({"init_noise": init, "churn_noise": churn})
            else:
                init, _ = ddim_cond_draws(k, shape, STEPS)
                per.append({"init_noise": init})
        else:
            shape = (B, RES, RES, task.h_ch + task.u_ch)
            if sp["type"] == "edm":
                init, churn, rep = heun_repaint_draws(k, shape, STEPS, sp["n_repeat"])
                per.append({"init_noise": init, "churn_noise": churn,
                            "repeat_noise": rep})
            else:
                init, _ = ddim_repaint_draws(k, shape, STEPS)
                per.append({"init_noise": init})
    return {name: torch.from_numpy(np.stack([p[name] for p in per])) for name in per[0]}


def metric_atol(key):
    """A correlation lies in [-1, 1] and is near 0 for random weights; the
    known region's errors are 0 up to rounding (the sampler inserts it)."""
    if "corr" in key:
        return 1e-5
    return 1e-6 if "_known" in key else 0.0


# the joint model with both samplers; the conditional DDPM with DDIM (with
# self-conditioning) and, on the ADM U-Net's megakernel path, with the
# DDPM-as-EDM Heun sampler; the conditional EDM with select_by_pde
EVAL_CASES = [
    ("ddim_res32", "edm", True), ("ddim_res32", "ddim", False),
    ("ddim_cond_h_res32", "ddim", False), ("adm_cond_h_res32", "edm", True),
    ("edm_cond_h_res32", "edm", True),
]


@pytest.mark.parametrize("name,sampler,select", EVAL_CASES,
                         ids=[f"{n}-{s}" + ("-select" if sel else "")
                              for n, s, sel in EVAL_CASES])
def test_eval_step_matches_jax(name, sampler, select):
    target, hp = model_config(name)
    sp = dict(hp["sampler"] if sampler == "edm" else DDIM_SAMPLER,
              select_by_pde=select)
    jtask = JAX_TASKS[target](to_dotdict(copy.deepcopy(hp)))
    jtask.set_test_sampler_params(sp)
    jstate = jax_state(jtask, 3)
    batch = swe_batch(2)
    key = jax.random.PRNGKey(7)
    m_j, mean_j = jtask.eval_step(jstate, tuple(map(jnp.asarray, batch)), key,
                                  split="test", n_samples=N_SAMPLES)
    task = build_task(hp, "cpu", target=target, mega=name.startswith("adm"))
    task.set_test_sampler_params(sp)
    state = task.init_state(None, STATS, params=jax_params_to_state_dict(jstate.params))
    # record the fields whose PDE residual makes test_pde_loss (the first
    # residual of the eval's samples)
    residual = "_pde_matrix_cond" if isinstance(task, CondDdimTask) else "_pde_matrix_joint"
    seen = []
    setattr(task, residual, lambda *a, _f=getattr(task, residual), **k:
            seen.append((a, k)) or _f(*a, **k))
    m_t, mean_t = task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                                 split="test", n_samples=N_SAMPLES,
                                 **jax_eval_draws(task, sp, key, N_SAMPLES))
    assert sorted(m_t) == sorted(m_j)
    if target == DDIM_TARGET:
        assert {"test_h_known", "test_h_kn_scaled", "test_h_unkn_scaled",
                "test_mae_hu_un"} <= set(m_t)
    for k in m_j:
        if k == "test_pde_loss":
            continue
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   atol=metric_atol(k), err_msg=k)
    # test_pde_loss: the PDE residual of an untrained net's samples (tens to
    # hundreds of the data's scale; DDPM-as-EDM's D = x - sigma F at sigma
    # 80) amplifies the samples' 1e-5 difference up to a few percent, so it
    # is held as JAX's residual of the port's own samples, which the mean
    # sample and the other metrics hold to JAX's
    (args, kw), = seen[:1]
    fields = [jnp.asarray(a.numpy()) for a in args[1:]]
    want_pde = float(jnp.sum(getattr(jtask, residual)(jstate, *fields, **kw))
                     / N_SAMPLES / B)
    np.testing.assert_allclose(float(m_t["test_pde_loss"]), want_pde, rtol=1e-5)
    assert mean_t.shape == mean_j.shape
    close(mean_t.numpy(), np.asarray(mean_j), 1e-4, "mean sample")
