"""The port's DDIM / RePaint samplers (m_cedm_tpu_torch/samplers/ddim.py) and
the Heun samplers' RePaint loop and self-conditioning carry
(samplers/edm.py) against the JAX package's, with analytic eps / denoise
functions written identically in both frameworks.

The JAX draws come from the samplers' own jax.random.split chains
(samplers/ddim.py, samplers/edm.py) and are injected into the port by
keyword; the helpers here serve tests/test_torch_ddim_task.py too.

Tolerances: the schedules exactly; a trajectory to 1e-4 of its scale (the
samplers start from unit noise, or at sigma 80 for the Heun ones, and every
step is a few fp32 products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.ops.schedules import alphas_cumprod_from_betas, get_beta_schedule
from m_cedm_tpu.samplers import ddim as jddim
from m_cedm_tpu.samplers import edm as jedm
from m_cedm_tpu_torch.samplers import ddim as tddim
from m_cedm_tpu_torch.samplers import edm as tedm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T_TRAIN = 1000
ABAR = alphas_cumprod_from_betas(get_beta_schedule(
    "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=T_TRAIN))
SHAPE = (2, 8, 6, 2)
STEPS = 4


def normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def stack_steps(keys, fn):
    return np.stack([fn(k) for k in keys])


# --- the JAX samplers' draws from their keys ------------------------------

def ddim_cond_draws(key, shape, n_steps, eta=0.0):
    """ddim_sample_cond: (init_noise, eta_noise or None)."""
    k_init, k_loop = jax.random.split(key)
    eta_noise = (stack_steps(jax.random.split(k_loop, n_steps),
                             lambda k: normal(jax.random.split(k)[1], shape))
                 if eta else None)
    return normal(k_init, shape), eta_noise


def ddim_repaint_draws(key, shape, n_steps, eta=0.0):
    """ddim_sample_repaint: (init_noise, eta_noise or None)."""
    k_noise, k_loop = jax.random.split(key)
    eta_noise = (stack_steps(jax.random.split(k_loop, n_steps),
                             lambda k: normal(jax.random.split(k)[0], shape))
                 if eta else None)
    return normal(k_noise, shape), eta_noise


def ddim_joint_h_draws(key, h_shape, n_steps, eta=0.0):
    """ddim_sample_joint_h: (h_noise, u_noise, eta_noise or None)."""
    k_h, k_u, k_loop = jax.random.split(key, 3)
    x_shape = h_shape[:3] + (2 * h_shape[3],)
    eta_noise = (stack_steps(jax.random.split(k_loop, n_steps),
                             lambda k: normal(jax.random.split(k)[1], x_shape))
                 if eta else None)
    return normal(k_h, h_shape), normal(k_u, h_shape), eta_noise


def heun_cond_draws(key, shape, n_steps):
    """heun_sample_cond: (init_noise, churn_noise)."""
    k_init, k_loop = jax.random.split(key)
    return normal(k_init, shape), stack_steps(
        jax.random.split(k_loop, n_steps), lambda k: normal(jax.random.split(k)[0], shape))


def heun_repaint_draws(key, shape, n_steps, n_repeat):
    """heun_sample_repaint: (init_noise, churn_noise, repeat_noise (N *
    n_repeat, ...), the round r of step i at i * n_repeat + r)."""
    k_noise, k_loop = jax.random.split(key)
    churn, repeat = [], []
    for k in jax.random.split(k_loop, STEPS if n_steps is None else n_steps):
        k_churn, k_inner = jax.random.split(k)
        churn.append(normal(k_churn, shape))
        repeat += [normal(jax.random.split(rk)[0], shape)
                   for rk in jax.random.split(k_inner, n_repeat)]
    return normal(k_noise, shape), np.stack(churn), np.stack(repeat)


# --- analytic nets, identical in both frameworks -----------------------------

def jax_eps(x, t, x_sc, key=None):
    e = 0.3 * x + 0.1 * jnp.tanh(x * (1.0 + t / 500.0))
    return e if x_sc is None else e + 0.05 * x_sc


def torch_eps(x, t, x_sc):
    e = 0.3 * x + 0.1 * torch.tanh(x * (1.0 + t / 500.0))
    return e if x_sc is None else e + 0.05 * x_sc


def jax_denoise(x, t, key=None, x_sc=None):
    d = x / (1.0 + t * t) + 0.5 * jnp.tanh(x / (1.0 + t))
    return d if x_sc is None else d + 0.1 * jnp.sin(x_sc)


def torch_denoise(x, t, x_sc=None):
    d = x / (1.0 + t * t) + 0.5 * torch.tanh(x / (1.0 + t))
    return d if x_sc is None else d + 0.1 * torch.sin(x_sc)


def close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def known_and_mask(seed=0):
    rs = np.random.RandomState(seed)
    known = rs.randn(*SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :5, :, :1] = 1.0  # the first rows of h observed
    return known, mask


# --- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("skip_type,steps", [("uniform", 50), ("uniform", 7),
                                             ("quad", 50), ("quad", 9)])
@pytest.mark.parametrize("eta", [0.0, 0.01])
def test_ddim_schedule_matches_jax(skip_type, steps, eta):
    want = jddim.make_ddim_schedule(ABAR, steps, skip_type, eta)
    got = tddim.make_ddim_schedule(ABAR, steps, skip_type, eta)
    for field in ("t", "at", "at_next"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.eta, got.a_init, got.num_steps) == (want.eta, want.a_init, want.num_steps)


def test_ddim_schedule_refuses_unknown_skip():
    with pytest.raises(NotImplementedError):
        tddim.make_ddim_schedule(ABAR, 10, "cubic")


# --- DDIM samplers -------------------------------------------------------------

@pytest.mark.parametrize("self_condition", [False, True], ids=["plain", "self_cond"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_cond_matches_jax(self_condition, eta):
    sched_j = jddim.make_ddim_schedule(ABAR, STEPS, "uniform", eta)
    key = jax.random.PRNGKey(4)
    want = jddim.ddim_sample_cond(jax_eps, key, SHAPE, sched_j,
                                  self_condition=self_condition, return_last=False)
    init, eta_noise = ddim_cond_draws(key, SHAPE, STEPS, eta)
    got = tddim.ddim_sample_cond(torch_eps, SHAPE, tddim.make_ddim_schedule(
        ABAR, STEPS, "uniform", eta), self_condition=self_condition,
        return_last=False, init_noise=t(init), eta_noise=t(eta_noise))
    close(got.numpy(), want)
    last = tddim.ddim_sample_cond(torch_eps, SHAPE, tddim.make_ddim_schedule(
        ABAR, STEPS, "uniform", eta), self_condition=self_condition,
        init_noise=t(init), eta_noise=t(eta_noise))
    np.testing.assert_array_equal(last[:, 0].numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("self_condition", [False, True], ids=["plain", "self_cond"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_repaint_matches_jax(self_condition, eta):
    known, mask = known_and_mask()
    sched_j = jddim.make_ddim_schedule(ABAR, STEPS, "uniform", eta)
    key = jax.random.PRNGKey(5)
    want = jddim.ddim_sample_repaint(jax_eps, key, known, mask, sched_j, n_repeat=2,
                                     self_condition=self_condition, return_last=False)
    init, eta_noise = ddim_repaint_draws(key, SHAPE, STEPS, eta)
    got = tddim.ddim_sample_repaint(
        torch_eps, t(known), t(mask), tddim.make_ddim_schedule(ABAR, STEPS, "uniform", eta),
        n_repeat=2, self_condition=self_condition, return_last=False,
        init_noise=t(init), eta_noise=t(eta_noise))
    close(got.numpy(), want)


@pytest.mark.parametrize("self_condition", [False, True], ids=["plain", "self_cond"])
def test_ddim_sample_joint_h_matches_jax(self_condition):
    h = np.random.RandomState(2).randn(*SHAPE[:3], 1).astype(np.float32)
    sched_j = jddim.make_ddim_schedule(ABAR, STEPS, "quad", 0.0)
    key = jax.random.PRNGKey(6)
    want = jddim.ddim_sample_joint_h(jax_eps, key, h, sched_j, h_ch=1,
                                     self_condition=self_condition, return_last=False)
    h_noise, u_noise, _ = ddim_joint_h_draws(key, h.shape, STEPS)
    got = tddim.ddim_sample_joint_h(
        torch_eps, t(h), tddim.make_ddim_schedule(ABAR, STEPS, "quad", 0.0), h_ch=1,
        self_condition=self_condition, return_last=False, h_noise=t(h_noise),
        u_noise=t(u_noise))
    close(got.numpy(), want)


def test_ddim_samplers_from_generator_and_refusals():
    sched = tddim.make_ddim_schedule(ABAR, STEPS, "uniform", 0.5)
    known, mask = known_and_mask()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (tddim.ddim_sample_cond(torch_eps, SHAPE, sched, g),
                tddim.ddim_sample_repaint(torch_eps, t(known), t(mask), sched, 2, g),
                tddim.ddim_sample_joint_h(torch_eps, t(known[..., :1]), sched, 1, g))

    a, b, c = run(0), run(0), run(1)
    for x, y, z in zip(a, b, c):
        assert x.shape == (SHAPE[0], 1) + SHAPE[1:]
        assert torch.equal(x, y) and not torch.equal(x, z)
    # the repaint sampler holds the known region at its clean values
    np.testing.assert_allclose((a[1][:, 0].numpy() * mask), known * mask, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tddim.ddim_sample_cond(torch_eps, SHAPE, sched, guidance_fn=torch_eps)


# --- Heun: RePaint and the self-conditioning carry -------------------------------

def table_schedule(mod, alphas=True):
    steps = np.sqrt((1.0 - ABAR) / ABAR)[::-1].copy()
    return mod.make_edm_schedule(
        num_steps=STEPS, sigma_min=max(0.002, float(steps[-1])),
        sigma_max=min(80.0, float(steps[0])), rho=7.0, S_churn=15.0,
        sigma_table=steps, alphas_cumprod=ABAR if alphas else None)


@pytest.mark.parametrize("n_repeat", [1, 2])
def test_heun_sample_repaint_matches_jax(n_repeat):
    known, mask = known_and_mask(1)
    key = jax.random.PRNGKey(7)
    want = jedm.heun_sample_repaint(jax_denoise, key, known, mask, table_schedule(jedm),
                                    n_repeat=n_repeat, return_last=False)
    init, churn, repeat = heun_repaint_draws(key, SHAPE, STEPS, n_repeat)
    got = tedm.heun_sample_repaint(torch_denoise, t(known), t(mask), table_schedule(tedm),
                                   n_repeat=n_repeat, return_last=False,
                                   init_noise=t(init), churn_noise=t(churn),
                                   repeat_noise=t(repeat))
    close(got.numpy(), want)
    # the last step inserts the clean known part
    np.testing.assert_array_equal(got[:, -1].numpy() * mask, known * mask)


def test_heun_sample_repaint_generator_and_refusals():
    known, mask = known_and_mask(1)
    sched = table_schedule(tedm)
    a, b = (tedm.heun_sample_repaint(torch_denoise, t(known), t(mask), sched, 2,
                                     torch.Generator().manual_seed(3)) for _ in range(2))
    assert a.shape == (SHAPE[0], 1) + SHAPE[1:] and torch.equal(a, b)
    with pytest.raises(ValueError, match="alphas_cumprod"):
        tedm.heun_sample_repaint(torch_denoise, t(known), t(mask),
                                 table_schedule(tedm, alphas=False))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tedm.heun_sample_repaint(torch_denoise, t(known), t(mask), sched,
                                 guidance_fn=torch_denoise)


def test_heun_sample_cond_self_condition_matches_jax():
    sched_args = dict(num_steps=5, sigma_min=0.002, sigma_max=80.0, rho=7.0, S_churn=15.0)
    key = jax.random.PRNGKey(8)
    want = jedm.heun_sample_cond(jax_denoise, key, SHAPE, jedm.make_edm_schedule(**sched_args),
                                 return_last=False, self_condition=True)
    init, churn = heun_cond_draws(key, SHAPE, 5)
    got = tedm.heun_sample_cond(torch_denoise, SHAPE, tedm.make_edm_schedule(**sched_args),
                                return_last=False, init_noise=t(init),
                                churn_noise=t(churn), self_condition=True)
    close(got.numpy(), want)
    plain = tedm.heun_sample_cond(torch_denoise, SHAPE, tedm.make_edm_schedule(**sched_args),
                                  return_last=False, init_noise=t(init),
                                  churn_noise=t(churn))
    assert not torch.equal(plain, got)  # the carry changes the trajectory
