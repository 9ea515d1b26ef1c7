"""Port parity of the masked Heun (EDM) sampler against m_cedm_tpu's, with an
analytic denoiser written identically in both frameworks, and the JAX
sampler's random draws reproduced by the same jax.random.split chain
(edm.py:163-180) and injected into the port.

Tolerance: the state reaches sigma_max = 80, so errors are measured against
the largest state magnitude: 1e-6 of it for one step (float32 rounding of
the same formulas), 1e-5 for a 5-step trajectory with churn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.samplers import edm as jedm
from m_cedm_tpu_torch.samplers import edm as tedm

SHAPE = (2, 8, 6, 2)
SCHED = dict(num_steps=5, sigma_min=0.002, sigma_max=80.0, rho=7.0, S_churn=15.0)


# a smooth, well-conditioned stand-in for the network: its output moves by
# less than its input does, so the test measures the sampler, not the
# amplification of last-ulp differences between the frameworks' tanh
def jax_denoise(x, t, key=None):
    return x / (1.0 + t * t) + 0.5 * jnp.tanh(x / (1.0 + t))


def torch_denoise(x, t):
    return x / (1.0 + t * t) + 0.5 * torch.tanh(x / (1.0 + t))


def _mask():
    m = np.zeros(SHAPE, np.float32)
    m[..., 1] = 1.0
    m[0, :3, :, 0] = 1.0
    return m


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("is_last", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_heun_step_parity(is_last, masked):
    rs = np.random.RandomState(0)
    x = (rs.randn(*SHAPE) * 3).astype(np.float32)
    t_hat, t_next = np.float32(2.5), np.float32(0.0 if is_last else 1.7)
    mask = _mask() if masked else None
    want, den_j = jedm._heun_step(
        jax_denoise, None, jnp.asarray(x), jnp.float32(t_hat), jnp.float32(t_next),
        jnp.asarray(is_last), jax.random.PRNGKey(0),
        update_mask=None if mask is None else jnp.asarray(mask))
    got, den_t = tedm._heun_step(
        torch_denoise, torch.from_numpy(x), t_hat, t_next, is_last,
        update_mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want, 1e-6)
    _close(den_t, den_j, 1e-6)


def jax_draws(key, n_steps):
    """The initial and per-step churn noise heun_sample_masked draws."""
    k_init, k_loop = jax.random.split(key)
    init = jax.random.normal(k_init, SHAPE, jnp.float32)
    churn = [jax.random.normal(jax.random.split(k)[0], SHAPE, jnp.float32)
             for k in jax.random.split(k_loop, n_steps)]
    return np.array(init), np.stack([np.array(c) for c in churn])


def test_masked_trajectory_parity():
    rs = np.random.RandomState(1)
    known = rs.randn(*SHAPE).astype(np.float32)
    mask = _mask()
    schedule = jedm.make_edm_schedule(**SCHED)
    key = jax.random.PRNGKey(7)
    want = jedm.heun_sample_masked(jax_denoise, key, jnp.asarray(known),
                                   jnp.asarray(mask), schedule, return_last=False)
    init, churn = jax_draws(key, schedule.num_steps)
    got = tedm.heun_sample_masked(
        torch_denoise, torch.from_numpy(known), torch.from_numpy(mask),
        tedm.make_edm_schedule(**SCHED), return_last=False,
        init_noise=torch.from_numpy(init), churn_noise=torch.from_numpy(churn))
    assert got.shape == want.shape == (SHAPE[0], 5) + SHAPE[1:]
    _close(got.numpy(), want, 1e-5)
    # the observed region (mask == 0) is held at its known values throughout
    np.testing.assert_array_equal(got.numpy()[:, -1][mask == 0], known[mask == 0])


def test_generator_draws_are_reproducible():
    known = torch.from_numpy(np.random.RandomState(2).randn(*SHAPE).astype(np.float32))
    mask = torch.from_numpy(_mask())
    schedule = tedm.make_edm_schedule(**SCHED)

    def run(seed):
        return tedm.heun_sample_masked(torch_denoise, known, mask, schedule,
                                       torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (SHAPE[0], 1) + SHAPE[1:]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, 0][mask == 0], known[mask == 0])
