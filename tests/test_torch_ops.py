"""Port parity: schedules, Normalizer, losses, eval masks and PDE losses of
m_cedm_tpu_torch against the JAX package, on seeded numpy inputs.

Tolerances: host-side numpy schedules must match exactly (the port copies
them). Elementwise float32 math is held to rtol 1e-6 (one or two ulp: XLA
and PyTorch may round transcendental functions differently); reductions to
rtol 1e-5 (different summation order over up to a few thousand terms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.data import masks as jmasks
from m_cedm_tpu.ops import losses as jlosses
from m_cedm_tpu.ops import schedules as jsched
from m_cedm_tpu.ops.normalizer import Normalizer as JNormalizer
from m_cedm_tpu.physics import pde_loss as jpde
from m_cedm_tpu.samplers import edm as jedm
from m_cedm_tpu_torch.data import masks as tmasks
from m_cedm_tpu_torch.ops import losses as tlosses
from m_cedm_tpu_torch.ops import schedules as tsched
from m_cedm_tpu_torch.ops.normalizer import Normalizer as TNormalizer
from m_cedm_tpu_torch.physics import pde_loss as tpde
from m_cedm_tpu_torch.samplers import edm as tedm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ELEM = dict(rtol=1e-6, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(seed, shape=(2, 16, 12, 2)):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


# --- schedules --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["quad", "linear", "const", "jsd", "sigmoid"])
def test_beta_schedules_exact(kind):
    kw = dict(beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=100)
    b_j = jsched.get_beta_schedule(kind, **kw)
    b_t = tsched.get_beta_schedule(kind, **kw)
    np.testing.assert_array_equal(b_j, b_t)
    np.testing.assert_array_equal(jsched.alphas_cumprod_from_betas(b_j),
                                  tsched.alphas_cumprod_from_betas(b_t))


def test_karras_grid_exact():
    np.testing.assert_array_equal(jsched.karras_sigma_grid(50, 0.002, 80.0),
                                  tsched.karras_sigma_grid(50, 0.002, 80.0))


@pytest.mark.parametrize("kw", [
    dict(num_steps=50, sigma_min=0.002, sigma_max=80.0, rho=7.0, S_churn=15.0),
    dict(num_steps=5, sigma_min=0.002, sigma_max=80.0, rho=7.0, S_churn=15.0,
         S_min=0.05, S_max=50.0, S_noise=1.003),
    dict(num_steps=10, sigma_min=0.01, sigma_max=40.0, S_churn=0.0,
         sigma_table=np.linspace(0.01, 40.0, 64),
         alphas_cumprod=np.linspace(0.999, 0.01, 64)),
], ids=["flagship", "churn-window", "ddpm-table"])
def test_make_edm_schedule_exact(kw):
    """The sampler schedule is copied, not imported: it must match exactly."""
    s_j = jedm.make_edm_schedule(**kw)
    s_t = tedm.make_edm_schedule(**kw)
    for field in ("t_cur", "t_hat", "t_next", "is_last", "alpha_next",
                  "repeat_t_hat"):
        a, b = getattr(s_j, field), getattr(s_t, field)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert s_j.S_noise == s_t.S_noise and s_j.alpha_t0 == s_t.alpha_t0


def test_edm_precond_and_weights():
    sigma = np.exp(np.random.RandomState(0).randn(64) * 1.2 - 1.2).astype(np.float32)
    for a, b in zip(jsched.edm_precond_coeffs(sigma, 1.0),
                    tsched.edm_precond_coeffs(torch.from_numpy(sigma), 1.0)):
        np.testing.assert_allclose(_np(a), _np(b), **ELEM)
    np.testing.assert_allclose(_np(jsched.edm_loss_weight(sigma)),
                               _np(tsched.edm_loss_weight(torch.from_numpy(sigma))),
                               **ELEM)
    rnd = np.random.RandomState(1).randn(8).astype(np.float32)
    np.testing.assert_allclose(_np(jsched.edm_train_sigma(rnd)),
                               _np(tsched.edm_train_sigma(torch.from_numpy(rnd))),
                               **ELEM)
    for a, b in zip(jsched.ddpm_as_edm_coeffs(sigma),
                    tsched.ddpm_as_edm_coeffs(torch.from_numpy(sigma))):
        np.testing.assert_allclose(_np(a), _np(b), **ELEM)


@pytest.mark.parametrize("dim", [64, 33])
def test_embeddings(dim):
    t = (np.random.RandomState(2).randn(16) * 3).astype(np.float32)
    np.testing.assert_allclose(
        _np(jsched.fourier_positional_embedding(t, dim - dim % 2)),
        _np(tsched.fourier_positional_embedding(torch.from_numpy(t), dim - dim % 2)),
        rtol=1e-5, atol=1e-6)
    # DDPM timesteps reach ~600 here: one ulp of a frequency (XLA's and
    # PyTorch's exp may differ by one) moves such an angle by ~6e-5
    steps = np.arange(16).astype(np.float32) * 37.0
    np.testing.assert_allclose(
        _np(jsched.sinusoidal_timestep_embedding(steps, dim)),
        _np(tsched.sinusoidal_timestep_embedding(torch.from_numpy(steps), dim)),
        rtol=1e-5, atol=1e-4)


# --- normalizer -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gauss", "min_max", "identity"])
def test_normalizer(kind):
    x, _ = _fields(3)
    stats = (np.array([0.5, -1.0], np.float32), np.array([2.0, 0.25], np.float32))
    if kind == "identity":
        nj, nt = JNormalizer.identity((2,)), TNormalizer.identity((2,))
    else:
        nj = getattr(JNormalizer, kind)(*stats)
        nt = getattr(TNormalizer, kind)(*stats)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(nj(x)), _np(nt(xt)), **ELEM)
    np.testing.assert_allclose(_np(nj(x, inverse=True)), _np(nt(xt, inverse=True)), **ELEM)
    np.testing.assert_allclose(_np(nj.encode(x)), _np(nt.encode(xt)), **ELEM)
    np.testing.assert_allclose(_np(nj.decode(x)), _np(nt.decode(xt)), **ELEM)
    assert nj.num_channels == nt.num_channels


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mse", "l1", "smooth_l1"])
def test_elementwise_losses(kind):
    p, t = _fields(4)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(_np(jlosses.multi_loss(p, t, kind, red)),
                                   _np(tlosses.multi_loss(pt, tt, kind, red)), **RED)
    for df in (1, 2, 3):
        np.testing.assert_allclose(_np(jlosses.downsampled_loss(p, t, df, kind)),
                                   _np(tlosses.downsampled_loss(pt, tt, df, kind)),
                                   **RED)


def test_noise_estimation_loss():
    p, t = _fields(5)
    w = np.exp(np.random.RandomState(6).randn(2, 1, 1, 1)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            _np(jlosses.noise_estimation_loss(p, t, w, red)),
            _np(tlosses.noise_estimation_loss(torch.from_numpy(p), torch.from_numpy(t),
                                              torch.from_numpy(w), red)), **RED)


@pytest.mark.parametrize("loss_dim", [None, (1,), (0, 1)])
def test_masked_loss(loss_dim):
    p, t = _fields(7)
    mask = (np.random.RandomState(8).rand(*p.shape) > 0.5).astype(np.float32)
    j = jlosses.masked_loss(p, t, mask,
                            None if loss_dim is None else jnp.asarray(loss_dim))
    tt = tlosses.masked_loss(torch.from_numpy(p), torch.from_numpy(t),
                             torch.from_numpy(mask),
                             None if loss_dim is None else torch.tensor(loss_dim))
    np.testing.assert_allclose(_np(j), _np(tt), **RED)


def test_correlation_scaled_mae_lp():
    p, t = _fields(9)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    for red in ("none", "mean", "sum"):
        np.testing.assert_allclose(_np(jlosses.correlation(p, t, red)),
                                   _np(tlosses.correlation(pt, tt, red)), **RED)
        np.testing.assert_allclose(_np(jlosses.lp_loss(p, t, 2, red)),
                                   _np(tlosses.lp_loss(pt, tt, 2, red)), **RED)
    for keep in (False, True):
        np.testing.assert_allclose(_np(jlosses.scaled_mae_loss(p, t, keep)),
                                   _np(tlosses.scaled_mae_loss(pt, tt, keep)), **RED)


# --- eval masks -------------------------------------------------------------

@pytest.mark.parametrize("fn,flag", [("eval_masks_var", None),
                                     ("eval_masks_time", False),
                                     ("eval_masks_time", True),
                                     ("eval_masks_sparse", False),
                                     ("eval_masks_sparse", True)])
def test_eval_masks_exact(fn, flag):
    args = (16, 12, 1, 1) if flag is None else (16, 12, 1, 1, flag)
    mj = getattr(jmasks, fn)(*args)
    mt = getattr(tmasks, fn)(*args)
    assert list(mj) == list(mt)
    for k in mj:
        np.testing.assert_array_equal(mj[k], mt[k])
    names_j, stack_j = jmasks.stack_eval_masks(mj)
    names_t, stack_t = tmasks.stack_eval_masks(mt)
    assert names_j == names_t
    np.testing.assert_array_equal(stack_j, stack_t)


# --- PDE losses -------------------------------------------------------------

@pytest.mark.parametrize("system,flip", [("swe", False), ("swe", True),
                                         ("swe_per", False), ("darcy", False)])
def test_pde_losses(system, flip):
    rs = np.random.RandomState(10)
    pred = (1.0 + 0.2 * rs.rand(2, 16, 20, 2)).astype(np.float32)
    gt = (1.0 + 0.2 * rs.rand(2, 16, 20, 2)).astype(np.float32)
    stats = (np.float32(1.1), np.float32(0.4))
    lj, _ = jpde.get_pde_loss_function(system, flip)
    lt, _ = tpde.get_pde_loss_function(system, flip)
    nj, nt = JNormalizer.gauss(*stats), TNormalizer.gauss(*stats)
    for clamp in (False, True):
        np.testing.assert_allclose(
            _np(lj(pred, gt, nj, nj, clamp_loss=clamp)),
            _np(lt(torch.from_numpy(pred), torch.from_numpy(gt), nt, nt,
                   clamp_loss=clamp)), rtol=2e-5, atol=1e-6)


def test_pde_guidance_is_not_ported():
    lt, _ = tpde.get_pde_loss_function("swe", False)
    x = torch.ones(1, 4, 8, 2)
    n = TNormalizer.identity(())
    with pytest.raises(NotImplementedError):
        lt(x, x, n, n, return_d=True)
