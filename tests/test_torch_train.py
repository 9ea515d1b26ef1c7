"""The port's training slice against the JAX package: McedmTask.train_step over
three steps from one seeded non-zero state carried across by convert.py
(loss per step, gradients at step 1, params, EMA and the Adam state after
step 3), the optimizers against optax, the train-time mask samplers'
distributions, and the EMA copy.

The JAX draws come from its key chain (tasks/diffusion.py:343-356:
split(rng, 5), then split(k_mask, b) for the per-item masks) and are handed
to the port as keyword draws; the JAX side runs its reference math on the
CPU (the Pallas kernels are off there), the port its plain versions.

Tolerances: the loss to 1e-5 relative at step 1 (same params, summation
order only) and 1e-4 after; gradients to 1e-4 of each tensor's largest
magnitude. Adam divides by sqrt(nu): an entry whose gradient is near zero
moves by up to lr on rounding alone, so params are held to 2 * lr * steps
absolute (the sign flip bound) and to 1e-5 for all but a 1e-3 share of
entries; the EMA moves 0.001 of that; mu and nu to 1e-4 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.data import masks as jmasks
from m_cedm_tpu.models.layers import disable_conv_fusion
from m_cedm_tpu.ops import losses as jlosses
from m_cedm_tpu.ops.schedules import edm_loss_weight, edm_train_sigma
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu.tasks.base import make_optimizer as jax_make_optimizer
from m_cedm_tpu_torch.convert import (jax_params_to_state_dict,
                                      jax_train_state_to_torch)
from m_cedm_tpu_torch.data import masks as tmasks
from m_cedm_tpu_torch.tasks import build_task
from m_cedm_tpu_torch.tasks.base import make_optimizer

RES, B, STEPS, LR = 32, 2, 3, 2e-4
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1,
         "target_std": 0.3}


def hparams(optimizer="Adam", **opt):
    return {
        "name": "adm_edm_mcedm",
        "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True,
                  "out_ch": 2, "ch": 64, "ch_mult": [1, 1, 1],
                  "num_res_blocks": 1, "attn_resolutions": [8],
                  "dropout": 0.0, "resolution": RES, "ema": True,
                  "ema_rate": 0.999, "cond_p": 1.0, "dx_cond": False,
                  "self_cond": False, "add_cond_mask": False, "add_xt": False},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": optimizer, "lr": LR, **opt},
    }


def swe_batch(seed, b=B, res=RES):
    rs = np.random.RandomState(seed)
    h = (rs.randn(b, res, res, 1) * 0.1 + 4.0).astype(np.float32)
    u = (rs.randn(b, res, res, 1) * 0.2).astype(np.float32)
    tg = np.broadcast_to(np.linspace(0, 1, res)[None, :, None, None], h.shape)
    xg = np.broadcast_to(np.linspace(0, 1, res)[None, None, :, None], h.shape)
    return h, tg.astype(np.float32), xg.astype(np.float32), u


def seeded(params, seed):
    """Non-zero fan-in-scaled params (a fresh ADM init zeroes conv1, proj and
    out_conv, which would hide every gradient upstream of them)."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, params))


def jax_train_draws(key, b, res, cond_p=1.0):
    """The JAX train_step's draws from its key, as the port's keyword draws."""
    k_mask, k_cond, k_noise, k_sigma, k_condp = jax.random.split(key, 5)
    mask = jax.vmap(lambda k: jmasks.sample_train_mask_var(k, res, res, 1, 1))(
        jax.random.split(k_mask, b))
    shape = (b, res, res, 2)
    draws = dict(mask=mask, cond_noise=jax.random.normal(k_cond, shape),
                 noise=jax.random.normal(k_noise, shape),
                 rnd_normal=jax.random.normal(k_sigma, (b, 1, 1, 1)),
                 keep=(jax.random.uniform(k_condp) < cond_p).astype(jnp.float32))
    return {k: np.array(v) for k, v in draws.items()}


def jax_grads(jtask, jstate, batch, d):
    """jax.value_and_grad of the JAX train_step's loss_fn on the same draws."""
    x = jtask.transform.forward(jstate, batch[0], batch[3])
    mask = d["mask"]
    cond_in = (x * (1 - mask) + d["cond_noise"] * mask) * d["keep"]
    sigma = edm_train_sigma(d["rnd_normal"], -1.2, 1.2)
    weight = edm_loss_weight(sigma, 1.0)
    x_noise = x + mask * d["noise"] * sigma

    def loss_fn(params):
        d_x = jtask.model_precond(params, x_noise, sigma, cond_in)
        return jlosses.noise_estimation_loss(d_x * mask, x * mask, weight)

    with disable_conv_fusion():
        return jax.jit(jax.value_and_grad(loss_fn))(jstate.params)


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def test_train_step_matches_jax():
    hp = hparams()
    jtask = JaxMcedmTask(to_dotdict(hp))
    jstate = jtask.init_state(jax.random.PRNGKey(0), STATS)
    params = seeded(jstate.params, 0)
    jstate = jstate.replace(params=params, ema_params=params,
                            opt_state=jtask.tx.init(params))
    task = build_task(hp, "cpu")
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    assert state.ema_params is not state.params

    batch = swe_batch(1)
    jbatch = tuple(map(jnp.asarray, batch))
    tbatch = tuple(map(torch.from_numpy, batch))
    for step in range(STEPS):
        key = jax.random.PRNGKey(10 + step)
        draws = jax_train_draws(key, B, RES)
        tdraws = {k: torch.from_numpy(v) for k, v in draws.items()}
        if step == 0:
            loss_j, grads_j = jax_grads(jtask, jstate, jbatch, draws)
            loss_t, grads_t = task.loss_and_grads(state, tbatch, None, **tdraws)
            np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
            grads_j = jax_params_to_state_dict(grads_j)
            assert sorted(grads_t) == sorted(grads_j)
            for k in grads_j:
                _close(grads_t[k].numpy(), grads_j[k].numpy(), 1e-4, f"grad {k}")
        jstate, m_j = jtask.train_step(jstate, jbatch, key)
        state, m_t = task.train_step(state, tbatch, None, **tdraws)
        np.testing.assert_allclose(float(m_t["train_loss"]),
                                   float(m_j["train_loss"]),
                                   rtol=1e-5 if step == 0 else 1e-4)

    want = jax_train_state_to_torch(jstate)
    assert state.step == want["step"] == STEPS
    assert int(state.opt_state["count"]) == int(want["opt_state"]["count"]) == STEPS
    for k, p in want["params"].items():
        diff = np.abs(state.params[k].numpy() - p.numpy())
        assert diff.max() <= 2 * LR * STEPS, k
        assert (diff > 1e-5).mean() <= 1e-3, k
        ema_diff = np.abs(state.ema_params[k].numpy() - want["ema_params"][k].numpy())
        assert ema_diff.max() <= 2e-3 * LR * STEPS + 1e-6, k
        for mom in ("mu", "nu"):
            _close(state.opt_state[mom][k].numpy(), want["opt_state"][mom][k].numpy(),
                   1e-4, f"{mom} {k}")


# --- optimizers against optax ------------------------------------------------

@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_wd", "wd"])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "RMSProp", "SGD"])
def test_optimizer_matches_optax(name, wd, clip):
    rs = np.random.RandomState(3)
    params = {"a": rs.randn(4, 5).astype(np.float32),
              "b": rs.randn(7).astype(np.float32)}
    cfg = {"optimizer": name, "lr": 1e-2, "weight_decay": wd}
    jtx, ttx = jax_make_optimizer(cfg, clip), make_optimizer(cfg, clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        # large enough that the clip triggers, with a near-zero entry
        grads = {k: (rs.randn(*v.shape) * 2.0).astype(np.float32)
                 for k, v in params.items()}
        grads["b"][0] = 1e-9
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                            ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} step {step}")


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError):
        make_optimizer({"optimizer": "Lion", "lr": 1e-3})


# --- train-time mask samplers ----------------------------------------------

N_DRAWS, T, X = 20000, 16, 8


def _draw(kind):
    m = tmasks.TRAIN_MASK_SAMPLERS[kind](torch.Generator().manual_seed(4), N_DRAWS,
                                          T, X, 1, 1)
    assert m.shape == (N_DRAWS, T, X, 2) and m.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    return m.numpy()


def _var_split(m):
    """Shares of (input missing, target missing, both observed) read at
    (t, x) = (0, 0), which every cutoff and stride keeps observed."""
    m0 = m[:, 0, 0]
    return ((m0[:, 0] == 1) & (m0[:, 1] == 0)).mean(), \
           ((m0[:, 0] == 0) & (m0[:, 1] == 1)).mean(), (m0.sum(1) == 0).mean()


def test_var_mask_splits_50_50():
    m = _draw("var")
    inp, tar, both = _var_split(m)
    assert abs(inp - 0.5) < 0.02 and abs(tar - 0.5) < 0.02 and both == 0
    assert (m == m[:, :1, :1]).all()  # a block mask: constant over (T, X)


def _first_missing_t(m, ch):
    """Per draw, the first t at x = 0 where channel ch is missing (T if none)."""
    col = m[:, :, 0, ch]
    return np.where(col.any(1), col.argmax(1), T)


def test_time_mask_splits_and_cutoffs():
    m = _draw("time")
    inp, tar, both = _var_split(m)
    assert abs(inp - 0.4) < 0.02 and abs(tar - 0.4) < 0.02 and abs(both - 0.2) < 0.02
    for ch in (0, 1):
        observed = m[:, 0, 0, ch] == 0
        t_max = _first_missing_t(m, ch)[observed]
        assert set(np.unique(t_max)) == set(range(T // 2, T + 1))
        # missing from the cutoff on, for every x
        t_idx = np.arange(T)[None, :, None]
        want = (t_idx >= t_max[:, None, None]).astype(np.float32)
        np.testing.assert_array_equal(m[observed][..., ch], np.broadcast_to(want, (observed.sum(), T, X)))


def test_sparse_mask_splits_strides_and_cutoffs():
    m = _draw("sparse")
    inp, tar, both = _var_split(m)
    for share in (inp, tar, both):
        assert abs(share - 1 / 3) < 0.02
    for ch in (0, 1):
        observed = m[:, 0, 0, ch] == 0
        mc = m[observed][..., ch]
        # the observation stride: the first observed x > 0 on row t = 0
        stride = np.where(mc[:, 0, 1] == 0, 1, np.where(mc[:, 0, 2] == 0, 2, 4))
        assert set(np.unique(stride)) == {1, 2, 4}
        for s in (1, 2, 4):
            assert abs((stride == s).mean() - 1 / 3) < 0.02
        # cutoff: T/2 + k * res_rand, res_rand = log2(stride) + 1
        last_obs = np.array([np.nonzero(row[:, 0] == 0)[0].max() for row in mc])
        assert last_obs.min() >= 0 and last_obs.max() < T
        t_idx, x_idx = np.arange(T)[None, :, None], np.arange(X)[None, None, :]
        on_grid = (t_idx % stride[:, None, None] == 0) & (x_idx % stride[:, None, None] == 0)
        assert (mc[~np.broadcast_to(on_grid, mc.shape)] == 1).all()


def test_train_masks_match_jax_distribution():
    """Same shares as the JAX samplers over many keys (different numbers,
    same distribution)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    for kind in ("var", "time", "sparse"):
        jm = np.asarray(jax.vmap(lambda k: jmasks.TRAIN_MASK_SAMPLERS[kind](
            k, T, X, 1, 1))(keys))
        tm = _draw(kind)
        assert abs(jm.mean() - tm.mean()) < 0.02, kind
        for a, b in zip(_var_split(jm), _var_split(tm)):
            assert abs(a - b) < 0.04, kind


# --- the EMA copy and the step's guards --------------------------------------

def test_ema_is_a_copy_and_follows_the_params():
    hp = hparams()
    task = build_task(hp, "cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    # non-zero params everywhere, so that every parameter gets a gradient
    rs = np.random.RandomState(1)
    params = {k: torch.from_numpy((rs.randn(*v.shape) * 0.1).astype(np.float32))
              for k, v in state.params.items()}
    state = task.init_state(None, params=params)
    assert all(state.ema_params[k].data_ptr() != state.params[k].data_ptr()
               for k in state.params)
    batch = tuple(map(torch.from_numpy, swe_batch(2)))
    new, metrics = task.train_step(state, batch, torch.Generator().manual_seed(3))
    assert np.isfinite(float(metrics["train_loss"]))
    assert new.step == 1 and int(new.opt_state["count"]) == 1
    for k, p in new.params.items():
        assert not torch.equal(p, state.params[k]), k
        assert not torch.equal(new.ema_params[k], p), k
        torch.testing.assert_close(new.ema_params[k],
                                   0.999 * state.ema_params[k] + 0.001 * p,
                                   rtol=0, atol=1e-7)
        assert torch.equal(state.ema_params[k], params[k])  # the input state is unchanged


def test_train_step_refuses_unported_options():
    hp = hparams()
    hp["model"]["dropout"] = 0.1
    task = build_task(hp, "cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    batch = tuple(map(torch.from_numpy, swe_batch(2)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task.train_step(state, batch, torch.Generator().manual_seed(0))
    hp = hparams()
    hp["model"]["dx_cond"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_task(hp, "cpu").train_step(state, batch,
                                         torch.Generator().manual_seed(0))
