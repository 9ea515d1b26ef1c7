"""The OFormer's time prediction in the port against the JAX package's, on
the CPU: PlOformerSwpTimePredDatamodule (the seven batch arrays, in order,
from one h5 fixture), OformerTimePredTask (eval with the PDE keys, three
train steps with JAX's dropout masks, each also alone from JAX's state
before it), OformerStateTimePredTask.test_step,
and the linear-attention sites each forward runs (chip_smoke.py asserts
the K5 / K6 launches from them).

Both sides fp32 from the same seeded non-zero parameters, on a 16 x 16 grid
split at n_history 8. Tolerances as tests/test_torch_oformer_task.py holds
the reconstruction: the metrics to rtol 1e-5 (the correlation to 1e-5
absolute), the prediction to 1e-5 of its scale, the loss to rtol 1e-5;
after each AdamW step the params and the first moment to 1e-4 of their
scale and the second moment to 2e-4 (it holds squared gradients, whose
relative error is twice the gradients'), and the params after three steps
to 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.data import oformer_data as joformer
from m_cedm_tpu.tasks import oformer as jtasks
from m_cedm_tpu_torch import kernels
from m_cedm_tpu_torch.convert import jax_train_state_to_torch
from m_cedm_tpu_torch.data import h5_io as th5
from m_cedm_tpu_torch.data import oformer_data as toformer
from m_cedm_tpu_torch.data.h5_io import write_store
from m_cedm_tpu_torch.tasks import build_task
from m_cedm_tpu_torch.tasks import oformer as ttasks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T, X, N_HIST, STEPS = 16, 16, 8, 3
TIME_TARGET = "m_cedm_tpu.tasks.OformerTimePredTask"
STATE_TIME_TARGET = "m_cedm_tpu.tasks.OformerStateTimePredTask"


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Shallow-water-like (h, u) trajectories on a (T, X) grid, written in
    the reference h5 layout (train 6, test 3)."""
    root = tmp_path_factory.mktemp("h5")
    rs = np.random.RandomState(0)
    x = np.linspace(-0.5, 0.5, X, dtype=np.float32)
    t = np.linspace(0, 0.128, T, dtype=np.float32)
    out = {}
    for split, n in (("train", 6), ("test", 3)):
        h = (1.2 + 0.3 * np.sin(2 * np.pi * (x[None, None] - t[None, :, None]
                                             - rs.rand(n, 1, 1)))
             + 0.05 * rs.randn(n, T, X))[..., None].astype(np.float32)
        u = (0.1 + 0.4 * np.cos(2 * np.pi * x[None, None] + t[None, :, None])
             + 0.05 * rs.randn(n, T, X))[..., None].astype(np.float32)
        out[split] = str(root / f"{split}.h5")
        write_store(out[split], h, u, np.tile(x, (n, 1)), np.tile(t, (n, 1)))
    return {"train_path": out["train"], "val_path": out["test"], "test_path": out["test"]}


def dm_kw(paths, **kw):
    return dict(paths, batch_size=4, return_abs_coords=True, norm_x=True, norm_t=True,
                add_t=True, train_2d=True, n_history=N_HIST, **kw)


@pytest.mark.parametrize("add_t,flip_xy", [(True, False), (False, True)])
def test_datamodule_arrays_equal_jax(paths, add_t, flip_xy):
    kw = dm_kw(paths, flip_xy=flip_xy)
    kw["add_t"] = kw["train_2d"] = add_t
    got_dm = toformer.PlOformerSwpTimePredDatamodule(**kw)
    want_dm = joformer.PlOformerSwpTimePredDatamodule(**kw)
    assert got_dm.field_shape("test") == want_dm.field_shape("test")
    assert got_dm.get_norm_stats().keys() == want_dm.get_norm_stats().keys()
    for split, seed in (("train", 1), ("test", None)):
        assert got_dm.num_batches(split) == want_dm.num_batches(split)
        rng = lambda: None if seed is None else np.random.default_rng(seed)
        got = list(got_dm.iter_split(split, rng()))
        want = list(want_dm.iter_split(split, rng()))
        assert len(got) == len(want) == (1 if split == "train" else 1)
        for g, w in zip(got, want):
            assert len(g) == len(w) == 7
            for name, a, b in zip(toformer.TIMEPRED_KEYS, g, w):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    x, y, nt_inp, nt_prop, in_pos, pr_pos, n_time = got[0]
    assert x.shape == (3, 1, N_HIST * X, 2 + add_t + 1) and y.shape == (3, 1, 8 * X, 2)
    assert nt_inp.shape == (3, N_HIST * X, 1) and pr_pos.shape == (3, 8 * X, 2)
    assert (n_time == T - N_HIST).all()
    # drop_last on train only, as in JAX: 6 items at batch 4 give one batch
    assert len(list(got_dm.iter_split("train", drop_last=False))) == 2
    # the tokenizer a caller without a datamodule uses (chip_smoke.py)
    store = th5.read_store(paths["test_path"])
    stats = {"input_mean": got_dm.input_mean, "input_std": got_dm.input_std,
             "target_mean": got_dm.target_mean, "target_std": got_dm.target_std}
    tok = toformer.tokenize_time_pred(store.inputs, store.targets, store.x, store.t, stats,
                                      N_HIST, add_t=add_t, flip_xy=flip_xy)
    for name, a in zip(toformer.TIMEPRED_KEYS, got[0]):
        np.testing.assert_allclose(tok[name], a, rtol=0, atol=1e-6, err_msg=name)


def hparams(input_channels=4, out_channels=2):
    return {
        "name": "oformer_t", "time_history": T,
        "encoder": {"input_channels": input_channels, "time_window": 1, "in_emb_dim": 32,
                    "out_channels": 32, "max_node_type": 2, "heads": 1, "depth": 4,
                    "res": X, "use_ln": True, "emb_dropout": 0.0, "relative_emb_dim": 2},
        "decoder": {"max_node_type": 2, "latent_channels": 32,
                    "out_channels": out_channels, "res": X, "scale": 2, "dropout": 0.1,
                    "relative_emb_dim": 2},
        "norm_shape": [], "loss": "mse", "lr": 1e-3, "weight_decay": 1e-4,
        "curriculum_steps": 8, "curriculum_ratio": 0.2,
    }


RECON_HP = hparams(3, 1)


def seeded(variables, seed):
    rs = np.random.RandomState(seed)

    def draw(path, a):
        a = np.asarray(a)
        if path[0].key == "constants":
            return a
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@functools.lru_cache(maxsize=None)
def _init_variables(recon: bool):
    """One JAX init (a jit compile) for each model; each test then draws its
    own parameters into it."""
    cls = jtasks.OformerTask if recon else jtasks.OformerTimePredTask
    hp = RECON_HP if recon else hparams()
    return cls(to_dotdict(hp))._init_variables(jax.random.PRNGKey(0))


def jax_state(jtask, stats, seed, recon=False):
    jtask._init_variables = lambda rng: _init_variables(recon)
    state = jtask.init_state(jax.random.PRNGKey(seed), stats)
    params = seeded(state.params, seed)
    return state.replace(params=params, opt_state=jtask.tx.init(params))


def first_batch(paths, cls, split="test"):
    dm = cls(**dm_kw(paths))
    return next(dm.iter_split(split)), dm.get_norm_stats()


def to_torch(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


def to_jax(batch):
    return tuple(map(jnp.asarray, batch))


def close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("corr"):
            assert abs(float(got[k]) - float(v)) <= 1e-5, k
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)


def test_time_pred_eval_matches_jax(paths):
    batch, stats = first_batch(paths, toformer.PlOformerSwpTimePredDatamodule)
    jtask = jtasks.OformerTimePredTask(to_dotdict(hparams()))
    jstate = jax_state(jtask, stats, 1)
    task = build_task(hparams(), "cpu", target=TIME_TARGET)
    state = task.init_state(None, stats, **jax_train_state_to_torch(jstate))
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", False)
    m_j, grid_j = jtask.eval_step(jstate, to_jax(batch), split="val")
    m_t, grid_t = task.eval_step(state, to_torch(batch), split="val")
    assert sorted(m_t) == sorted(f"val_{k}" for k in (
        "loss", "mae_u", "mae_u_un", "corr", "mae_u_scaled", "pde_loss", "pde_loss_gt"))
    assert_metrics(m_t, m_j)
    assert grid_t.shape == (3, T - N_HIST, X, 2)
    close(grid_t, grid_j, 1e-5, "grid prediction")
    # the per-state normalizers of the residual, and no PDE keys without them
    for name in ("normalizer_state1", "normalizer_state2"):
        got, want = getattr(task, name), getattr(jtask, name)
        np.testing.assert_array_equal(got.subtract.numpy(), np.asarray(want.subtract))
    bare = build_task(hparams(), "cpu", target=TIME_TARGET)
    m_bare, _ = bare.eval_step(bare.init_state(None, **jax_train_state_to_torch(jstate)),
                               to_torch(batch))
    assert not any("pde" in k for k in m_bare)


def jax_dropout_mask(jtask, jstate, batch, key):
    """The keep mask JAX's train_step draws from `key`: the model called
    eagerly with the same dropout rng, its nn.Dropout output read back."""
    import flax.linen as nn

    x, _, nt_inp, nt_prop, in_pos, pr_pos, _ = to_jax(batch)
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append(np.asarray(out))
        return out

    with nn.intercept_methods(capture):
        jtask.model.apply(jstate.params, x, nt_inp, nt_prop, in_pos, pr_pos, 1,
                          deterministic=False, rngs={"dropout": key})
    (dropped,) = seen
    return dropped != 0


def test_time_pred_train_steps_match_jax(paths):
    """Three steps on the one-cycle schedule (2 x 4 steps, so they cross its
    peak) with JAX's dropout masks: the trajectory's loss at each step, and
    each step taken alone from JAX's state before it, its loss, params and
    AdamW moments after it. (Along the trajectory the first encoder layers'
    moments drift apart by a few 1e-4 of their scale: their fp32 gradients
    are 2e-5 to 3e-5 of scale from float64's on both sides, as
    tests/test_torch_oformer_task.py explains.)"""
    kw = dict(steps_per_epoch=2, max_epochs=4)
    batch, stats = first_batch(paths, toformer.PlOformerSwpTimePredDatamodule, "train")
    jtask = jtasks.OformerTimePredTask(to_dotdict(hparams()), **kw)
    jstate = jax_state(jtask, stats, 2)
    task = build_task(hparams(), "cpu", target=TIME_TARGET, **kw)
    state = task.init_state(None, stats, **jax_train_state_to_torch(jstate))
    for step in range(STEPS):
        key = jax.random.PRNGKey(20 + step)
        keep = torch.from_numpy(jax_dropout_mask(jtask, jstate, batch, key))
        start = task.init_state(None, stats, **jax_train_state_to_torch(jstate))
        jstate, m_j = jtask.train_step(jstate, to_jax(batch), key)
        state, m_t = task.train_step(state, to_torch(batch), dropout_keep=keep)
        alone, m_alone = task.train_step(start, to_torch(batch), dropout_keep=keep)
        for m in (m_t, m_alone):
            np.testing.assert_allclose(float(m["train_loss"]), float(m_j["train_loss"]),
                                       rtol=1e-5, err_msg=f"step {step}")
        want = jax_train_state_to_torch(jstate)
        assert alone.step == state.step == want["step"] == step + 1
        for k, p in want["params"].items():
            close(alone.params[k], p, 1e-4, k)
            for mom, tol in (("mu", 1e-4), ("nu", 2e-4)):
                close(alone.opt_state[mom][k], want["opt_state"][mom][k], tol,
                      f"step {step} {mom} {k}")
    for k, p in want["params"].items():
        close(state.params[k], p, 1e-4, f"trajectory {k}")


def test_state_time_pred_test_step_matches_jax(paths):
    """Stage 1 on the reconstruction batch's history tokens, stage 2 on the
    time-prediction batch, from two converted states."""
    rbatch, rstats = first_batch(paths, toformer.PlOformerSwpDatamodule)
    tbatch, tstats = first_batch(paths, toformer.PlOformerSwpTimePredDatamodule)
    hp = {"hparams_state": RECON_HP, "hparams_time": hparams(), "time_history": N_HIST}
    jtask = jtasks.OformerStateTimePredTask(to_dotdict(hp))
    task = build_task(hp, "cpu", target=STATE_TIME_TARGET)
    assert isinstance(task, ttasks.OformerStateTimePredTask)
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", False)
    js = jax_state(jtask.model_state, rstats, 3, recon=True)
    jt = jax_state(jtask.model_time, tstats, 4)
    ts = task.model_state.init_state(None, rstats, **jax_train_state_to_torch(js))
    tt = task.model_time.init_state(None, tstats, **jax_train_state_to_torch(jt))
    m_j, pred_j = jtask.test_step(js, jt, to_jax(rbatch), to_jax(tbatch))
    m_t, pred_t = task.test_step(ts, tt, to_torch(rbatch), to_torch(tbatch))
    assert sorted(m_t) == ["test_mae_un", "test_mae_un_pred", "test_mae_un_rec"]
    assert_metrics(m_t, m_j)
    close(pred_t, pred_j, 1e-5, "prediction")


def test_linear_attention_sites_per_forward(paths):
    """Each forward runs K5 and K6 once per linear attention: the four
    encoder layers, the decoder's cross attention and mix layer. These are
    the per-eval counts chip_smoke.py asserts on the card (twice K5 and
    four times K6 per train step, through their VJPs)."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    calls = {"kv_dots": 0, "apply_dots": 0}

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    ops = dataclasses.replace(kernels.PLAIN_OPS,
                              kv_dots=counted("kv_dots", kernels.kv_dots_plain),
                              apply_dots=counted("apply_dots", kernels.apply_dots_plain))
    batch, stats = first_batch(paths, toformer.PlOformerSwpTimePredDatamodule)
    task = build_task(hparams(), "cpu", target=TIME_TARGET, ops=ops)
    task.eval_step(task.init_state(torch.Generator().manual_seed(0), stats), to_torch(batch))
    assert calls == {"kv_dots": chip_smoke.OFORMER_SITES,
                     "apply_dots": chip_smoke.OFORMER_SITES}
