"""The OFormer slice of the port end to end against the JAX OformerTask, on
the CPU: eval_step (the seven metrics and the grid prediction), three
train_steps from one converted state with the JAX dropout masks (loss, the
params and the AdamW state after them), the one-cycle schedule against
optax, the frozen constants, the tokenizer against the JAX datamodule's, the
conversion of a JAX train state, and the registry.

Both sides run fp32 from the same seeded non-zero parameters. Tolerances:
the metrics to rtol 1e-5 (the correlation, whose scale is 1 and whose value
is near 0, to 1e-5 absolute) and the prediction to 1e-5 of its scale; the
loss to 1e-5 relative; after three AdamW steps on the one-cycle schedule
(lr up to 1e-3), params and the first moment to 1e-4 of their scale and the
second moment to 2e-4: it holds squared gradients, whose relative error is
twice the gradients', and the gradients of the first encoder layers pass
through the whole model, so their fp32 rounding differs between the two
sides by a few 1e-5 of their scale. The schedule to rtol 1e-6 and 1e-6 of
its peak (fp32 cosine on both sides).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.data.oformer_data import PlOformerSwpDatamodule
from m_cedm_tpu.tasks.oformer import OformerTask as JaxOformerTask
from m_cedm_tpu_torch.convert import jax_train_state_to_torch
from m_cedm_tpu_torch.data.oformer_data import tokenize_grid
from m_cedm_tpu_torch.ops.schedules import cosine_onecycle
from m_cedm_tpu_torch.tasks import OFORMER_TARGET, OformerTask, build_task
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, X, STEPS = 2, 8, 8, 3
STATS = {"input_mean": 1.2, "input_std": 0.3, "target_mean": 0.1, "target_std": 0.4}


def hparams():
    return {
        "name": "oformer_t", "time_history": T,
        "encoder": {"input_channels": 3, "time_window": 1, "in_emb_dim": 32,
                    "out_channels": 32, "max_node_type": 2, "heads": 1,
                    "depth": 4, "res": X, "use_ln": True, "emb_dropout": 0.0,
                    "relative_emb_dim": 2},
        "decoder": {"max_node_type": 2, "latent_channels": 32,
                    "out_channels": 1, "res": X, "scale": 2, "dropout": 0.1,
                    "relative_emb_dim": 2},
        "norm_shape": [], "loss": "mse", "lr": 1e-3, "weight_decay": 1e-4,
        "curriculum_steps": 8, "curriculum_ratio": 0.2,
    }


def fields(seed, b=B):
    """Shallow-water-like (h, u) on a (T, X) grid, its coordinates, and the
    tokenized batch the OFormer datamodule makes of them."""
    rs = np.random.RandomState(seed)
    x = np.broadcast_to(np.linspace(-0.5, 0.5, X, dtype=np.float32), (b, X)).copy()
    t = np.broadcast_to(np.linspace(0, 0.128, T, dtype=np.float32), (b, T)).copy()
    h = (1.2 + 0.3 * np.sin(2 * np.pi * (x[:, None, :] - t[:, :, None]))
         + 0.05 * rs.randn(b, T, X)).astype(np.float32)[..., None]
    u = (0.1 + 0.4 * np.cos(2 * np.pi * x[:, None, :] + t[:, :, None])
         + 0.05 * rs.randn(b, T, X)).astype(np.float32)[..., None]
    return h, u, x, t


def token_batch(seed=0):
    tok = tokenize_grid(*fields(seed), STATS)
    return tuple(np.ascontiguousarray(tok[k]) for k in ("x", "y", "node_type", "pos", "n_time"))


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
def _init_variables():
    """One JAX init (a jit compile) for the whole file; each test then draws
    its own parameters into it."""
    return JaxOformerTask(to_dotdict(hparams()))._init_variables(jax.random.PRNGKey(0))


def jax_state(jtask, seed=0):
    jtask._init_variables = lambda rng: _init_variables()
    state = jtask.init_state(jax.random.PRNGKey(seed), STATS)
    params = seeded(state.params, seed)
    return state.replace(params=params, opt_state=jtask.tx.init(params))


def torch_batch(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def test_eval_step_matches_jax():
    jtask = JaxOformerTask(to_dotdict(hparams()))
    jtask.set_pde_loss_function("swe_per", False)
    jstate = jax_state(jtask)
    batch = token_batch(1)
    m_j, grid_j = jtask.eval_step(jstate, tuple(map(jnp.asarray, batch)), split="val")

    task = build_task(hparams(), "cpu", target=OFORMER_TARGET)
    task.set_pde_loss_function("swe_per", False)
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    m_t, grid_t = task.eval_step(state, torch_batch(batch), split="val")
    assert sorted(m_t) == sorted(m_j) == sorted(
        f"val_{k}" for k in ("loss", "mae_u", "mae_u_un", "corr", "mae_u_scaled",
                             "pde_loss", "pde_loss_gt"))
    for k in m_j:
        if k.endswith("corr"):
            assert abs(float(m_t[k]) - float(m_j[k])) <= 1e-5, k
        else:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    assert grid_t.shape == (B, T, X, 1)
    _close(grid_t.numpy(), grid_j, 1e-5, "grid prediction")
    np.testing.assert_array_equal(OformerTask.eval_target(batch),
                                  JaxOformerTask.eval_target(batch))


def jax_dropout_mask(jtask, jstate, batch, key):
    """The keep mask JAX's train_step draws from `key`: the model called
    eagerly with the same dropout rng, its nn.Dropout output read back."""
    import flax.linen as nn

    x, y, nt, pos, _ = map(jnp.asarray, batch)
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append(np.asarray(out))
        return out

    with nn.intercept_methods(capture):
        jtask.model.apply(jstate.params, x, nt, nt, pos, pos, 1, deterministic=False,
                          rngs={"dropout": key})
    (dropped,) = seen
    return dropped != 0


def test_train_steps_match_jax():
    """Three steps on the one-cycle schedule (2 x 4 steps: warm-up over
    counts 0-2, so the steps cross the peak) from one converted state."""
    kw = dict(steps_per_epoch=2, max_epochs=4)
    jtask = JaxOformerTask(to_dotdict(hparams()), **kw)
    jstate = jax_state(jtask, 2)
    task = build_task(hparams(), "cpu", target=OFORMER_TARGET, **kw)
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    b0 = state.constants["decoder.fourier_features.B"].clone()
    batch = token_batch(3)
    tbatch = torch_batch(batch)
    for step in range(STEPS):
        key = jax.random.PRNGKey(20 + step)
        keep = jax_dropout_mask(jtask, jstate, batch, key)
        jstate, m_j = jtask.train_step(jstate, tuple(map(jnp.asarray, batch)), key)
        state, m_t = task.train_step(state, tbatch, dropout_keep=torch.from_numpy(keep))
        np.testing.assert_allclose(float(m_t["train_loss"]), float(m_j["train_loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
        assert np.isfinite(float(m_t["grad_norm"]))

    want = jax_train_state_to_torch(jstate)
    assert state.step == want["step"] == STEPS
    assert int(state.opt_state["count"]) == int(want["opt_state"]["count"]) == STEPS
    assert sorted(state.params) == sorted(want["params"])
    for k, p in want["params"].items():
        _close(state.params[k].numpy(), p.numpy(), 1e-4, k)
        for mom, tol in (("mu", 1e-4), ("nu", 2e-4)):
            _close(state.opt_state[mom][k].numpy(), want["opt_state"][mom][k].numpy(),
                   tol, f"{mom} {k}")
    # the port's counterpart of test_constants_frozen
    assert torch.equal(state.constants["decoder.fourier_features.B"], b0)
    torch.testing.assert_close(want["constants"]["decoder.fourier_features.B"], b0,
                               rtol=0, atol=0)


def test_train_step_from_generator():
    """The entry point as a user calls it: fresh init, torch.Generator draws
    of the dropout mask, a constant lr; the input state is left as it was."""
    task = build_task(hparams(), "cpu", target=OFORMER_TARGET)
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = torch_batch(token_batch(4))
    new, metrics = task.train_step(state, batch, torch.Generator().manual_seed(1))
    again, _ = task.train_step(state, batch, torch.Generator().manual_seed(1))
    assert new.step == 1 and np.isfinite(float(metrics["train_loss"]))
    assert all(torch.equal(new.params[k], again.params[k]) for k in new.params)
    assert all(torch.equal(state.params[k], before[k]) for k in before)
    moved = max(float((new.params[k] - before[k]).abs().max()) for k in before)
    assert 0 < moved <= 1.5e-3  # Adam moves an entry by about lr = 1e-3
    assert not any(k.endswith(".B") for k in new.params)


@pytest.mark.parametrize("total", [8, 100, 7000])
def test_cosine_onecycle_matches_optax(total):
    peak = 1e-3
    ours = cosine_onecycle(total, peak, pct_start=0.3, div_factor=1e4, final_div_factor=1e4)
    ref = optax.cosine_onecycle_schedule(total, peak, pct_start=0.3, div_factor=1e4,
                                         final_div_factor=1e4)
    warm = int(0.3 * total)
    for count in sorted({0, 1, warm // 2, warm, warm + 1, (warm + total) // 2,
                         total - 1, total, total + 5}):
        got = float(ours(torch.tensor(count, dtype=torch.int32)))
        # near the end cos(pi pct) + 1 cancels: an ulp of the cosine is a
        # relative 1e-4 there, so the bound is 1e-6 of the peak
        np.testing.assert_allclose(got, float(ref(jnp.int32(count))), rtol=1e-6,
                                   atol=1e-6 * peak, err_msg=f"count {count}")
    assert float(ours(warm)) == pytest.approx(peak, rel=1e-6)


def test_curriculum_and_schedule_choice_match_jax():
    for kw in ({}, {"steps_per_epoch": 2, "max_epochs": 4},
               {"steps_per_epoch": 1, "max_epochs": 3}, {"steps_per_epoch": 50, "max_epochs": 4}):
        jtask = JaxOformerTask(to_dotdict(hparams()), **kw)
        task = OformerTask(hparams(), "cpu", **kw)
        jax_sched = type(jtask.tx.init({"a": jnp.zeros(1)})[1][-1]).__name__
        assert callable(task.tx.lr) == (jax_sched == "ScaleByScheduleState"), kw
        assert task.total_steps == jtask.total_steps
        for fs in (1, 4, 16):
            for step in range(0, 60, 7):
                assert (task._curriculum_forward_steps(step, fs)
                        == jtask._curriculum_forward_steps(step, fs)), (kw, fs, step)
    assert not callable(OformerTask(hparams(), "cpu", steps_per_epoch=1,
                                    max_epochs=3).tx.lr)  # a warm-up of 0 steps


def test_tokenize_grid_matches_jax_datamodule():
    h, u, x, t = fields(5, b=3)
    dm = PlOformerSwpDatamodule.__new__(PlOformerSwpDatamodule)
    dm.norm_input = dm.norm_target = dm.norm_x = dm.norm_t = dm.add_t = True
    dm.flip_xy = False
    dm.input_mean, dm.input_std = np.float32(1.1), np.float32(0.2)
    dm.target_mean, dm.target_std = np.float32(0.05), np.float32(0.5)

    class Store:
        inputs, targets = h, u
    Store.x, Store.t = x * 3 + 1, t * 2 + 0.5
    want = dm._materialize(Store, 1)
    stats = {"input_mean": dm.input_mean, "input_std": dm.input_std,
             "target_mean": dm.target_mean, "target_std": dm.target_std}
    got = tokenize_grid(h, u, Store.x, Store.t, stats)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["x"].shape == (3, 1, T * X, 3)


def test_jax_train_state_round_trip():
    """A JAX OFormer state one step in (AdamW chain, schedule count 1): every
    leaf reaches the port's state unchanged, and nothing else does."""
    jtask = JaxOformerTask(to_dotdict(hparams()), steps_per_epoch=2, max_epochs=4)
    jstate = jax_state(jtask, 6)
    grads = seeded(jstate.params, 7)  # any gradient tree moves the chain's state
    updates, opt_state = jax.jit(jtask.tx.update)(grads, jstate.opt_state, jstate.params)
    jstate = jstate.replace(params=optax.apply_updates(jstate.params, updates),
                            opt_state=opt_state, step=jstate.step + 1)
    task = build_task(hparams(), "cpu", target=OFORMER_TARGET)
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    names = dict(task.model.named_parameters())
    assert sorted(state.params) == sorted(names)
    assert sorted(state.constants) == ["decoder.fourier_features.B"]
    for coll, tree in (("params", jstate.params["params"]),
                       ("mu", jstate.opt_state[1][0].mu["params"]),
                       ("nu", jstate.opt_state[1][0].nu["params"])):
        got = state.params if coll == "params" else state.opt_state[coll]
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path]
            name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}
                                         .get(keys[-1], keys[-1])])
            leaf = np.asarray(leaf)
            want = leaf.T if keys[-1] == "kernel" else leaf
            np.testing.assert_array_equal(got[name].numpy(), want, err_msg=f"{coll} {name}")
            assert got[name].shape == names[name].shape
    np.testing.assert_array_equal(state.constants["decoder.fourier_features.B"].numpy(),
                                  np.asarray(jstate.params["constants"]["decoder"]
                                             ["fourier_features"]["B"]))
    assert state.step == 1 and int(state.opt_state["count"]) == 1
    assert int(jstate.opt_state[1][-1].count) == 1  # the schedule's own count


def test_registry_and_unported_options():
    target = yaml.safe_load(open(os.path.join(REPO, "configs/model/oformer_t.yaml")))
    assert target["_target_"] == OFORMER_TARGET
    for name in (OFORMER_TARGET, "models.oformer.PlOformer"):
        task = build_task(target["hparams"], "cpu", target=name, grad_clip=2.0)
        assert isinstance(task, OformerTask) and task.tx.grad_clip == 2.0
    assert task.enc_cfg.in_emb_dim == 128 and task.enc_cfg.depth == 4
    assert task.tx.name == "AdamW" and task.tx.weight_decay == 1e-4
    hp = hparams()
    hp["dtype"] = "bfloat16"  # served and trained in bf16 (test_torch_oformer_bf16.py)
    assert build_task(hp, "cpu", target=OFORMER_TARGET).compute_dtype == torch.bfloat16
    assert task.compute_dtype is None
    hp = hparams()
    hp["encoder"]["emb_dropout"] = 0.1
    task = build_task(hp, "cpu", target=OFORMER_TARGET)
    state = task.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task.train_step(state, torch_batch(token_batch()), torch.Generator())


def test_chip_smoke_hparams_equal_oformer_yaml():
    import sys

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs/model/oformer_t.yaml")) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.OFORMER_HPARAMS == want["hparams"]
    assert chip_smoke.OFORMER_TARGET == want["_target_"] == OFORMER_TARGET
