"""The port's FNO tasks against the JAX package's, on the CPU, from one
converted state: FnoStateReconstrTask, FnoTimePredTask and Fno2dTask (eval
metrics, three train steps), FnoStateTimePredTask.test_step under both
flip_xy, the StepLR schedule, the PDE residual's setter, the conversion of
a JAX train state and the registry.

Both sides run fp32 (TF32 off) from the same seeded non-zero parameters at
width 16, 2 layers, modes 4 on a 32 x 32 grid, JAX on its truncated-DFT
route (MCEDM_FNO_DFT=1 set in every case; the port takes that route by
shape). Tolerances: eval metrics to rtol 1e-5 (the correlation, near 0 on
a scale of 1, to 1e-5 absolute); the loss of each train step to
rtol 1e-5; after three Adam steps with lr 1e-3 (steps_per_epoch 1 and
step_size 1, so StepLR decays inside them) the params and both Adam
moments to 1e-4 of their scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import fno as jtasks
from m_cedm_tpu_torch.convert import jax_train_state_to_torch
from m_cedm_tpu_torch.tasks import build_task
from m_cedm_tpu_torch.tasks import fno as ttasks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, T, X, STEPS = 2, 32, 32, 3
STATS = {"input_mean": 1.1, "input_std": 0.3, "target_mean": 0.1, "target_std": 0.4}
TARGETS = {"reconstr": "m_cedm_tpu.tasks.FnoStateReconstrTask",
           "time": "m_cedm_tpu.tasks.FnoTimePredTask",
           "state_time": "m_cedm_tpu.tasks.FnoStateTimePredTask",
           "fno2d": "m_cedm_tpu.tasks.Fno2dTask"}
JAX_CLASSES = {"reconstr": jtasks.FnoStateReconstrTask, "time": jtasks.FnoTimePredTask,
               "fno2d": jtasks.Fno2dTask}


@pytest.fixture(autouse=True)
def jax_dft_route(monkeypatch):
    monkeypatch.setenv("MCEDM_FNO_DFT", "1")


def hparams(kind="reconstr", **kw):
    hp = {"name": "fno_state_reconstr_2d", "modes_1": 4, "modes_2": 4, "width": 16,
          "num_layers": 2, "padding_t": 4, "padding_x": 0, "time_history": 16,
          "time_future": 0, "input_size": 1, "state_size": 1, "factor": 0.3,
          "step_size": 1, "loss": "l1", "lr": 1e-3, "weight_decay": 0}
    if kind == "time":
        hp.update(input_size=2, state_size=2)
    if kind == "fno2d":
        hp.update(time_history=4, time_future=4, teacher_forcing=True)
    hp.update(kw)
    return hp


def seeded(params, seed):
    rs = np.random.RandomState(seed)

    def draw(path, a):
        a = np.asarray(a)
        if path[-1].key.startswith("w"):  # spectral (in, out, m1, m2)
            return (rs.randn(*a.shape) / a.shape[0]).astype(np.float32)
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def pair(kind, seed, hp=None, stats=STATS, **kw):
    """The JAX task and state with seeded params, and the port's task and
    the same state converted."""
    hp = hp or hparams(kind)
    jtask = JAX_CLASSES[kind](to_dotdict(hp), **kw)
    jstate = jtask.init_state(jax.random.PRNGKey(0), stats)
    params = seeded(jstate.params, seed)
    jstate = jstate.replace(params=params, opt_state=jtask.tx.init(params))
    task = build_task(hp, "cpu", target=TARGETS[kind], **kw)
    state = task.init_state(None, stats, **jax_train_state_to_torch(jstate))
    return jtask, jstate, task, state


def swe_fields(seed, b=B, t=T, x=X):
    """Shallow-water-like h (observed) and u (hidden) on a (t, x) grid."""
    rs = np.random.RandomState(seed)
    xs = np.linspace(-0.5, 0.5, x, dtype=np.float32)
    ts = np.linspace(0, 0.128, t, dtype=np.float32)
    h = (1.1 + 0.3 * np.sin(2 * np.pi * (xs[None, :] - ts[:, None]))[None]
         + 0.05 * rs.randn(b, t, x)).astype(np.float32)[..., None]
    u = (0.1 + 0.4 * np.cos(2 * np.pi * xs[None, :] + ts[:, None])[None]
         + 0.05 * rs.randn(b, t, x)).astype(np.float32)[..., None]
    h = (h - STATS["input_mean"]) / STATS["input_std"]  # normalized in the loader
    u = (u - STATS["target_mean"]) / STATS["target_std"]
    return h, u, np.tile(xs, (b, 1)), np.tile(ts, (b, 1))


def batch_of(seed, spacings=False):
    h, u, xs, ts = swe_fields(seed)
    if spacings:
        xs, ts = xs[:, 1] - xs[:, 0], ts[:, 1] - ts[:, 0]
    return h, xs, ts, u


def fno2d_batch(seed):
    rs = np.random.RandomState(seed)
    u = (0.5 * rs.randn(B, X, X, 12)).astype(np.float32)
    return (u,) + tuple((0.1 + rs.rand(B)).astype(np.float32) for _ in range(3))


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


def assert_states(state, jstate):
    want = jax_train_state_to_torch(jstate)
    assert state.step == want["step"] and int(state.opt_state["count"]) == want["step"]
    assert sorted(state.params) == sorted(want["params"])
    for k, p in want["params"].items():
        close(state.params[k], p, 1e-4, k)
        for mom in ("mu", "nu"):
            close(state.opt_state[mom][k], want["opt_state"][mom][k], 1e-4, f"{mom} {k}")


def run_steps(jtask, jstate, task, state, batch):
    for step in range(STEPS):
        key = jax.random.PRNGKey(step)
        jstate, m_j = jtask.train_step(jstate, to_jax(batch), key)
        state, m_t = task.train_step(state, to_torch(batch))
        assert sorted(set(m_t) - {"grad_norm"}) == sorted(m_j)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {step} {k}")
        assert np.isfinite(float(m_t["grad_norm"]))
    assert_states(state, jstate)


@pytest.mark.parametrize("split", ["val", "test"])
def test_reconstr_eval_matches_jax(split):
    """val on gridded coordinates; test with down_factor 2 and (B,)
    spacings, which the model takes as its coordinate channels."""
    jtask, jstate, task, state = pair("reconstr", 1)
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", False)
        t.down_factor = 2
    batch = batch_of(2, spacings=split == "test")
    m_j, pred_j = jtask.eval_step(jstate, to_jax(batch), split=split)
    m_t, pred_t = task.eval_step(state, to_torch(batch), split=split)
    assert sorted(m_t) == sorted(f"{split}_{k}" for k in (
        "loss", "mae_u", "mae_u_un", "corr", "mae_u_scaled", "pde_loss", "pde_loss_gt"))
    assert_metrics(m_t, m_j)
    assert pred_t.shape == (B, 16, X, 1)
    close(pred_t, pred_j, 1e-5, "prediction")


@pytest.mark.parametrize("loss,clip,decay", [
    ("l1", None, 0.0), ("l2", 1e-3, 1e-2), ("mse", None, 0.0),
    ("smooth_l1", None, 0.0), ("lp", None, 0.0)])
def test_reconstr_train_steps_match_jax(loss, clip, decay):
    """Each criterion; l2 with weight decay and a global-norm clip below the
    gradient norm, so both act in every step."""
    hp = hparams("reconstr", loss=loss, weight_decay=decay)
    jtask, jstate, task, state = pair("reconstr", 3, hp, grad_clip=clip,
                                      steps_per_epoch=1)
    assert task.tx.grad_clip == clip and task.tx.weight_decay == decay
    run_steps(jtask, jstate, task, state, batch_of(4))


def test_time_pred_matches_jax():
    """Predict steps 16..31 of [h, u] from the first 16: the eval (metrics,
    [history | prediction] unnormalized) and three train steps."""
    jtask, jstate, task, state = pair("time", 5, hparams("time", loss="l2"),
                                      steps_per_epoch=1)
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", False)
    assert task.pde_loss.Tn == jtask.pde_loss.Tn == pytest.approx(0.128)  # no Tn_mult
    batch = batch_of(6)
    m_j, pred_j = jtask.eval_step(jstate, to_jax(batch), split="val")
    m_t, pred_t = task.eval_step(state, to_torch(batch), split="val")
    assert_metrics(m_t, m_j)
    assert pred_t.shape == (B, T, X, 2)
    close(pred_t, pred_j, 1e-5, "prediction")
    run_steps(jtask, jstate, task, state, batch)


@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_fno2d_matches_jax(teacher_forcing):
    """Two chunks of four frames after the first four (a teacher-forced
    chunk's input is the last chunk's target, so time_history equals
    time_future, as in the JAX package): three train steps (teacher
    forced or free running) and the free-running eval, whose keys are val_*
    at any split, as in the JAX package."""
    hp = hparams("fno2d", teacher_forcing=teacher_forcing, loss="smooth_l1")
    jtask, jstate, task, state = pair("fno2d", 7, hp, steps_per_epoch=1)
    batch = fno2d_batch(8)
    m_j, pred_j = jtask.eval_step(jstate, to_jax(batch))
    m_t, pred_t = task.eval_step(state, to_torch(batch), split="test")
    assert sorted(m_t) == ["val_loss", "val_mae_loss"]
    assert_metrics(m_t, m_j)
    close(pred_t, pred_j, 1e-5, "rollout")
    run_steps(jtask, jstate, task, state, batch)


@pytest.mark.parametrize("flip_xy", [False, True])
def test_state_time_pred_test_step_matches_jax(flip_xy):
    """flip_xy swaps the fields' roles and statistics, as the datamodule
    does: u observed, h reconstructed."""
    hp = {"hparams_state": hparams("reconstr"), "hparams_time": hparams("time"),
          "time_history": 16}
    jtask = jtasks.FnoStateTimePredTask(to_dotdict(hp))
    task = build_task(hp, "cpu", target=TARGETS["state_time"])
    assert isinstance(task, ttasks.FnoStateTimePredTask)
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", flip_xy)
    stats, batch = STATS, batch_of(11)
    if flip_xy:
        stats = {"input_mean": STATS["target_mean"], "input_std": STATS["target_std"],
                 "target_mean": STATS["input_mean"], "target_std": STATS["input_std"]}
        batch = (batch[3], batch[1], batch[2], batch[0])
    _, js, _, ts = pair("reconstr", 9, stats=stats)
    _, jt, _, tt = pair("time", 10, stats=stats)
    m_j, pred_j = jtask.test_step(js, jt, to_jax(batch))
    m_t, pred_t = task.test_step(ts, tt, to_torch(batch))
    assert sorted(m_t) == sorted(f"test_{k}" for k in (
        "mae_un_rec", "mae_un_pred", "mae_un", "pde_loss", "pde_loss_gt"))
    assert_metrics(m_t, m_j)
    close(pred_t, pred_j, 1e-5, "prediction")


def test_pde_loss_setter_and_schedule():
    """set_pde_loss_function at time_history 64 scales the residual's
    horizon by 64 / 128 for the reconstruction, as JAX's; StepLR as a
    function of the count, and the constant lr without steps_per_epoch."""
    for kind in ("reconstr", "time"):
        hp = hparams(kind, time_history=64)
        jtask = JAX_CLASSES[kind](to_dotdict(hp))
        task = build_task(hp, "cpu", target=TARGETS[kind])
        for t in (jtask, task):
            t.set_pde_loss_function("swe_per", True)
        want = {f.name: getattr(jtask.pde_loss, f.name)
                for f in dataclasses.fields(jtask.pde_loss)}
        got = {k: getattr(task.pde_loss, k) for k in want}
        assert got == pytest.approx(want), kind
    assert task.pde_loss.Tn == pytest.approx(0.128)
    task = build_task(hparams(step_size=3, factor=0.5), "cpu", target=TARGETS["reconstr"],
                      steps_per_epoch=4)
    for count in range(30):
        want = 1e-3 * 0.5 ** ((count // 4) // 3)
        got = float(task.tx.lr(torch.tensor(count, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6), count
    assert build_task(hparams(), "cpu", target=TARGETS["reconstr"]).tx.lr == 1e-3


def test_jax_train_state_round_trip():
    """A JAX FNO state one step in (clip, decayed weights, Adam, StepLR):
    every leaf reaches the port's state unchanged; no EMA, no constants."""
    hp = hparams(weight_decay=1e-4)
    jtask, jstate, task, _ = pair("reconstr", 12, hp, grad_clip=0.5, steps_per_epoch=2)
    jstate, _ = jtask.train_step(jstate, to_jax(batch_of(13)), jax.random.PRNGKey(0))
    got = jax_train_state_to_torch(jstate)
    assert got["ema_params"] is None and "constants" not in got and got["step"] == 1
    names = dict(task.model.named_parameters())
    assert sorted(got["params"]) == sorted(names)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate.params["params"])[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])
        leaf = np.asarray(leaf)
        want = leaf.T if leaf.ndim == 2 else leaf.reshape(names[name].shape)
        np.testing.assert_array_equal(got["params"][name].numpy(), want, err_msg=name)
    state = task.init_state(None, STATS, **got)
    assert state.step == 1 and state.ema_params is None and state.constants is None
    with pytest.raises(ValueError, match="EMA"):
        task.init_state(None, params=got["params"], ema_params=got["params"])


def test_registry():
    for kind, target in TARGETS.items():
        hp = ({"hparams_state": hparams(), "hparams_time": hparams("time")}
              if kind == "state_time" else hparams(kind))
        alias = {"reconstr": "models.fno_state_2d.PlFnoStateReconstr2d",
                 "time": "models.fno_state_2d.PlFnoTimePred2d",
                 "state_time": "models.fno_state_2d.PlFnoStateTimePred2d",
                 "fno2d": "models.fno_2d.PlFno2d"}[kind]
        for name in (target, alias):
            assert type(build_task(hp, "cpu", target=name)).__name__ == target.split(".")[-1]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_task(hparams(dtype="bfloat16"), "cpu", target=TARGETS["reconstr"])


def test_chip_smoke_hparams_equal_fno_yaml():
    import os
    import sys

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    with open(os.path.join(repo, "configs/model/fnostatereconstr2d.yaml")) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.FNO_HPARAMS == want["hparams"]
    assert chip_smoke.FNO_TARGET == want["_target_"] == TARGETS["reconstr"]
