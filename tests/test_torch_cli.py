"""The port's orchestration against the JAX package's: the task setters the
loop calls, the chunked test ensemble, checkpoints, and the CLI
(`m_cedm_tpu_torch.run` / `.eval_model`) on the CPU with `--device cpu`, on
res-16 h5 fixtures written by m_cedm_tpu.data.synthetic.

Tolerances: eval metrics against JAX's eval_step to rtol 1e-5 (as in
test_torch_task.py); the chunked ensemble against the member-by-member loop
to rtol 1e-6 (the same draws, only the batch the U-Net sees differs);
eval_model's test metrics against the run's own to rtol 1e-6 (same
checkpoint, same seeds). The mean sample of the chunked ensemble against
JAX's and against the member loop to 1e-5 of its scale, as
test_torch_task.py holds it.
"""
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu.tasks.base import TrainState, normalizers_from_stats
from m_cedm_tpu.train import checkpoint as jcheckpoint
from m_cedm_tpu_torch import eval_model, run
from m_cedm_tpu_torch.convert import jax_params_to_state_dict, jax_train_state_to_torch
from m_cedm_tpu_torch.data.masks import eval_masks_var
from m_cedm_tpu_torch.tasks import base as tbase
from m_cedm_tpu_torch.tasks import build_task
from m_cedm_tpu_torch.tasks import diffusion as tdiffusion
from m_cedm_tpu_torch.train.checkpoint import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
RES, B, STEPS = 16, 1, 3
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1,
         "target_std": 0.3}
FLAGSHIP = "--config-name=config_adm_edm_mcedm_res32.yaml"
TINY = [
    "system=swe_per",
    "datamodule.batch_size=4",
    "model.hparams.model.resolution=16",
    "model.hparams.model.ch=16",
    "model.hparams.model.attn_resolutions=[8]",
    "model.hparams.model.ch_mult=[1,1]",
    "diff_sampler.timesteps=4",
    "diff_sampler.n_samples=1",
]
OFORMER_TINY = [
    "system=swe_per",
    "trainer.max_epochs=1",
    "datamodule.batch_size=4",
    "model.hparams.time_history=16",
    "model.hparams.encoder.res=16",
    "model.hparams.decoder.res=16",
    "model.hparams.encoder.in_emb_dim=16",
    "model.hparams.encoder.out_channels=16",
    "model.hparams.encoder.depth=1",
    "model.hparams.decoder.latent_channels=16",
    "model.hparams.curriculum_steps=2",
]
# the DDPM U-Net's norms take 32 groups, so its configs run at ch 32
DDPM_TINY = [o if o != "model.hparams.model.ch=16" else "model.hparams.model.ch=32"
             for o in TINY]
# the FNO at tiny width on the res-16 fixtures, as tests/test_cli.py runs it
FNO_TINY = [
    "system=swe_per",
    "datamodule.batch_size=4",
    "model.hparams.width=8",
    "model.hparams.num_layers=2",
    "model.hparams.modes_1=4",
    "model.hparams.modes_2=4",
    "model.hparams.time_history=16",
]
FNO_CONFIG = "--config-name=config_fnostatereconstrabs2d.yaml"


def tiny(config):
    if "fno" in config:
        return FNO_TINY
    return DDPM_TINY if "ddim" in config or config.startswith("config_edm") else TINY


def hparams():
    return {
        "name": "adm_edm_mcedm",
        "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True,
                  "out_ch": 2, "ch": 16, "ch_mult": [1],
                  "num_res_blocks": 1, "attn_resolutions": [16],
                  "dropout": 0.0, "resolution": RES, "ema": True, "cond_p": 1.0},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": "Adam", "lr": 2e-4},
        "sampler": {"timesteps": STEPS, "sigma_min": 0.002, "sigma_max": 80,
                    "rho": 7, "S_churn": 15.0, "S_min": 0, "S_max": "inf",
                    "S_noise": 1, "w": 0.0, "guide_dx": False},
    }


def swe_batch(seed, b=B, res=RES):
    rs = np.random.RandomState(seed)
    h = (rs.randn(b, res, res, 1) * 0.1 + 4.0).astype(np.float32)
    u = (rs.randn(b, res, res, 1) * 0.2).astype(np.float32)
    tg = np.broadcast_to(np.linspace(0, 1, res)[None, :, None, None], h.shape)
    xg = np.broadcast_to(np.linspace(0, 1, res)[None, None, :, None], h.shape)
    return h, tg.astype(np.float32), xg.astype(np.float32), u


def seeded(params, seed):
    """Seeded non-zero values in the shape of a parameter tree (of arrays or
    of shapes)."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if len(a.shape) > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_state(jtask, seed):
    """A JAX TrainState with seeded params, built from the parameter shapes
    (tracing the U-Net's init, not running it)."""
    cfg = jtask.model_cfg
    x0 = jnp.zeros((1, RES, RES, cfg.in_channels), jnp.float32)
    cond0 = jnp.zeros((1, RES, RES, cfg.cond_channels), jnp.float32)
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), x0, jnp.ones((1,), jnp.float32), cond0))
    params = seeded(shapes, seed)
    n_in, n_tar = normalizers_from_stats(STATS, "gauss")
    return TrainState(params=params, ema_params=params,
                      opt_state=jtask.tx.init(params),
                      step=jnp.zeros((), jnp.int32), normalizer_input=n_in,
                      normalizer_target=n_tar)


def jax_eval_draws(key, shape, n_samples, n_steps):
    """The JAX eval's cond noise and every ensemble member's init and churn
    draws (chunked_ensemble splits one key per member, in member order)."""
    k_cond, k_sample = jax.random.split(key)
    inits, churns = [], []
    for k in jax.random.split(k_sample, n_samples):
        k_init, k_loop = jax.random.split(k)
        inits.append(np.array(jax.random.normal(k_init, shape, jnp.float32)))
        churns.append(np.stack([
            np.array(jax.random.normal(jax.random.split(kk)[0], shape, jnp.float32))
            for kk in jax.random.split(k_loop, n_steps)]))
    return (torch.from_numpy(np.array(jax.random.normal(k_cond, shape))),
            torch.from_numpy(np.stack(inits)), torch.from_numpy(np.stack(churns)))


@pytest.fixture(scope="module")
def tasks():
    """The JAX task (seeded non-zero params) and the port's with the same
    params, both with the swe_per PDE residual."""
    hp = hparams()
    jtask = JaxMcedmTask(to_dotdict(hp))
    jstate = jax_state(jtask, 0)
    task = build_task(hp, "cpu")
    state = task.init_state(None, STATS,
                            params=jax_params_to_state_dict(jstate.params))
    for t in (jtask, task):
        t.set_pde_loss_function("swe_per", False)
    return jtask, jstate, task, state


def port_eval(task, state, batch, mask, draws, n_samples):
    cond, init, churn = draws
    return task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                          torch.from_numpy(mask), split="test", mask_name="u",
                          n_samples=n_samples, cond_noise=cond,
                          init_noise=init, churn_noise=churn)


@pytest.mark.parametrize("n_samples", [5, 8])
def test_chunked_ensemble_matches_jax_and_the_member_loop(tasks, n_samples,
                                                          monkeypatch):
    """n 5 folds all members into one sampler call, n 8 two calls of 4; each
    member keeps its own draws, so the metrics equal a loop over members and
    JAX's eval_step with its PDE metrics under swe_per."""
    jtask, jstate, task, state = tasks
    batch = swe_batch(1)
    mask = eval_masks_var(RES, RES)["u"]
    key = jax.random.PRNGKey(3)
    m_j, hu_j = jtask.eval_step(jstate, tuple(map(jnp.asarray, batch)), key,
                                jnp.asarray(mask), split="test", mask_name="u",
                                n_samples=n_samples)
    draws = jax_eval_draws(key, (B, RES, RES, 2), n_samples, STEPS)

    task.model.calls = 0
    m_t, hu_t = port_eval(task, state, batch, mask, draws, n_samples)
    chunks = len(tbase.ensemble_chunks(n_samples))
    assert chunks == (1 if n_samples == 5 else 2)
    assert task.model.calls == chunks * (2 * STEPS - 1)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    hu_j = np.asarray(hu_j)
    assert np.abs(hu_t.numpy() - hu_j).max() <= 1e-5 * np.abs(hu_j).max()

    monkeypatch.setattr(tdiffusion, "ensemble",
                        functools.partial(tbase.ensemble, chunk=1))
    task.model.calls = 0
    m_s, hu_s = port_eval(task, state, batch, mask, draws, n_samples)
    assert task.model.calls == n_samples * (2 * STEPS - 1)
    for k in m_s:
        np.testing.assert_allclose(float(m_t[k]), float(m_s[k]), rtol=1e-6, err_msg=k)
    # the mean sample, as in test_torch_task.py: the state passes sigma 80, so
    # a last-ulp difference of the U-Net at another batch moves it by ~1e-5
    torch.testing.assert_close(hu_t, hu_s, rtol=0, atol=1e-5 * float(hu_s.abs().max()))


@pytest.mark.parametrize("flip_xy", [False, True])
def test_set_pde_loss_function_matches_jax(tasks, flip_xy):
    """The repaired fault: the PDE residual follows the data's system (swe_per:
    Tn 0.128 on [-0.5, 0.5]) and flip_xy; before the setter existed the port
    kept swe's."""
    jtask, jstate, task, state = tasks
    x = np.stack(swe_batch(2, b=2)[::3], axis=-1)[..., 0, :]
    x = (x - np.array([4.0, 0.1], np.float32)) / np.array([0.1, 0.3], np.float32)
    try:
        for t in (jtask, task):
            t.set_pde_loss_function("swe_per", flip_xy)
        got = task._pde_matrix_joint(state, torch.from_numpy(x), clamp_loss=False)
        want = jax.jit(functools.partial(jtask._pde_matrix_joint, clamp_loss=False))(
            jstate, jnp.asarray(x))
        np.testing.assert_allclose(float(got.sum()), float(want.sum()), rtol=1e-5)
        task.set_pde_loss_function("swe", flip_xy)
        before = task._pde_matrix_joint(state, torch.from_numpy(x), clamp_loss=False)
        assert abs(float(before.sum()) - float(want.sum())) > 1e-3 * abs(float(want.sum()))
    finally:
        for t in (jtask, task):
            t.set_pde_loss_function("swe_per", False)


def test_set_train_mask_kind():
    task = build_task(hparams(), "cpu")
    assert task.train_mask_kind == "var"
    task.set_train_mask_kind(None)
    assert task.train_mask_kind == "var"
    task.set_train_mask_kind("sparse")
    assert task.train_mask_kind == "sparse" and task.val_every == 100
    assert task.down_factor == 1


def _jax_state_with_optimizer(jtask, jstate):
    """A JAX TrainState with a non-trivial Adam state and step."""
    rs = np.random.RandomState(5)

    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return jnp.asarray(np.full(a.shape, 7, a.dtype))
        return jnp.asarray(rs.randn(*a.shape).astype(a.dtype))

    return jstate.replace(opt_state=jax.tree_util.tree_map(fill, jstate.opt_state),
                          step=jnp.asarray(7, jnp.int32),
                          ema_params=seeded(jstate.params, 9))


def test_checkpoint_round_trip_of_a_converted_jax_state(tasks, tmp_path):
    jtask, jstate, task, _ = tasks
    kw = jax_train_state_to_torch(_jax_state_with_optimizer(jtask, jstate))
    state = task.init_state(None, STATS, **kw)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    assert mgr.latest_step() is None and mgr.restore(state) is None
    mgr.save(state.step, state)
    assert mgr.latest_step() == 7
    target = task.init_state(torch.Generator().manual_seed(1), {
        k: v + 1.0 for k, v in STATS.items()})
    got = mgr.restore(target)
    assert got.step == 7 and int(got.opt_state["count"]) == 7
    for name in ("params", "ema_params"):
        for k, v in getattr(state, name).items():
            assert torch.equal(getattr(got, name)[k], v), (name, k)
    for name in ("mu", "nu"):
        for k, v in state.opt_state[name].items():
            assert torch.equal(got.opt_state[name][k], v), (name, k)
    assert got.opt_state["count"].dtype == torch.int32
    for n in ("normalizer_input", "normalizer_target"):
        assert torch.equal(getattr(got, n).subtract, getattr(state, n).subtract)
        assert torch.equal(getattr(got, n).divide, getattr(state, n).divide)


def test_checkpoint_keeps_the_newest_and_tracks_the_best_as_jax(tmp_path):
    values = [0.5, 0.3, 0.4, 0.2, 0.6]
    state = build_task(hparams(), "cpu").init_state(torch.Generator().manual_seed(0))
    for mode in ("min", "max"):
        got = CheckpointManager(str(tmp_path / f"t_{mode}"), monitor="val_mae_u",
                                mode=mode, save_top_k=1)
        want = jcheckpoint.CheckpointManager(str(tmp_path / f"j_{mode}"),
                                             monitor="val_mae_u", mode=mode,
                                             save_top_k=1)
        for step, v in enumerate(values, 1):
            got.save(step, state, {"val_mae_u": v})
            want.save(step, {"w": np.zeros(2, np.float32)}, {"val_mae_u": v})
        want.wait_until_finished()
        assert (got.best_step, got.best_value) == (want.best_step, want.best_value)
        assert got.all_steps() == sorted(want._mgr.all_steps()) == [4, 5]
        want.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """Synthetic res-16 data at the reference path layout (the path router
    takes the *_128_per names for training)."""
    from m_cedm_tpu.data.synthetic import write_swe_dataset

    root = tmp_path_factory.mktemp("dataroot")
    sub = root / "1D_swp_128_per"
    sub.mkdir()
    write_swe_dataset(str(sub / "1D_swp_128_per_train.h5"),
                      jax.random.PRNGKey(0), 8, 16, 16)
    write_swe_dataset(str(sub / "1D_swp_128_per_test.h5"),
                      jax.random.PRNGKey(1), 4, 16, 16, seed_offset=1000)
    return str(root)


def chip_smoke():
    """chip_smoke.py as a module: it holds the flagship's metric keys, which
    phase 12 checks on the card."""
    import sys

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def records(run_dir):
    return [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]


@pytest.fixture(scope="module")
def flagship_run(dataroot, tmp_path_factory):
    """One epoch of the flagship through run.main with the configured
    callbacks (the loop hands them its outputs; they draw no sample, which
    test_callbacks_match_jax covers), into a run directory of the default
    layout."""
    cwd = os.getcwd()
    work = tmp_path_factory.mktemp("work")
    os.chdir(work)
    try:
        metric = run.main(["--device", "cpu", FLAGSHIP, f"dataroot={dataroot}",
                           "trainer.max_epochs=1",
                           "callbacks.plotting.num_samples=0"] + TINY)
    finally:
        os.chdir(cwd)
    (run_dir,) = glob.glob(str(work / "logs" / "runs" / "*"))
    return metric, run_dir


def test_run_writes_the_jax_metric_keys(flagship_run):
    metric, run_dir = flagship_run
    assert metric == float("inf")  # mcedm logs no val_mae_u_scaled, as in JAX
    recs = records(run_dir)
    assert set().union(*map(set, recs)) == chip_smoke().FLAGSHIP_METRIC_KEYS
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == ["2"]
    cfg = json.load(open(os.path.join(run_dir, "config.json")))
    assert cfg["datamodule"]["train_path"].endswith("1D_swp_128_per_train.h5")


def test_callbacks_match_jax(tmp_path):
    """The configured callbacks of callbacks_ddim_save_traj.yaml, built from
    their config nodes in both packages and fed the same eval outputs (one
    mask task's trajectory and ground truth, two batches): the same plots
    and the same sample dumps."""
    import yaml

    from m_cedm_tpu.config import instantiate as jinstantiate
    from m_cedm_tpu_torch.config import instantiate as tinstantiate

    nodes = yaml.safe_load(open(os.path.join(CONFIG_DIR, "callbacks",
                                             "callbacks_ddim_save_traj.yaml")))
    rs = np.random.RandomState(0)
    batches = [{"traj_u": rs.randn(2, 1, 8, 8, 1).astype(np.float32),
                "gt_u": rs.randn(2, 8, 8, 1).astype(np.float32)} for _ in range(2)]
    for name, instantiate in (("jax", jinstantiate), ("port", tinstantiate)):
        cbs = [instantiate(dict(nodes["plotting"], num_samples=1)),
               instantiate(dict(nodes["save_samples"], dirpath=str(tmp_path / name / "samples"),
                                traj_name="traj_u", gt_name="gt_u"))]
        for cb in cbs:
            cb.setup(str(tmp_path / name))
            for i, out in enumerate(batches):
                cb.on_eval_batch(out, i, "test")
            cb.on_eval_end(0, "test")
    assert (sorted(os.listdir(tmp_path / "port" / "plots"))
            == sorted(os.listdir(tmp_path / "jax" / "plots")) == ["test_traj_00_e0.png"])
    for f in ("test_gen.npy", "test_gt.npy"):
        got = np.load(tmp_path / "port" / "samples" / f)
        np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "samples" / f))
        assert got.shape[0] == 4
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "samples" / "test_gt.npy"),
                                  np.concatenate([b["gt_u"] for b in batches]))


def test_eval_model_reproduces_the_runs_test_metrics(flagship_run, dataroot, tmp_path):
    _, run_dir = flagship_run
    metric = eval_model.main(["--device", "cpu", FLAGSHIP, f"dataroot={dataroot}",
                              f"ckpt_path={run_dir}", f"hydra.run.dir={tmp_path}"]
                             + TINY)
    assert metric == float("inf")  # no test_mae_u_scaled for mcedm
    want = [r for r in records(run_dir) if "test_mae_u" in r][0]
    (got,) = records(str(tmp_path))
    assert set(got) - {"time"} == {k for k in want if k.startswith("test_")} | {"epoch"}
    for k, v in want.items():
        if k.startswith("test_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_eval_model_serves_in_bf16(flagship_run, dataroot, tmp_path):
    """The JAX eval_model's bf16 override on the flagship's run checkpoint:
    the fp32 params load, the task serves in bf16 and logs the JAX keys, all
    finite, near the fp32 test's (bf16 rounds each layer's output to 3
    digits; an untrained net's PDE residual divides by sampled depths, so
    only the MAEs are compared, loosely)."""
    _, run_dir = flagship_run
    eval_model.main(["--device", "cpu", FLAGSHIP, f"dataroot={dataroot}",
                     f"ckpt_path={run_dir}", f"hydra.run.dir={tmp_path}",
                     "+model.hparams.model.dtype=bfloat16"] + TINY)
    want = [r for r in records(run_dir) if "test_mae_u" in r][0]
    (got,) = records(str(tmp_path))
    assert set(got) - {"time"} == {k for k in want if k.startswith("test_")} | {"epoch"}
    assert all(np.isfinite(v) for v in got.values())
    for k in ("test_mae_u", "test_mae_u_un"):
        np.testing.assert_allclose(got[k], want[k], rtol=0.1, err_msg=k)


def test_resume_trains_only_the_new_epochs(flagship_run, dataroot, tmp_path):
    """ckpt_path of a finished one-epoch run, trainer.max_epochs=3 and
    override_epochs: epochs 1 and 2 train, epoch 0 does not (plots off)."""
    _, run_dir = flagship_run
    run.main(["--device", "cpu", FLAGSHIP, f"dataroot={dataroot}",
              f"ckpt_path={run_dir}", "trainer.max_epochs=3", "override_epochs=true",
              "callbacks=callbacks_save_model", f"hydra.run.dir={tmp_path}"] + TINY)
    train_epochs = {r["epoch"] for r in records(str(tmp_path)) if "train_loss" in r}
    assert train_epochs == {1, 2}
    assert CheckpointManager(str(tmp_path / "checkpoints")).latest_step() == 6


def test_oformer_config_trains_and_tests(dataroot, tmp_path):
    metric = run.main(["--device", "cpu", "--config-name=config_oformer_t.yaml",
                       f"dataroot={dataroot}", "callbacks=callbacks_save_model",
                       f"hydra.run.dir={tmp_path}"] + OFORMER_TINY)
    assert np.isfinite(metric)  # the OFormer logs val_mae_u_scaled
    keys = set().union(*map(set, records(str(tmp_path))))
    assert {"train_loss", "val_mae_u_scaled", "test_mae_u", "test_pde_loss",
            "test_pde_loss_gt"} <= keys


def test_oformer_trains_in_bf16_resumes_and_tests(dataroot, tmp_path, monkeypatch):
    """config_oformer_t.yaml with trainer.precision=bf16 through run.main:
    one epoch (fit, validation, test) with the metric keys the JAX
    package's run.main writes with the same override on the same fixture
    (chip_smoke.py's OFORMER_METRIC_KEYS, which phase 17.4 holds on the
    card), all finite; the checkpoint holds fp32 params and AdamW state; a
    resume to epoch 2 trains epoch 1 only; eval_model serves the resumed
    checkpoint in bf16 (+model.hparams.dtype=bfloat16)."""
    import sys

    sys.path.insert(0, REPO)
    try:
        import run as jrun
    finally:
        sys.path.remove(REPO)
    common = ["--config-name=config_oformer_t.yaml", f"dataroot={dataroot}",
              "callbacks=callbacks_save_model", "trainer.precision=bf16"] + OFORMER_TINY
    monkeypatch.chdir(tmp_path)
    jrun.main(common + [f"hydra.run.dir={tmp_path / 'jax'}"])
    jax_keys = set().union(*map(set, records(str(tmp_path / "jax"))))
    assert jax_keys == chip_smoke().OFORMER_METRIC_KEYS
    common = ["--device", "cpu"] + common
    run.main(common + [f"hydra.run.dir={tmp_path / 'run'}"])
    recs = records(str(tmp_path / "run"))
    assert set().union(*map(set, recs)) == jax_keys
    assert all(np.isfinite(v) for r in recs for v in r.values())
    ckpt = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    saved = torch.load(os.path.join(ckpt.ckpt_dir, str(ckpt.latest_step()), "state.pt"),
                       weights_only=False)
    floats = [t for part in ("params", "opt_state") for t in _tensors(saved[part])
              if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    run.main(common + [f"ckpt_path={tmp_path / 'run'}", "trainer.max_epochs=2",
                       f"hydra.run.dir={tmp_path / 'resume'}"])
    resumed = records(str(tmp_path / "resume"))
    assert sorted(r["epoch"] for r in resumed if "train_loss" in r) == [1]
    assert all(np.isfinite(v) for r in resumed for v in r.values())
    eval_model.main(common + [f"ckpt_path={tmp_path / 'resume'}", "+model.hparams.dtype=bfloat16",
                              f"hydra.run.dir={tmp_path / 'eval'}"])
    (got,) = records(str(tmp_path / "eval"))
    want = [r for r in resumed if "test_mae_u" in r][-1]
    assert set(got) - {"time"} == {k for k in want if k.startswith("test_")} | {"epoch"}
    assert all(np.isfinite(v) for v in got.values())


def test_run_refuses_the_cpu_unless_asked(dataroot, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main([FLAGSHIP, f"dataroot={dataroot}", f"hydra.run.dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run.main(["-m", FLAGSHIP])


@pytest.mark.parametrize("config,extra,match", [
    ("config_adm_edm_res32_cond_h.yaml", [], None),
    ("config_ddim_res32.yaml", ["trainer.precision=bf16"], "bf16"),
    ("config_adm_edm_mcedm_res32.yaml", ["trainer.precision=bf16"], None),
], ids=["cond_edm_training", "ddim", "bf16"])
def test_cli_raises_on_what_is_not_ported(dataroot, tmp_path, config, extra, match):
    """bf16 training of the DDPM joint model reaches its U-Net's raise, which
    names ROADMAP.md, at its first train step (its U-Net has no bf16 path
    yet). The flagship's bf16 training, which raised here before it was
    ported, now trains, validates and tests with the JAX package's metric
    keys (resume and eval_model: test_flagship_trains_in_bf16_resumes_and_tests),
    as the conditional EDM's training does since it was ported (the FNO, which
    raised here before it was ported: test_fno_config_trains_resumes_and_tests;
    the other baselines: test_baseline_configs_train_and_test)."""
    argv = ["--device", "cpu", f"--config-name={config}", f"dataroot={dataroot}",
            "trainer.max_epochs=1", "callbacks=callbacks_save_model",
            f"hydra.run.dir={tmp_path}"] + tiny(config) + extra
    if match is None:
        run.main(argv)
        recs = records(str(tmp_path))
        keys = set().union(*map(set, recs))
        assert keys == (chip_smoke().FLAGSHIP_METRIC_KEYS if "mcedm" in config
                        else chip_smoke().COND_METRIC_KEYS)
        assert all(np.isfinite(v) for r in recs for v in r.values())
        return
    with pytest.raises(NotImplementedError, match=match) as err:
        run.main(argv)
    assert "ROADMAP.md" in str(err.value)


def test_flagship_trains_in_bf16_resumes_and_tests(dataroot, tmp_path):
    """trainer.precision=bf16 through run.main: one epoch (fit, validation,
    test) with the JAX package's keys, all finite; the checkpoint holds fp32
    master params, Adam state and EMA; a resume to epoch 2 trains epoch 1
    only, in bf16; eval_model reads the checkpoint and tests in bf16."""
    common = ["--device", "cpu", FLAGSHIP, f"dataroot={dataroot}",
              "callbacks=callbacks_save_model", "trainer.precision=bf16"] + TINY
    run.main(common + ["trainer.max_epochs=1", f"hydra.run.dir={tmp_path / 'run'}"])
    recs = records(str(tmp_path / "run"))
    assert set().union(*map(set, recs)) == chip_smoke().FLAGSHIP_METRIC_KEYS
    assert all(np.isfinite(v) for r in recs for v in r.values())
    ckpt = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    saved = torch.load(os.path.join(ckpt.ckpt_dir, str(ckpt.latest_step()), "state.pt"),
                       weights_only=False)
    floats = [t for part in ("params", "ema_params", "opt_state")
              for t in _tensors(saved[part]) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    run.main(common + [f"ckpt_path={tmp_path / 'run'}", "trainer.max_epochs=2",
                       f"hydra.run.dir={tmp_path / 'resume'}"])
    resumed = records(str(tmp_path / "resume"))
    assert sorted(r["epoch"] for r in resumed if "train_loss" in r) == [1]
    assert all(np.isfinite(v) for r in resumed for v in r.values())
    eval_model.main(common + [f"ckpt_path={tmp_path / 'resume'}",
                              f"hydra.run.dir={tmp_path / 'eval'}"])
    (got,) = records(str(tmp_path / "eval"))
    want = [r for r in resumed if "test_mae_u" in r][-1]
    assert set(got) - {"time"} == {k for k in want if k.startswith("test_")} | {"epoch"}
    assert all(np.isfinite(v) for v in got.values())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


@pytest.mark.parametrize("config", ["config_ddim_res32.yaml", "config_adm_res32_cond_h.yaml",
                                    "config_ddim_res32_cond_h.yaml",
                                    "config_edm_res32_cond_h.yaml"])
def test_baseline_configs_train_and_test(dataroot, tmp_path, config):
    """The diffusion baselines through run.main and eval_model.main on the
    CPU: one epoch, validation, the test; eval_model on the run's checkpoint
    reproduces the run's test metrics; every key is the JAX package's. The
    joint model runs its configured callbacks (callbacks_ddim.yaml, one
    plotted sample) and is also tested with diff_sampler=ddim_sampler
    (RePaint DDIM). Without --device cpu and without a card, run.main
    raises."""
    ddim = config == "config_ddim_res32.yaml"
    callbacks = "callbacks.plotting.num_samples=1" if ddim else "callbacks=callbacks_save_model"
    common = ["--device", "cpu", f"--config-name={config}", f"dataroot={dataroot}",
              callbacks] + tiny(config)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run.main(common[2:] + [f"hydra.run.dir={tmp_path / 'refused'}"])
    run.main(common + ["trainer.max_epochs=1", f"hydra.run.dir={tmp_path / 'run'}"])
    recs = records(str(tmp_path / "run"))
    assert set().union(*map(set, recs)) == (
        chip_smoke().DDIM_METRIC_KEYS if config == "config_ddim_res32.yaml"
        else chip_smoke().COND_METRIC_KEYS)
    assert all(np.isfinite(v) for r in recs for v in r.values())
    eval_model.main(common + [f"ckpt_path={tmp_path / 'run'}",
                              f"hydra.run.dir={tmp_path / 'eval'}"])
    want = [r for r in recs if "test_mae_u" in r][0]
    (got,) = records(str(tmp_path / "eval"))
    for k, v in want.items():
        if k.startswith("test_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    if ddim:
        assert os.listdir(tmp_path / "run" / "plots")
        eval_model.main(common + [f"ckpt_path={tmp_path / 'run'}", "diff_sampler=ddim_sampler",
                                  "diff_sampler.timesteps=4", "diff_sampler.n_repeat=2",
                                  f"hydra.run.dir={tmp_path / 'eval_ddim'}"])
        (got,) = records(str(tmp_path / "eval_ddim"))
        assert set(got) - {"epoch", "time"} == {
            k for k in chip_smoke().DDIM_METRIC_KEYS if k.startswith("test_")}
        assert all(np.isfinite(v) for v in got.values())


def test_oformer_resume_keeps_the_schedule(tmp_path):
    """The OFormer's one-cycle lr reads the optimizer's count, so a state
    restored after configure_lr_schedule continues the schedule where it
    stopped."""
    from m_cedm_tpu_torch import config as tconfig

    cfg = tconfig.compose(CONFIG_DIR, "config_oformer_t.yaml", OFORMER_TINY)
    hp = tconfig.to_plain(cfg.model.hparams)

    def fresh():
        task = build_task(hp, "cpu", target="m_cedm_tpu.tasks.OformerTask")
        task.configure_lr_schedule(2, 3)
        return task

    task = fresh()
    state = task.init_state(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    n = 16 * 16
    batch = (torch.from_numpy(rs.randn(2, 1, n, 3).astype(np.float32)),
             torch.from_numpy(rs.randn(2, 1, n, 1).astype(np.float32)),
             torch.zeros(2, n, 1, dtype=torch.int32),
             torch.from_numpy(rs.rand(2, n, 2).astype(np.float32)),
             torch.full((2,), 16, dtype=torch.int32))
    for i in range(2):
        state, _ = task.train_step(state, batch, torch.Generator().manual_seed(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    again = fresh()
    restored = mgr.restore(again.init_state(torch.Generator().manual_seed(1)))
    assert int(restored.opt_state["count"]) == 2 == restored.step
    count = restored.opt_state["count"]
    assert float(again.tx.lr(count)) == float(task.tx.lr(state.opt_state["count"]))
    assert float(again.tx.lr(count)) != float(again.tx.lr(torch.zeros_like(count)))
    for k, v in state.constants.items():
        assert torch.equal(restored.constants[k], v)


def test_fno_config_trains_resumes_and_tests(dataroot, tmp_path, monkeypatch):
    """config_fnostatereconstrabs2d.yaml through run.main and
    eval_model.main on the CPU with its configured callbacks (the plots of
    the FNO's (B, T, X, C) predictions): one epoch with validation and the
    test; the metric keys those the JAX package's run.main writes on the
    same fixture (and chip_smoke.py's FNO_METRIC_KEYS, which phase 14 holds
    on the card); eval_model on the run's checkpoint within 1e-4 of its
    test metrics; a resume to epoch 2 trains epoch 1 only."""
    import sys

    sys.path.insert(0, REPO)
    try:
        import run as jrun
    finally:
        sys.path.remove(REPO)
    common = [FNO_CONFIG, f"dataroot={dataroot}"] + FNO_TINY
    monkeypatch.chdir(tmp_path)
    jrun.main(common + ["trainer.max_epochs=1", f"hydra.run.dir={tmp_path / 'jax'}"])
    jax_keys = set().union(*map(set, records(str(tmp_path / "jax"))))
    assert jax_keys == chip_smoke().FNO_METRIC_KEYS

    run.main(["--device", "cpu"] + common + ["trainer.max_epochs=1",
                                             f"hydra.run.dir={tmp_path / 'run'}"])
    recs = records(str(tmp_path / "run"))
    assert set().union(*map(set, recs)) == jax_keys
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert os.listdir(tmp_path / "run" / "plots")
    eval_model.main(["--device", "cpu"] + common + [f"ckpt_path={tmp_path / 'run'}",
                                                    f"hydra.run.dir={tmp_path / 'eval'}"])
    want = [r for r in recs if "test_mae_u" in r][0]
    (got,) = records(str(tmp_path / "eval"))
    assert {k for k in got if k.startswith("test_")} == {k for k in want
                                                         if k.startswith("test_")}
    for k in got:
        if k.startswith("test_"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    run.main(["--device", "cpu"] + common + [
        f"ckpt_path={tmp_path / 'run'}", "trainer.max_epochs=2",
        "callbacks=callbacks_save_model", f"hydra.run.dir={tmp_path / 'resume'}"])
    resumed = records(str(tmp_path / "resume"))
    assert sorted(r["epoch"] for r in resumed if "train_loss" in r) == [1]
    assert CheckpointManager(str(tmp_path / "resume" / "checkpoints")).latest_step() == 4
