"""bf16 serving of the ADM U-Net against the JAX package (about 50 s in one
process, most of it compiling the JAX U-Net with its Pallas kernels in
interpret mode, and JAX's evals).

  cast      the port's sampling params (`_sample_params` of a bf16 task) are
            the JAX task's cast_floating of the same params, bit for bit;
  forward   `net_apply` of a bf16 McedmTask (ch 64, res 32, two levels,
            attention at 16x16) against the JAX task's bf16 net_apply with
            its Pallas kernels forced on in interpret mode (the kernels the
            TPU runs, which the port's kernels round as): within 3e-2 of the
            output's scale (about 25 chained layers, each of which may flip
            the last bit of its bf16 output); against JAX's default CPU route
            (XLA references that round elsewhere) within JAX's own atol 0.05
            (tests/test_precision.py); and its error against the JAX fp32
            forward at most 1.5 times the JAX bf16 forward's (the port loses
            no more precision than the reference does);
  eval      McedmTask.eval_step in bf16 (3 Heun steps with S_churn 15, JAX's
            draws injected) against JAX's on its default CPU route (its
            Pallas kernels in interpret mode take about ten seconds a
            forward; the forward above holds the port to them): the
            metrics within 2e-2 relative, except test_pde_loss: the PDE
            residual of an untrained net's samples divides by sampled depths
            and turns a sample's last-bit differences into large metric
            ones, so it is held, as in tests/test_torch_ddim_eval.py, to
            JAX's residual of the port's own samples (rtol 1e-4), and its
            ratio to JAX's bf16 value is reported; the observed channel h equal to the
            ground truth within 1e-5; the sample's mean gap from JAX's fp32
            sample at most 1.5 times JAX's bf16 sample's gap, and under
            JAX's own 0.1 (tests/test_precision.py);
  cond      CondEdmTask.eval_step (adm_edm_cond_h) in bf16 against JAX's,
            held the same way;
  refusals  the DDPM U-Net and the FNO in bf16 raise
            NotImplementedError naming ROADMAP.md (bf16 training of the ADM
            tasks is held in tests/test_torch_bf16_train.py; the megakernel
            path in bf16, mega=True, in tests/test_torch_mega_bf16.py; the
            OFormer in bf16 in tests/test_torch_oformer_bf16.py).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_block as jfb
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import CondEdmTask as JaxCondEdmTask
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu.tasks.base import TrainState, normalizers_from_stats
from m_cedm_tpu.tasks.diffusion import cast_floating as jax_cast_floating
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.data.masks import eval_masks_var
from m_cedm_tpu_torch.tasks import McedmTask, build_task
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, B, STEPS = 32, 2, 3
STATS = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1, "target_std": 0.3}
COND_TARGET = "m_cedm_tpu.tasks.CondEdmTask"


def hparams(dtype="bfloat16"):
    return {
        "name": "adm_edm_mcedm",
        "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True, "out_ch": 2,
                  "ch": 64, "ch_mult": [1, 1], "num_res_blocks": 1,
                  "attn_resolutions": [RES // 2], "dropout": 0.0, "resolution": RES,
                  "ema": True, "cond_p": 1.0, "dx_cond": False, "self_cond": False,
                  "add_cond_mask": False, "add_xt": False, "dtype": dtype},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": "Adam", "lr": 2e-4},
        "sampler": {"timesteps": STEPS, "sigma_min": 0.002, "sigma_max": 80, "rho": 7,
                    "S_churn": 15.0, "S_min": 0, "S_max": "inf", "S_noise": 1,
                    "w": 0.0, "guide_dx": False},
    }


def swe_batch(seed):
    rs = np.random.RandomState(seed)
    h = (rs.randn(B, RES, RES, 1) * 0.1 + 4.0).astype(np.float32)
    u = (rs.randn(B, RES, RES, 1) * 0.2).astype(np.float32)
    tg = np.broadcast_to(np.linspace(0, 1, RES)[None, :, None, None], h.shape)
    xg = np.broadcast_to(np.linspace(0, 1, RES)[None, None, :, None], h.shape)
    return h, tg.astype(np.float32), xg.astype(np.float32), u


def seeded(params, seed):
    """Fan-in-scaled normals for every leaf of a (traced) params tree; norm
    scales around 1."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture
def kernels(monkeypatch):
    """The JAX package's Pallas kernels forced on, in interpret mode."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    for mod in (jfn, jfnc, jfa, jfb):
        monkeypatch.setattr(mod.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setenv("MCEDM_PALLAS", "1")


@pytest.fixture(scope="module")
def flagship():
    """The JAX fp32 and bf16 tasks and the port's bf16 task on one seeded
    state."""
    j32, j16 = JaxMcedmTask(to_dotdict(hparams("float32"))), JaxMcedmTask(
        to_dotdict(hparams()))
    jstate = jax_state(j32, 0)
    task = build_task(hparams(), "cpu")
    state = task.init_state(None, STATS, params=jax_params_to_state_dict(jstate.params))
    return j32, j16, jstate, task, state


def jax_state(jtask, seed):
    """The JAX task's state with seeded params, their shapes traced only (an
    eager flax init of the U-Net takes seconds), as its init_state builds it."""
    cfg = jtask.model_cfg
    x0 = jnp.zeros((1, RES, RES, cfg.in_channels), jnp.float32)
    c0 = jnp.zeros((1, RES, RES, cfg.cond_channels), jnp.float32)
    params = seeded(jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0), x0,
                                   jnp.ones((1,), jnp.float32), c0), seed)
    n_in, n_tar = normalizers_from_stats(STATS, "gauss")
    return TrainState(params=params, ema_params=params, opt_state=None,
                      step=jnp.zeros((), jnp.int32), normalizer_input=n_in,
                      normalizer_target=n_tar)


def scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_sample_params_are_jax_cast_floating(flagship):
    _, _, jstate, task, state = flagship
    got = task._sample_params(state)
    # weights in bf16; the vectors (biases, norm scales) bf16-rounded, in fp32
    assert all(v.dtype == (torch.float32 if v.dim() == 1 else torch.bfloat16)
               for v in got.values())
    want = jax_params_to_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
        jax_cast_floating(jstate.ema_params, jnp.bfloat16)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k
    # the fp32 masters stay as they were
    assert all(v.dtype == torch.float32 for v in state.params.values())


def forward_inputs():
    rs = np.random.RandomState(7)
    x = rs.randn(B, RES, RES, 2).astype(np.float32)
    cond = rs.randn(B, RES, RES, 2).astype(np.float32)
    t = rs.uniform(-1.5, 1.0, B).astype(np.float32)
    return x, t, cond


def test_unet_forward_matches_jax(flagship, kernels):
    j32, j16, jstate, task, state = flagship
    x, t, cond = forward_inputs()
    jx = tuple(map(jnp.asarray, (x, t, cond)))
    # kernels forced, jitted: one compile of the interpret-mode kernels is
    # quicker than running them eagerly
    j_bf16 = np.asarray(jax.jit(j16.net_apply)(jstate.params, *jx))
    got = task.net_apply(task._sample_params(state), *map(torch.from_numpy, (x, t, cond)))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert scaled_err(got, j_bf16) <= 3e-2
    os.environ["MCEDM_PALLAS"] = "0"  # the default CPU route (the fixture restores it)
    j_fp32 = np.asarray(j32.net_apply(jstate.params, *jx))
    j_bf16_ref = np.asarray(j16.net_apply(jstate.params, *jx))
    np.testing.assert_allclose(got, j_bf16_ref, atol=0.05)
    assert scaled_err(got, j_fp32) <= 1.5 * scaled_err(j_bf16, j_fp32)
    # the mean gaps: the port's to JAX's bf16 forward under bf16's own gap to
    # fp32, and its gap to fp32 at least half JAX bf16's, which a port that
    # computed in fp32 would not have
    gap = {k: np.abs(np.float64(a) - b).mean() / np.abs(j_fp32).max()
           for k, (a, b) in {"port_jax16": (got, j_bf16), "jax16_32": (j_bf16, j_fp32),
                             "port_32": (got, j_fp32)}.items()}
    assert gap["port_jax16"] < gap["jax16_32"]
    assert gap["port_32"] >= 0.5 * gap["jax16_32"]


def jax_eval_draws(key, shape, n_steps):
    """cond noise, then the single ensemble member's init and churn draws
    (tests/test_torch_task.py)."""
    k_cond, k_sample = jax.random.split(key)
    (k,) = jax.random.split(k_sample, 1)
    k_init, k_loop = jax.random.split(k)
    churn = [np.array(jax.random.normal(jax.random.split(kk)[0], shape, jnp.float32))
             for kk in jax.random.split(k_loop, n_steps)]
    return (np.array(jax.random.normal(k_cond, shape)),
            np.array(jax.random.normal(k_init, shape, jnp.float32))[None],
            np.stack(churn)[None])


def hold_eval(m_t, m_j, hu_t, hu_j16, hu_j32, pde_key, pde_of_port, known=None):
    """pde_of_port: JAX's residual metric of the port's own samples."""
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        got, want = float(m_t[k]), float(m_j[k])
        if k == pde_key:
            np.testing.assert_allclose(got, pde_of_port, rtol=1e-4)
            print(f"{k}: port {got}, JAX bf16 {want}, ratio {got / want}")
        else:
            assert abs(got - want) <= 2e-2 * abs(want), (k, got, want)
    if known is not None:
        np.testing.assert_allclose(hu_t[..., 0], known, rtol=0, atol=1e-5)
    gap_t = float(np.abs(hu_t - hu_j32).mean())
    gap_j = float(np.abs(np.asarray(hu_j16) - hu_j32).mean())
    assert gap_t <= 1.5 * gap_j and gap_t < 0.1, (gap_t, gap_j)


def test_eval_step_matches_jax(flagship):
    j32, j16, jstate, task, state = flagship
    batch = swe_batch(1)
    mask = eval_masks_var(RES, RES)["u"]
    key = jax.random.PRNGKey(3)
    jb = tuple(map(jnp.asarray, batch))
    m_j, hu_j = j16.eval_step(jstate, jb, key, jnp.asarray(mask), split="test",
                              mask_name="u")
    _, hu_j32 = j32.eval_step(jstate, jb, key, jnp.asarray(mask), split="test",
                              mask_name="u")
    cond, init, churn = map(torch.from_numpy,
                            jax_eval_draws(key, (B, RES, RES, 2), STEPS))
    m_t, hu_t = task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                               torch.from_numpy(mask), split="test", mask_name="u",
                               cond_noise=cond, init_noise=init, churn_noise=churn)
    assert hu_t.dtype == torch.float32
    gt = task.transform.forward(state, *map(torch.from_numpy, (batch[0], batch[3])))
    pde = float(jnp.sum(j16._pde_matrix_joint(jstate, jnp.asarray(hu_t.numpy()),
                                              clamp_loss=False))) / B
    hold_eval(m_t, m_j, hu_t.numpy(), hu_j, np.asarray(hu_j32), "test_pde_loss_u", pde,
              gt[..., 0].numpy())


def cond_hparams(dtype="bfloat16"):
    """adm_edm_cond_h at the test's size (tests/test_torch_cond_edm.py)."""
    return {
        "name": "adm_edm_cond_h",
        "model": {"in_channels": 1, "cond_channels": 1, "cat_cond": True,
                  "out_ch": 1, "ch": 64, "ch_mult": [1, 1], "num_res_blocks": 1,
                  "attn_resolutions": [RES // 2], "dropout": 0.0, "resolution": RES,
                  "ema": True, "self_cond": False, "dx_cond": False, "dtype": dtype},
        "data": {"normalization": "gauss"},
        "optimization": {"optimizer": "Adam", "lr": 2e-4},
        "sampler": {"name": "edm", "type": "edm", "timesteps": STEPS,
                    "sigma_min": 0.002, "sigma_max": 80, "rho": 7, "S_churn": 15.0,
                    "S_min": 0, "S_max": "inf", "S_noise": 1, "w": 0.0,
                    "guide_dx": False, "select_by_pde": False},
        "diffusion": {"beta_schedule": "linear", "beta_start": 0.0001,
                      "beta_end": 0.02, "num_diffusion_timesteps": 1000},
    }


def test_cond_edm_eval_step_matches_jax():
    """CondEdmTask's metrics include correlations, which lie in [-1, 1] and
    sit near 0 for random weights: those are held to 2e-2 absolute."""
    j16 = JaxCondEdmTask(to_dotdict(cond_hparams()))
    j32 = JaxCondEdmTask(to_dotdict(cond_hparams("float32")))
    jstate = jax_state(j32, 1)
    params = jstate.params
    task = build_task(cond_hparams(), "cpu", target=COND_TARGET)
    state = task.init_state(None, STATS, params=jax_params_to_state_dict(params))
    batch = swe_batch(2)
    key = jax.random.PRNGKey(4)
    jb = tuple(map(jnp.asarray, batch))
    m_j, u_j = j16.eval_step(jstate, jb, key, split="test")
    _, u_j32 = j32.eval_step(jstate, jb, key, split="test")
    (k,) = jax.random.split(key, 1)  # the one ensemble member's key
    k_init, k_loop = jax.random.split(k)
    shape = (B, RES, RES, 1)
    churn = np.stack([np.array(jax.random.normal(jax.random.split(kk)[0], shape,
                                                 jnp.float32))
                      for kk in jax.random.split(k_loop, STEPS)])
    init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    m_t, u_t = task.eval_step(state, tuple(map(torch.from_numpy, batch)), None,
                              split="test", init_noise=torch.from_numpy(init[None]),
                              churn_noise=torch.from_numpy(churn[None]))
    corr = {k_: v for k_, v in m_j.items() if "corr" in k_}
    for k_ in corr:
        assert abs(float(m_t[k_]) - float(m_j[k_])) <= 2e-2, k_
    h = j16.transform.forward(jstate, jb[0], jb[3])[..., :1]
    pde = float(jnp.sum(j16._pde_matrix_cond(jstate, h, jnp.asarray(u_t.numpy()),
                                             clamp_loss=False))) / B
    hold_eval({k_: v for k_, v in m_t.items() if k_ not in corr},
              {k_: v for k_, v in m_j.items() if k_ not in corr},
              u_t.numpy(), u_j, np.asarray(u_j32), "test_pde_loss", pde)


# --- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("model", ["ddpm", "fno"])
def test_other_families_refuse_bf16(model):
    if model == "ddpm":
        hp = yaml.safe_load(open(os.path.join(REPO, "configs/model/ddim_res32.yaml")))
        hp["hparams"]["model"]["dtype"] = "bfloat16"
    else:
        hp = yaml.safe_load(open(os.path.join(REPO, "configs/model/fnostatereconstr2d.yaml")))
        hp["hparams"]["dtype"] = "bfloat16"
    kw = {"steps_per_epoch": 1} if model == "fno" else {}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task = build_task(hp["hparams"], "cpu", target=hp["_target_"], **kw)
        state = task.init_state(torch.Generator().manual_seed(0), None)
        if model == "fno":  # the FNO refuses in its forward
            task.model(torch.zeros(1, 32, 32, 1))
        else:  # the DDPM U-Net in its forward, on the task's bf16 input
            x = torch.zeros(1, 32, 32, 2)
            task.net_apply(task._sample_params(state), x, torch.zeros(1))
    if model == "ddpm":  # and the net itself
        from m_cedm_tpu_torch.models.ddpm_unet import DdpmUNet, DdpmUNetConfig

        net = DdpmUNet(DdpmUNetConfig.from_hparams(hp["hparams"]))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            net(torch.zeros(1, 32, 32, 2, dtype=torch.bfloat16), torch.zeros(1))
