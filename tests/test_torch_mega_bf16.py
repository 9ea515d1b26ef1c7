"""K7 in bf16 (the megakernel path, `mega=True`, on a bf16 network) against
the JAX package on the CPU (about 15 s in one process, 12 s of it in the
tests, most of that JAX's interpret-mode kernels and its U-Net's compile).

  block     the bf16 plain K7 (`fused_unet_block_plain` of bf16 operands, what
            the wrapper runs on the CPU) against the Pallas `_pallas_mega` in
            interpret mode on the same bf16 inputs with chained fp32
            statistics: the identity block, the decoder's dual input with a
            1x1 projection emitting statistics, and the up block; outputs
            within 1e-2 of scale at most and 1e-4 on average, the emitted
            statistics within 1e-5 (the tolerances of
            tests/test_torch_bf16_kernels.py: fp32 summation order and the
            one-ulp flips it causes at a bf16 rounding);
  dtypes    the bf16 K7 launch refuses a mix of dtypes other than bf16
            activations and weights with fp32 vectors and statistics;
  rounding  the composition that recomputes the statistics (the fp32 plain
            K7's: norm0's from the rounded input, norm1's from the rounded h)
            misses the output bound on an input that a producing kernel
            rounded far from zero, where the chained one meets it: the bf16
            plain version rounds where the kernel does;
  unet      `AdmUNet(mega=True)` in bf16 under no_grad (ch 64, res 16, two
            levels, attention at 8x8) against the JAX U-Net with
            MCEDM_MEGA=1 in bf16 with its Pallas kernels in interpret mode,
            through both tasks' net_apply: within 3e-2 of the output's scale
            (tests/test_torch_bf16_task.py's bound: about 20 chained bf16
            layers, each of which may flip the last bit of its output); every
            non-down block one unet_block call;
  eval      one `CondEdmTask.eval_step` in bf16 with mega=True (3 Heun steps)
            against the per-conv bf16 eval on the same draws: metrics within
            2e-2 (relative, the correlations absolute); test_pde_loss, the
            ill-conditioned residual of an untrained net's samples, as each
            path's own sample's residual and clamped within 2e-2.

Inputs are made with numpy from a seed and rounded to bf16 on both sides.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_block as jfb
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.kernels import DEVICE_OPS
from m_cedm_tpu_torch.kernels import fused_block as tfb
from m_cedm_tpu_torch.tasks import build_task
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, EPS = 2, 1e-5
TOL_MAX, TOL_MEAN, TOL_STATS = 1e-2, 1e-4, 1e-5
TOL_UNET, TOL_METRICS = 3e-2, 2e-2
ARGS = ("x", "g0", "b0", "w0", "bias0", "g1", "b1", "w1", "bias1")
# (H, W of the input, C1, C2, O, up, proj), each with chained statistics and
# emitted ones
CASES = {
    "identity": (16, 16, 32, 0, 32, False, False),
    "dual-proj-emit": (16, 16, 32, 16, 32, False, True),
    "up": (8, 8, 32, 0, 32, True, False),
}


@pytest.fixture
def interpret(monkeypatch):
    """Force the Pallas kernels on and run them in interpret mode (CPU)."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    for mod in (jfn, jfnc, jfa, jfb):
        monkeypatch.setattr(mod.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfn, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jfnc, "pallas_enabled", lambda: True)
    monkeypatch.setenv("MCEDM_PALLAS", "1")


def bf16(rs, *shape, scale=1.0, shift=0.0):
    """A bf16-rounded numpy draw, as fp32 (both sides take it as bf16)."""
    a = (rs.randn(*shape) * scale + shift).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def f32(rs, *shape, scale=1.0, shift=0.0):
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


def sums_of(x):
    """fp32 channel sums of an NHWC array over its pixels."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1, x.shape[-1])
    return x.sum(1).astype(np.float32), (x * x).sum(1).astype(np.float32)


def block_inputs(case, seed):
    """Numpy inputs of one block; x, x2 and the weights bf16-rounded, the
    vectors fp32, `stats` xin's fp32 sums."""
    h, w, c1, c2, o, up, proj = CASES[case]
    rs = np.random.RandomState(seed)
    c = c1 + c2
    a = dict(x=bf16(rs, B, h, w, c1, scale=0.8, shift=0.2),
             g0=f32(rs, B, c, scale=0.3, shift=1.0), b0=f32(rs, B, c, scale=0.3),
             w0=bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c)),
             bias0=f32(rs, o, scale=0.3),
             g1=f32(rs, B, o, scale=0.3, shift=1.0), b1=f32(rs, B, o, scale=0.3),
             w1=bf16(rs, 3, 3, o, o, scale=1.0 / np.sqrt(9 * o)), bias1=f32(rs, o, scale=0.3))
    if c2:
        a["x2"] = bf16(rs, B, h, w, c2, scale=0.8, shift=0.2)
    if proj:
        a["skip_w"], a["skip_b"] = bf16(rs, c, o, scale=1.0 / np.sqrt(c)), f32(rs, o, scale=0.3)
    a["stats"] = sums_of(np.concatenate([a["x"]] + ([a["x2"]] if c2 else []), -1))
    return a, dict(emit_stats=True, up=up)


BF16_KEYS = ("x", "x2", "w0", "w1", "skip_w")


def torch_args(a):
    def t(k):
        v = torch.from_numpy(np.array(a[k]))
        return v.to(torch.bfloat16) if k in BF16_KEYS else v
    kw = {k: t(k) for k in ("x2", "skip_w", "skip_b") if k in a}
    kw["stats"] = tuple(map(torch.from_numpy, a["stats"]))
    return [t(k) for k in ARGS], kw


def jax_args(a):
    def j(k):
        return jnp.asarray(a[k], jnp.bfloat16 if k in BF16_KEYS else jnp.float32)
    kw = {k: j(k) for k in ("x2", "skip_w", "skip_b") if k in a}
    kw["stats"] = tuple(map(jnp.asarray, a["stats"]))
    return [j(k) for k in ARGS], kw


def flat(out):
    out = [out[0], *out[1]] if isinstance(out[1], tuple) else list(out)
    return [np.asarray(v.float() if isinstance(v, torch.Tensor) else v.astype(jnp.float32),
                       np.float64) for v in out]


def errors(got, want):
    """(max, mean) of the output's error and the statistics' max, of scale."""
    def err(g, w):
        e = np.abs(g - w)
        s = np.abs(w).max()
        return e.max() / s, e.mean() / s
    mx, mean = err(got[0], want[0])
    return mx, mean, max(err(g, w)[0] for g, w in zip(got[1:], want[1:]))


def pallas_mega(a, flags):
    args, kw = jax_args(a)
    return flat(jfb._pallas_mega(*args, 8, 8, EPS, **kw, **flags))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_mega(interpret, case):
    a, flags = block_inputs(case, seed=3 + list(CASES).index(case))
    args, kw = torch_args(a)
    out = tfb.fused_unet_block_plain(*args, 8, 8, EPS, **kw, **flags)
    assert out[0].dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in out[1])
    got, want = flat(out), pallas_mega(a, flags)
    h, w, _, _, o, up, _ = CASES[case]
    assert got[0].shape == (B, 2 * h if up else h, 2 * w if up else w, o)
    mx, mean, stats = errors(got, want)
    assert mx <= TOL_MAX and mean <= TOL_MEAN and stats <= TOL_STATS, (mx, mean, stats)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        flat(tfb.fused_unet_block(*args, 8, 8, EPS, **kw, **flags))[0], got[0])


def _mixed_calls():
    a, flags = block_inputs("dual-proj-emit", seed=1)
    args, kw = torch_args(a)
    stats = kw.pop("stats")

    def launch(args=args, **over):
        k = dict(kw, **over)
        return tfb._unet_block_kernel(*args, 8, 8, EPS, k["x2"], k["skip_w"], k["skip_b"],
                                      stats, True, False)
    return {
        "fp32 conv0 weight": lambda: launch(args[:3] + [args[3].float()] + args[4:]),
        "fp32 encoder skip": lambda: launch(x2=kw["x2"].float()),
        "fp32 skip weight": lambda: launch(skip_w=kw["skip_w"].float()),
        "bf16 bias": lambda: launch(args[:4] + [args[4].bfloat16()] + args[5:]),
        "bf16 statistics": lambda: tfb._unet_block_kernel(
            *args, 8, 8, EPS, kw["x2"], kw["skip_w"], kw["skip_b"],
            tuple(t.bfloat16() for t in stats), True, False),
    }


@pytest.mark.parametrize("case", list(_mixed_calls()))
def test_k7_launch_refuses_mixed_dtypes(case):
    """The bf16 launch takes bf16 x, x2 and weights with fp32 vectors and
    statistics; the checks run before any library is loaded, so here."""
    with pytest.raises(ValueError, match="must be"):
        _mixed_calls()[case]()


def unchained(args, kw, flags):
    """The fp32 plain K7's composition on bf16 operands: norm0's statistics
    from xin itself, norm1's from the rounded h, the emitted ones from the
    output's fp32 sums."""
    kw = {k: v for k, v in kw.items() if k != "stats"}
    return tfb._composition(tfb.gn_silu_conv_plain, tfb.gn_silu_up_conv_plain, *args, 8, 8,
                            EPS, kw.get("x2"), kw.get("skip_w"), kw.get("skip_b"),
                            flags["emit_stats"], flags["up"])


def test_unchained_composition_misses_the_bound(interpret):
    """x as a producing kernel hands it on: its fp32 values around 3 with a
    spread of 0.2, rounded to bf16 (a step of 2^-6 there), and the chained
    statistics those of the fp32 values. The rounding moves x's variance by
    about 0.05 %: the composition that recomputes norm0's statistics from the
    rounded x (and norm1's from the rounded h), as the fp32 K7's plain
    version does, normalizes differently from the kernel, and its mean error
    is several times the bound that the chained composition meets."""
    a, flags = block_inputs("identity", seed=9)
    xf = f32(np.random.RandomState(109), *a["x"].shape, scale=0.2, shift=3.0)
    a["x"] = np.asarray(jnp.asarray(xf, jnp.bfloat16).astype(jnp.float32))
    a["stats"] = sums_of(xf)
    args, kw = torch_args(a)
    want = pallas_mega(a, flags)
    mx, mean, _ = errors(flat(tfb.fused_unet_block_plain(*args, 8, 8, EPS, **kw, **flags)),
                         want)
    assert mx <= TOL_MAX and mean <= TOL_MEAN, (mx, mean)
    mx, mean, _ = errors(flat(unchained(args, kw, flags)), want)
    assert mean > 2 * TOL_MEAN, (mx, mean)


# --- the U-Net's megakernel mode in bf16 ---------------------------------------

RES = 16


def hparams(target_cond=False):
    m = {"in_channels": 2, "cond_channels": 2, "cat_cond": True, "out_ch": 2, "ch": 64,
         "ch_mult": [1, 1], "num_res_blocks": 1, "attn_resolutions": [RES // 2],
         "dropout": 0.0, "resolution": RES, "ema": True, "self_cond": False,
         "dx_cond": False, "dtype": "bfloat16"}
    hp = {"name": "adm_edm_mcedm", "model": m, "data": {"normalization": "gauss"},
          "optimization": {"optimizer": "Adam", "lr": 2e-4},
          "sampler": {"timesteps": 3, "sigma_min": 0.002, "sigma_max": 80, "rho": 7,
                      "S_churn": 15.0, "S_min": 0, "S_max": "inf", "S_noise": 1,
                      "w": 0.0, "guide_dx": False}}
    if target_cond:
        hp["name"] = "adm_edm_cond_h"
        m.update(in_channels=1, cond_channels=1, out_ch=1)
        hp["sampler"].update(name="edm", type="edm", select_by_pde=False)
        hp["diffusion"] = {"beta_schedule": "linear", "beta_start": 0.0001,
                           "beta_end": 0.02, "num_diffusion_timesteps": 1000}
    else:
        m.update(cond_p=1.0, add_cond_mask=False, add_xt=False)
    return hp


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


def test_mega_unet_matches_jax_mega_in_bf16(interpret, monkeypatch):
    jtask = JaxMcedmTask(to_dotdict(hparams()))
    rs = np.random.RandomState(7)
    x, cond = (rs.randn(B, RES, RES, 2).astype(np.float32) for _ in range(2))
    t = rs.uniform(-1.5, 1.0, B).astype(np.float32)
    z = jnp.zeros((1, RES, RES, 2), jnp.float32)
    params = seeded(jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0), z,
                                   jnp.ones((1,), jnp.float32), z), 5)
    traced = []
    orig = jfb._pallas_mega
    monkeypatch.setenv("MCEDM_MEGA", "1")
    monkeypatch.setattr(jfb, "_pallas_mega",
                        lambda *a, **k: traced.append(k["up"]) or orig(*a, **k))
    want = np.asarray(jax.jit(jtask.net_apply)(params, *map(jnp.asarray, (x, t, cond))),
                      np.float64)
    # every non-down block of the JAX net took the Pallas megakernel
    assert len(traced) == 9 and sum(traced) == 1

    task = build_task(hparams(), "cpu", mega=True)
    state = task.init_state(None, None, params=jax_params_to_state_dict(params))
    calls = {"unet_block": 0}

    def spy(*a, **k):
        calls["unet_block"] += 1
        assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
        return DEVICE_OPS.unet_block(*a, **k)

    task.model.ops = dataclasses.replace(DEVICE_OPS, unet_block=spy)
    with torch.no_grad():
        got = task.net_apply(task._sample_params(state), *map(torch.from_numpy, (x, t, cond)))
    assert got.dtype == torch.float32 and calls["unet_block"] == 9
    got = got.numpy().astype(np.float64)
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got - want).max() <= TOL_UNET * scale, np.abs(got - want).max() / scale


def test_cond_edm_bf16_mega_eval_matches_per_conv():
    hp = hparams(target_cond=True)
    target = "m_cedm_tpu.tasks.CondEdmTask"
    tasks = [build_task(hp, "cpu", target=target, mega=m) for m in (True, False)]
    # seeded weights (a fresh ADM init zeroes conv1, proj and out_conv):
    # fan-in-scaled normals, the norm scales (1-D weights) around 1
    rs = np.random.RandomState(11)
    params = {k: torch.from_numpy((rs.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                                   if v.dim() > 1 else 1.0 * k.endswith("weight")
                                   + 0.3 * rs.randn(*v.shape)).astype(np.float32))
              for k, v in tasks[0].model.state_dict().items()}
    stats = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1, "target_std": 0.3}
    rs = np.random.RandomState(12)
    h = (rs.randn(B, RES, RES, 1) * 0.1 + 4.0).astype(np.float32)
    u = (rs.randn(B, RES, RES, 1) * 0.2).astype(np.float32)
    tg = np.broadcast_to(np.linspace(0, 1, RES)[None, :, None, None], h.shape)
    xg = np.broadcast_to(np.linspace(0, 1, RES)[None, None, :, None], h.shape)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                  for a in (h, tg, xg, u))
    init = torch.from_numpy(rs.randn(1, B, RES, RES, 1).astype(np.float32))
    churn = torch.from_numpy(rs.randn(1, 3, B, RES, RES, 1).astype(np.float32))
    metrics, pde = [], []
    for task in tasks:
        state = task.init_state(None, stats, params=params)
        m, sample = task.eval_step(state, batch, None, split="test", init_noise=init,
                                   churn_noise=churn)
        assert sample.dtype == torch.float32 and torch.isfinite(sample).all()
        metrics.append({k: float(v) for k, v in m.items()})
        h_norm = task.transform.forward(state, batch[0], batch[3])[..., :task.h_ch]
        pde.append([float(torch.sum(task._pde_matrix_cond(state, h_norm, sample,
                                                          clamp_loss=c))) / B
                    for c in (False, True)])
    mega, per_conv = metrics
    assert sorted(mega) == sorted(per_conv)
    for k, want in per_conv.items():
        assert np.isfinite(mega[k]), k
        if k == "test_pde_loss":
            # the residual of an untrained net's samples divides by sampled
            # depths and turns last-bit differences of the samples into large
            # ones (tests/test_torch_ddim_eval.py): held as the residual of
            # each path's own sample, and clamped (each element at most 1)
            # within the bound
            for m_, (raw, _) in zip(metrics, pde):
                np.testing.assert_allclose(m_[k], raw, rtol=1e-4)
            assert abs(pde[0][1] - pde[1][1]) <= TOL_METRICS * abs(pde[1][1]), pde
            continue
        bound = TOL_METRICS * (1.0 if "corr" in k else abs(want))
        assert abs(mega[k] - want) <= bound, (k, mega[k], want)
