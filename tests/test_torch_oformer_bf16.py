"""The OFormer in bf16 (`trainer.precision: bf16`) against the JAX package's
bf16 OFormer, on the CPU, from the same seeded non-zero parameters and
inputs.

K5 kv_dots and K6 apply_dots: the bf16 plain versions, and the vector-
Jacobian products of their autograd Functions, against the Pallas kernels
in interpret mode on the same bf16 inputs at (2, 2048, 128) (a kernel-
eligible shape). K5's fp32 output within 1e-5 of scale (bf16 products are
exact in fp32: the two sides differ in summation order only); K6's bf16
output within 1e-2 of scale at most and 1e-4 on average (both round one
fp32 sum to bf16, and differ where the sums' order flips a last bit); every
gradient of JAX's dtype, bf16 ones held as K6's output, fp32 ones as K5's.

Modules (RoPE, the token instance norm, LayerNorm, LinearAttention with one
and two heads, CrossLinearAttention, the encoder, the decoder at 1 and 3
steps): each against its flax module with `dtype=jnp.bfloat16`, within
2e-2 of scale at most, or within the stray of JAX's own bf16 module from
its fp32 module where that is larger (the encoder's four layers and
LayerNorms amplify bf16 rounding: JAX's bf16 encoder strays 0.12 of scale
from its fp32 one at the worst entry); and its gap to the JAX fp32 module
(mean |out - out32| / max |out32|) at most 1.5 times JAX bf16's gap.

Tasks (JAX's dropout masks injected): OformerTask's eval under JAX's
default route and its Pallas route (MCEDM_OFORMER_ATTN3=1) at 64 tokens, a
power of two, where the two routes' rounding of k^T v / n agrees (metrics
within 2e-2 relative, the prediction within 2e-2 of scale and under the
gap rule); three train steps of OformerTask and of OformerTimePredTask
(loss and gradient norm within 2e-2 relative; at the first step the
gradients' gap to JAX's fp32 gradients at most 1.5 times JAX bf16's, as
tests/test_torch_bf16_train.py holds it; params within 2 lr a step; master
params and AdamW moments fp32); OformerTimePredTask's eval; and one bf16
OformerStateTimePredTask.test_step (metrics within 2e-2 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.models import encoding as jenc
from m_cedm_tpu.models import oformer as jo
from m_cedm_tpu.tasks import oformer as jtasks
from m_cedm_tpu_torch import kernels
from m_cedm_tpu_torch.convert import jax_params_to_state_dict, jax_train_state_to_torch
from m_cedm_tpu_torch.data.oformer_data import tokenize_grid, tokenize_time_pred
from m_cedm_tpu_torch.kernels import PLAIN_OPS
from m_cedm_tpu_torch.kernels import linear_attention as tla
from m_cedm_tpu_torch.models import encoding as tenc
from m_cedm_tpu_torch.models import oformer as to
from m_cedm_tpu_torch.tasks import build_task
from m_cedm_tpu_torch.tasks.oformer import compute_params, fp32_param_names
from test_torch_oformer import (B, N, X, dec_cfgs, enc_cfgs, grid_pos, interpret,  # noqa: F401
                                load, node_types, randn, seeded)
from test_torch_oformer_task import STATS, fields
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF = jnp.bfloat16
TOL, TOL_MEAN, GAP_RATIO = 2e-2, 1e-4, 1.5
LEAF_GAP_RATIO, LEAF_COSINE = 3.0, 0.5  # per parameter, over a test's train steps
STEPS, N_HIST = 3, 4
RECON_TARGET = "m_cedm_tpu.tasks.OformerTask"
TIME_TARGET = "m_cedm_tpu.tasks.OformerTimePredTask"
STATE_TIME_TARGET = "m_cedm_tpu.tasks.OformerStateTimePredTask"


def f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def bf16_input(seed, *shape):
    """A seeded normal draw rounded to bf16: the same input on every side."""
    return torch.from_numpy(randn(seed, *shape)).bfloat16().float().numpy()


def scaled_err(got, want):
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = np.abs(got - want)
    return float(err.max()) / scale, float(err.mean()) / scale


def assert_bf16_close(got, want, name):
    """One rounding to bf16 apart: 1e-2 of scale at most, 1e-4 on average."""
    assert got.dtype == torch.bfloat16 and want.dtype == BF, name
    err, mean = scaled_err(got, want)
    assert err <= 1e-2 and mean <= TOL_MEAN, f"{name}: {err:.3e} max, {mean:.3e} mean"


def gap(a, ref) -> float:
    a, ref = f64(a), f64(ref)
    return float(np.abs(a - ref).mean() / np.abs(ref).max())


def hold_module(got, want16, want32, name):
    """The port's bf16 output against JAX's bf16 and fp32 modules (module
    docstring)."""
    err, _ = scaled_err(got, want16)
    stray, _ = scaled_err(want16, want32)
    assert err <= max(TOL, stray), f"{name}: {err:.3e} of scale (JAX's stray {stray:.3e})"
    assert gap(got, want32) <= GAP_RATIO * gap(want16, want32), (
        f"{name}: gap {gap(got, want32):.3e}, JAX bf16's {gap(want16, want32):.3e}")


# --- K5 / K6 -----------------------------------------------------------------

def test_bf16_kv_apply_match_pallas(interpret):
    la = interpret
    bh, n, d, e = 2, la._TN, 128, 128
    q, k, v = (bf16_input(s, bh, n, d) for s in (20, 21, 22))
    qj, kj, vj = (jnp.asarray(a).astype(BF) for a in (q, k, v))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    assert la._use_kernel(kj)
    dots_j = la.kv_dots(kj, vj)
    assert dots_j.dtype == jnp.float32
    err, _ = scaled_err(tla.kv_dots_plain(kt, vt), dots_j)
    assert err <= 1e-5
    factor = dots_j / n
    out_j = la.apply_dots(qj, factor)
    assert_bf16_close(tla.apply_dots_plain(qt, torch.from_numpy(np.asarray(factor))), out_j,
                      "apply_dots")
    assert_bf16_close(tla.apply_dots_plain(qt, torch.from_numpy(np.asarray(factor)).bfloat16()),
                      la.apply_dots(qj, factor.astype(BF)), "apply_dots, bf16 factor")

    cot_kv = randn(23, bh, d, e)
    cot_ap = jnp.asarray(bf16_input(24, bh, n, e)).astype(BF)
    want = (jax.vjp(la.kv_dots, kj, vj)[1](jnp.asarray(cot_kv))
            + jax.vjp(la.apply_dots, qj, factor)[1](cot_ap))
    leaves = [a.clone().requires_grad_() for a in (kt, vt, qt)]
    leaves.append(torch.from_numpy(np.asarray(factor)).requires_grad_())
    got = (torch.autograd.grad(tla.kv_dots(*leaves[:2]), leaves[:2], torch.from_numpy(cot_kv))
           + torch.autograd.grad(tla.apply_dots(*leaves[2:]), leaves[2:],
                                 torch.from_numpy(np.asarray(cot_ap.astype(jnp.float32))
                                                  ).bfloat16()))
    for name, g_t, g_j in zip(("dk", "dv", "dq", "ddots"), got, want):
        assert str(g_t.dtype).split(".")[-1] == str(g_j.dtype), name
        if g_t.dtype == torch.bfloat16:
            assert_bf16_close(g_t, g_j, name)
        else:
            assert scaled_err(g_t, g_j)[0] <= 1e-5, name


# --- modules -----------------------------------------------------------------

def port_bf16(tm, *args):
    """The port's module on params rounded as the bf16 task rounds them."""
    params = compute_params(dict(tm.named_parameters()), fp32_param_names(tm),
                            torch.bfloat16)
    return functional_call(tm, {**params, **dict(tm.named_buffers())}, args)


def to_t(a, bf16=False):
    t = torch.from_numpy(np.array(a))
    return t.bfloat16() if bf16 else t


def test_rope_and_instance_norm_match_jax_bf16():
    coords = np.random.RandomState(0).rand(2, 10).astype(np.float32) * 5
    freqs = [np.broadcast_to(np.asarray(jenc.rotary_freqs(jnp.asarray(c), 16, 1 / 8, 16.0))
                             [:, None], (2, 3, 10, 16)) for c in (coords, coords[::-1])]
    t = bf16_input(1, 2, 3, 10, 32)
    rope = lambda a: jenc.apply_rotary_pos_emb_multi(a, [jnp.asarray(f) for f in freqs])
    got = tenc.apply_rotary_pos_emb_multi(to_t(t, True), [to_t(f) for f in freqs])
    assert got.dtype == torch.bfloat16
    hold_module(got, rope(jnp.asarray(t).astype(BF)), rope(jnp.asarray(t)), "rope")
    x = bf16_input(5, 2, 3, 10, 16) * 2 + 0.5
    got = to.instance_norm_tokens(to_t(x, True))
    assert got.dtype == torch.bfloat16
    hold_module(got, jo.instance_norm_tokens(jnp.asarray(x).astype(BF)),
                jo.instance_norm_tokens(jnp.asarray(x)), "instance norm")


def test_layer_norm_matches_flax_bf16():
    import flax.linen as nn

    x = bf16_input(2, B, N, 32) * 3 + 1
    variables = seeded(nn.LayerNorm().init(jax.random.PRNGKey(0), x), 7)
    tm = to.LayerNorm(32)
    tm.load_state_dict(jax_params_to_state_dict(variables))
    got = port_bf16(tm, to_t(x, True))
    assert got.dtype == torch.bfloat16 and tm.weight.dtype == torch.float32
    hold_module(got, nn.LayerNorm(dtype=BF).apply(variables, jnp.asarray(x).astype(BF)),
                nn.LayerNorm().apply(variables, x), "LayerNorm")


@pytest.mark.parametrize("heads,dim_head", [(1, 32), (2, 16)],
                         ids=["one-head-no-to_out", "two-heads"])
def test_linear_attention_matches_jax_bf16(heads, dim_head):
    pos, x = grid_pos(), bf16_input(6, B, N, 32)
    mk = lambda dt: jo.LinearAttention(32, "galerkin", heads=heads, dim_head=dim_head,
                                       relative_emb=True, scale=16.0, relative_emb_dim=2,
                                       min_freq=1 / X, dtype=dt)
    variables = seeded(mk(None).init(jax.random.PRNGKey(0), x, pos), 1)
    tm = load(to.LinearAttention(32, heads, dim_head, PLAIN_OPS, scale=16.0,
                                 relative_emb_dim=2, min_freq=1 / X), variables)
    got = port_bf16(tm, to_t(x, True), to_t(pos))
    hold_module(got, mk(BF).apply(variables, jnp.asarray(x).astype(BF), pos),
                mk(None).apply(variables, x, pos), f"LinearAttention {heads}")


def test_cross_linear_attention_matches_jax_bf16():
    pos, x, z = grid_pos(), bf16_input(7, B, N, 32), bf16_input(8, B, N, 32)
    mk = lambda dt: jo.CrossLinearAttention(32, "galerkin", heads=4, dim_head=32,
                                            relative_emb=True, scale=32.0,
                                            relative_emb_dim=2, min_freq=1 / X, dtype=dt)
    variables = seeded(mk(None).init(jax.random.PRNGKey(0), x, z, pos, pos), 2)
    tm = load(to.CrossLinearAttention(32, 32, 4, 32, PLAIN_OPS, 32.0, 2, 1 / X), variables)
    got = port_bf16(tm, to_t(x, True), to_t(z, True), to_t(pos), to_t(pos))
    hold_module(got, mk(BF).apply(variables, jnp.asarray(x).astype(BF),
                                  jnp.asarray(z).astype(BF), pos, pos),
                mk(None).apply(variables, x, z, pos, pos), "CrossLinearAttention")


def test_encoder_matches_jax_bf16():
    jcfg, tcfg = enc_cfgs()
    x, nt, pos = bf16_input(10, B, 1, N, 3), node_types(), grid_pos()
    variables = seeded(jo.IrregSTEncoder(jcfg).init(jax.random.PRNGKey(0), x, nt, pos), 4)
    tm = load(to.IrregSTEncoder(tcfg, PLAIN_OPS), variables)
    got = port_bf16(tm, to_t(x, True), to_t(nt), to_t(pos))
    assert got.dtype == torch.bfloat16
    hold_module(got, jo.IrregSTEncoder(jcfg, dtype=BF).apply(
        variables, jnp.asarray(x).astype(BF), nt, pos),
        jo.IrregSTEncoder(jcfg).apply(variables, x, nt, pos), "encoder")


@pytest.mark.parametrize("steps", [1, 3])
def test_decoder_matches_jax_bf16(steps):
    jcfg, tcfg = dec_cfgs()
    z, nt, pos = bf16_input(11, B, N, 32), node_types(), grid_pos()
    variables = seeded(jo.IrregSTDecoder(jcfg).init(jax.random.PRNGKey(0), z, pos, nt,
                                                    steps, pos), 5)
    tm = load(to.IrregSTDecoder(tcfg, 32, PLAIN_OPS), variables)
    got = port_bf16(tm, to_t(z, True), to_t(pos), to_t(nt), steps, to_t(pos))
    assert got.dtype == torch.float32 and got.shape == (B, steps, N, 1)
    hold_module(got, jo.IrregSTDecoder(jcfg, dtype=BF).apply(
        variables, jnp.asarray(z).astype(BF), pos, nt, steps, pos),
        jo.IrregSTDecoder(jcfg).apply(variables, z, pos, nt, steps, pos), f"decoder {steps}")


# --- tasks -------------------------------------------------------------------

def hparams(input_channels=3, out_channels=1, dtype=None):
    hp = {"name": "oformer_t", "time_history": 8,
          "encoder": {"input_channels": input_channels, "time_window": 1, "in_emb_dim": 32,
                      "out_channels": 32, "max_node_type": 2, "heads": 1, "depth": 4,
                      "res": X, "use_ln": True, "emb_dropout": 0.0, "relative_emb_dim": 2},
          "decoder": {"max_node_type": 2, "latent_channels": 32,
                      "out_channels": out_channels, "res": X, "scale": 2, "dropout": 0.1,
                      "relative_emb_dim": 2},
          "norm_shape": [], "loss": "mse", "lr": 1e-3, "weight_decay": 1e-4,
          "curriculum_steps": 8, "curriculum_ratio": 0.2}
    if dtype:
        hp["dtype"] = dtype
    return hp


TIME_HP = functools.partial(hparams, 4, 2)


def batch_of(target, seed):
    """(batch, stats): the reconstruction's 64 tokens, or the time
    prediction's 32 + 32 (8 x 8 grid split at N_HIST)."""
    if target == RECON_TARGET:
        tok = tokenize_grid(*fields(seed), STATS)
        return tuple(np.ascontiguousarray(tok[k]) for k in
                     ("x", "y", "node_type", "pos", "n_time")), STATS
    h, u, x, t = fields(seed)
    stats = {"input_mean": h.mean(), "input_std": h.std(),
             "target_mean": u.mean(), "target_std": u.std()}
    tok = tokenize_time_pred(h, u, x, t, stats, N_HIST)
    return tuple(np.ascontiguousarray(tok[k]) for k in (
        "x", "y", "node_type_inp", "node_type_prop", "input_pos", "prop_pos", "n_time")), stats


JAX_CLASSES = {RECON_TARGET: jtasks.OformerTask, TIME_TARGET: jtasks.OformerTimePredTask}
HPARAMS = {RECON_TARGET: hparams, TIME_TARGET: TIME_HP}


@functools.lru_cache(maxsize=None)
def _init_variables(target):
    return JAX_CLASSES[target](to_dotdict(HPARAMS[target]()))._init_variables(
        jax.random.PRNGKey(0))


def jax_task(target, dtype=None, **kw):
    jtask = JAX_CLASSES[target](to_dotdict(HPARAMS[target](dtype=dtype)), **kw)
    jtask._init_variables = lambda rng: _init_variables(target)
    return jtask


def jax_state(jtask, stats, seed):
    state = jtask.init_state(jax.random.PRNGKey(seed), stats)
    params = seeded(state.params, seed)
    return state.replace(params=params, opt_state=jtask.tx.init(params))


def port_state(task, stats, jstate):
    return task.init_state(None, stats, **jax_train_state_to_torch(jstate))


def torch_batch(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


def hold_scalar(got, want16, want32, name, scale=None):
    """Within 2e-2 of JAX's bf16 value, relative (of `scale` where given);
    or, where JAX's bf16 value itself strays further than that from JAX's
    fp32 value, no farther from the fp32 value than 1.5 times that stray."""
    got, want16, want32 = float(got), float(want16), float(want32)
    scale = abs(want16) if scale is None else scale
    stray = abs(want16 - want32)
    assert (abs(got - want16) <= TOL * scale
            or (stray > TOL * scale and abs(got - want32) <= GAP_RATIO * stray)), (
        f"{name}: port {got}, JAX bf16 {want16}, JAX fp32 {want32}")


def assert_metrics(got, want16, want32):
    assert sorted(got) == sorted(want16) == sorted(want32)
    for k in want16:
        hold_scalar(got[k], want16[k], want32[k], k,
                    1.0 if k.endswith("corr") else None)  # a correlation: of scale 1


@pytest.mark.parametrize("route", ["xla", "1"], ids=["default-route", "pallas-route"])
def test_oformer_eval_matches_jax_bf16(monkeypatch, route):
    monkeypatch.setenv("MCEDM_OFORMER_ATTN3", route)
    batch, stats = batch_of(RECON_TARGET, 1)
    j16, j32 = jax_task(RECON_TARGET, "bfloat16"), jax_task(RECON_TARGET)
    assert j16.compute_dtype == BF
    jstate = jax_state(j32, stats, 0)
    task = build_task(hparams(dtype="bfloat16"), "cpu", target=RECON_TARGET)
    assert task.compute_dtype == torch.bfloat16
    out = {}
    for name, t in (("j16", j16), ("j32", j32), ("port", task)):
        t.set_pde_loss_function("swe_per", False)
        out[name] = (t.eval_step(port_state(t, stats, jstate), torch_batch(batch),
                                 split="val") if t is task
                     else t.eval_step(jstate, tuple(map(jnp.asarray, batch)), split="val"))
    assert len(out["port"][0]) == 7
    assert_metrics(out["port"][0], out["j16"][0], out["j32"][0])
    grid, grid16, grid32 = (out[k][1] for k in ("port", "j16", "j32"))
    assert grid.dtype == torch.float32
    hold_module(grid, grid16, grid32, "prediction")


@functools.lru_cache(maxsize=None)
def jax_step_fns(jtask):
    """Jitted for one JAX task, its `_train_impl` in two halves: the loss
    of its loss_fn (one forward step) with the keep mask its dropout draws
    from the key (the nn.Dropout output read back) and the gradients; then
    its optimizer's update."""
    import flax.linen as nn

    def loss_fn(params, state, batch, key):
        seen = []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout):
                seen.append(out)
            return out

        x, y, *tokens = jtask._unpack(batch)
        y_norm, _ = jtask._pair_target(state, y[:, :1])
        with nn.intercept_methods(capture):
            pred = jtask.model.apply(params, x, *tokens, 1, deterministic=False,
                                     rngs={"dropout": key})
        (dropped,) = seen
        return jtask._criterion(pred, y_norm), dropped != 0

    def update(state, grads):
        updates, opt_state = jtask.tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params, updates),
                             opt_state=opt_state, step=state.step + 1)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), jax.jit(update)


def jax_grads(jtask, jstate, batch, key):
    """Loss, keep mask and gradients of JAX's train step, as numpy arrays,
    the gradients by the port's parameter names."""
    (loss, keep), grads = jax_step_fns(jtask)[0](jstate.params, jstate,
                                                 tuple(map(jnp.asarray, batch)), key)
    return (float(loss), np.array(keep),
            {k: v.numpy() for k, v in jax_params_to_state_dict(grads).items()})


def jax_train_step(jtask, jstate, batch, key):
    """JAX's train_step (`_train_impl`) from its two jitted halves."""
    _, grads = jax_step_fns(jtask)[0](jstate.params, jstate, tuple(map(jnp.asarray, batch)),
                                      key)
    return jax_step_fns(jtask)[1](jstate, grads)


def port_grads(task, state, batch, keep):
    """The port's train-step gradients (train_step's loss_fn), fp32."""
    x, y, *tokens = task._unpack(batch)
    y_norm, _ = task._pair_target(state, y[:, :1])
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    pred = task.apply(state, params, x, *tokens, 1, keep)
    grads = torch.autograd.grad(task._criterion(pred, y_norm), list(params.values()))
    return {k: g.numpy() for k, g in zip(params, grads)}


def grads_gap(grads, ref) -> float:
    return float(np.mean([np.abs(grads[k].astype(np.float64) - ref[k]).mean()
                          / np.abs(ref[k]).max() for k in ref]))


def cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def hold_leaves(port, g16, g32):
    """Each parameter's gradients over the steps (lists, one array a step):
    their gap to JAX's fp32 ones (mean over the steps of mean |g - g32| /
    max |g32|) at most LEAF_GAP_RATIO times JAX bf16's on the same leaf,
    and their cosine with JAX's fp32 ones, all steps as one vector, at
    least LEAF_COSINE. One leaf's bf16 gradient is noisy at this width
    (JAX bf16's own cosine with fp32 falls to 0.75 on some leaf, and the
    port's and JAX bf16's gap ratio reaches 2.4, in ten draws of both
    tasks), but a leaf whose gradient is zero, of the wrong sign or of the
    wrong size fails one rule or both, whatever the other leaves do."""
    for k in g32:
        gaps = [np.mean([np.abs(g[i].astype(np.float64) - g32[k][i]).mean()
                         / np.abs(g32[k][i]).max() for i in range(STEPS)])
                for g in (port[k], g16[k])]
        assert gaps[0] <= LEAF_GAP_RATIO * gaps[1], (k, gaps)
        cos = cosine(np.concatenate([g.ravel() for g in port[k]]),
                     np.concatenate([g.ravel() for g in g32[k]]))
        assert cos >= LEAF_COSINE, (k, cos)


@pytest.mark.parametrize("target", [RECON_TARGET, TIME_TARGET], ids=["recon", "time-pred"])
def test_train_steps_match_jax_bf16(target):
    """Three bf16 steps at the constant lr from one converted state, each
    with JAX's dropout mask. Each step is held alone, from JAX's state
    before it: a bf16 step moves the params by about lr whatever the
    gradient, so the two trajectories part, and a loss along them compares
    two states. Each step's loss within 2e-2 of JAX bf16's, relative. One
    step's gradients are one draw of bf16 rounding noise: their gap to
    JAX's fp32 gradients over JAX bf16's ranges over 0.5 to 1.8 in 18 steps
    of three draws of this model, and JAX bf16's gradient norm strays up to
    a third from its fp32 step's. So the gradients are held on the mean
    over the three steps: their gap, and their norm's relative distance
    from JAX's fp32 step's, each at most 1.5 times JAX bf16's; and each
    leaf alone (hold_leaves: over these three steps the port's per-leaf
    gap ratio is at most 1.28 for the reconstruction and 1.63 for the time
    prediction, and its cosine with JAX's fp32 gradient at least 0.977 and
    0.913). The trajectory's params are held after the three steps."""
    batch, stats = batch_of(target, 3)
    j16, j32 = jax_task(target, "bfloat16"), jax_task(target)
    jstate = jax_state(j16, stats, 2)
    task = build_task(HPARAMS[target](dtype="bfloat16"), "cpu", target=target)
    state = port_state(task, stats, jstate)
    tbatch = torch_batch(batch)
    lr = task.lr
    norm = lambda g: np.sqrt(sum(np.sum(np.square(v.astype(np.float64))) for v in g.values()))
    gaps, norms = [], []
    leaves = {name: {} for name in ("port", "g16", "g32")}
    for step in range(STEPS):
        key = jax.random.PRNGKey(30 + step)
        loss16, keep16, g16 = jax_grads(j16, jstate, batch, key)
        loss32, keep32, g32 = jax_grads(j32, jstate, batch, key)
        assert np.array_equal(keep16, keep32)
        keep = torch.from_numpy(keep16)
        start = port_state(task, stats, jstate)
        g_port = port_grads(task, start, tbatch, keep)
        assert sorted(g_port) == sorted(g16)
        assert all(g.dtype == np.float32 for g in g_port.values())
        gaps.append((grads_gap(g_port, g32), grads_gap(g16, g32)))
        for name, grads in (("port", g_port), ("g16", g16), ("g32", g32)):
            for k, g in grads.items():
                leaves[name].setdefault(k, []).append(g)
        alone, m_alone = task.train_step(start, tbatch, dropout_keep=keep)
        jstate = jax_train_step(j16, jstate, batch, key)
        state, _ = task.train_step(state, tbatch, dropout_keep=keep)
        hold_scalar(m_alone["train_loss"], loss16, loss32, f"step {step} loss")
        norms.append((abs(float(m_alone["grad_norm"]) / norm(g32) - 1),
                      abs(norm(g16) / norm(g32) - 1)))
        want = jax_train_state_to_torch(jstate)
        for k, p in want["params"].items():
            assert float((alone.params[k] - p).abs().max()) <= 2 * lr, (step, k)
    port_gap, jax_gap = np.mean(gaps, axis=0)
    assert port_gap <= GAP_RATIO * jax_gap, gaps
    port_dev, jax_dev = np.mean(norms, axis=0)
    assert port_dev <= GAP_RATIO * jax_dev, norms
    hold_leaves(leaves["port"], leaves["g16"], leaves["g32"])
    assert state.step == want["step"] == STEPS
    for k, p in want["params"].items():
        assert float((state.params[k] - p).abs().max()) <= 2 * lr * STEPS, k
        assert state.params[k].dtype == torch.float32, k
        for mom in ("mu", "nu"):
            assert state.opt_state[mom][k].dtype == torch.float32, (mom, k)


def test_time_pred_eval_matches_jax_bf16():
    batch, stats = batch_of(TIME_TARGET, 4)
    j16, j32 = jax_task(TIME_TARGET, "bfloat16"), jax_task(TIME_TARGET)
    jstate = jax_state(j16, stats, 5)
    jax_state(j32, stats, 5)  # j32's per-state normalizers of the PDE residual
    task = build_task(TIME_HP(dtype="bfloat16"), "cpu", target=TIME_TARGET)
    for t in (j16, j32, task):
        t.set_pde_loss_function("swe_per", False)
    (m16, grid16), (m32, grid32) = (t.eval_step(jstate, tuple(map(jnp.asarray, batch)),
                                                split="val") for t in (j16, j32))
    m_t, grid_t = task.eval_step(port_state(task, stats, jstate), torch_batch(batch),
                                 split="val")
    assert len(m_t) == 7
    assert_metrics(m_t, m16, m32)
    hold_module(grid_t, grid16, grid32, "prediction")


@functools.lru_cache(maxsize=None)
def _jit_test_step(jt, n_time):
    """jt.test_step jitted, the batches' n_time (read as Python ints by
    test_step) held as constants."""
    n_r, n_t = (np.array(n) for n in n_time)
    return jax.jit(lambda s1, s2, rb, tb: jt.test_step(s1, s2, (*rb, n_r), (*tb, n_t)))


def jax_test_step(jt, rbatch, tbatch):
    """JAX's two-stage test_step on these batches, as a function of the two
    states, compiled once for every draw of the same grid."""
    fn = _jit_test_step(jt, (tuple(rbatch[-1]), tuple(tbatch[-1])))
    return lambda s1, s2: fn(s1, s2, tuple(map(jnp.asarray, rbatch[:-1])),
                             tuple(map(jnp.asarray, tbatch[:-1])))


def test_state_time_pred_test_step_matches_jax_bf16():
    """Both stages in bf16 (each from its own hparams' dtype), from two
    converted states, over four draws of states and fields, against JAX's
    test_step jitted (compiled once for the four): the two chained models
    amplify bf16 rounding, and one draw's deviation is noise (JAX's own
    bf16 test_step strays up to 24 % of scale from its fp32 one at the
    worst entry, and its mean gap ranges over 0.013 to 0.041 of scale
    across draws). Held: each metric within 5e-2 relative of JAX bf16's in
    every draw and 2e-2 on average over the draws; the prediction's gap to
    JAX's fp32 one, averaged over the draws, at most 1.5 times JAX bf16's."""
    def hp(dtype):
        return {"hparams_state": hparams(dtype=dtype), "hparams_time": TIME_HP(dtype=dtype),
                "time_history": N_HIST}

    j16, j32 = (jtasks.OformerStateTimePredTask(to_dotdict(hp(d))) for d in ("bfloat16", None))
    task = build_task(hp("bfloat16"), "cpu", target=STATE_TIME_TARGET)
    assert task.model_state.compute_dtype == task.model_time.compute_dtype == torch.bfloat16
    devs, gaps = [], []
    for draw in range(4):
        rbatch, rstats = batch_of(RECON_TARGET, 6 + draw)
        tbatch, tstats = batch_of(TIME_TARGET, 6 + draw)
        states = []
        for jt, target, stats, seed in ((j16.model_state, RECON_TARGET, rstats, 7 + 2 * draw),
                                        (j16.model_time, TIME_TARGET, tstats, 8 + 2 * draw)):
            jt._init_variables = lambda rng, target=target: _init_variables(target)
            states.append(jax_state(jt, stats, seed))
        (m16, pred16), (m32, pred32) = (jax_test_step(jt, rbatch, tbatch)(*states)
                                        for jt in (j16, j32))
        m_t, pred_t = task.test_step(port_state(task.model_state, rstats, states[0]),
                                     port_state(task.model_time, tstats, states[1]),
                                     torch_batch(rbatch), torch_batch(tbatch))
        assert sorted(m_t) == sorted(m16) == ["test_mae_un", "test_mae_un_pred",
                                              "test_mae_un_rec"]
        assert pred_t.dtype == torch.float32
        devs.append([abs(float(m_t[k]) / float(m16[k]) - 1) for k in sorted(m16)])
        assert max(devs[-1]) <= 5e-2, (draw, m_t, m16)
        gaps.append((gap(pred_t, pred32), gap(pred16, pred32)))
    assert np.mean(devs, axis=0).max() <= TOL, devs
    port_gap, jax_gap = np.mean(gaps, axis=0)
    assert port_gap <= GAP_RATIO * jax_gap, gaps


def test_kernel_wrappers_on_cpu_launch_nothing_in_bf16():
    kernels.reset_launches()
    task = build_task(hparams(dtype="bfloat16"), "cpu", target=RECON_TARGET)
    state = task.init_state(torch.Generator().manual_seed(0), STATS)
    batch, _ = batch_of(RECON_TARGET, 9)
    task.train_step(state, torch_batch(batch), torch.Generator().manual_seed(1))
    assert not any(kernels.launches().values())
