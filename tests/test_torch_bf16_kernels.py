"""The bf16 plain versions of K1, K2/K3, the narrow conv and K4 against the
Pallas kernels in interpret mode on the same bf16 inputs (about 25 s in one
process, most of it the interpret-mode kernels).

On a bf16 network the Pallas kernels round at fixed points: K1 sums the
upcast input in fp32 and rounds once at its store; K2/K3 run GroupNorm and
SiLU in fp32, round the activation to bf16 before the product, sum bf16
products in fp32 with the fp32 bias and the residual, emit statistics from
the fp32 sums, and round the output once; K4 computes in fp32 and rounds its
output once. The port's bf16 kernels round at those points, and their plain
versions (what the wrappers run on the CPU) are held here. The out conv has
no Pallas kernel of its own (the JAX U-Net runs an XLA conv): it is held to
the linear mode of the Pallas K2 (`_pallas_gnsc(act=False)`), whose function
the narrow kernel replaces.

Inputs come from numpy with a seed and are rounded to bf16 before they go to
both sides. Tolerances: the two sides differ by fp32 summation order and
the one-ulp flips that order causes at a bf16 rounding, so a bf16 output is
held to 1e-2 of its scale (max |a|) at most and 1e-4 of it on average; the
emitted fp32 statistics to 1e-5 of their scale. A wrapper's kernel launch
refuses a mix of dtypes other than bf16 activations with fp32 vectors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import _launch
from m_cedm_tpu_torch.kernels import fused_attention as tfa
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, RES, C, G = 2, 16, 32, 8
EPS = 1e-5
TOL_MAX, TOL_MEAN, TOL_STATS = 1e-2, 1e-4, 1e-5


@pytest.fixture
def interpret(monkeypatch):
    """Force the Pallas kernels on and run them in interpret mode (CPU)."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    for mod in (jfn, jfnc, jfa):
        monkeypatch.setattr(mod.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfn, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jfnc, "pallas_enabled", lambda: True)


def bf16(rs, *shape, scale=1.0, shift=0.0):
    """A bf16-rounded numpy draw, as fp32 (both sides take it as bf16)."""
    a = (rs.randn(*shape) * scale + shift).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def tb(a):  # torch bf16
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def jb(a):  # jax bf16
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def held(got, want, stats=False):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    scale = float(np.abs(want).max())
    if stats:
        assert err.max() <= TOL_STATS * scale, err.max() / scale
    else:
        assert err.max() <= TOL_MAX * scale, err.max() / scale
        assert err.mean() <= TOL_MEAN * scale, err.mean() / scale


def fold(rs, c):
    return ((1.0 + 0.3 * rs.randn(B, c)).astype(np.float32),
            (0.3 * rs.randn(B, c)).astype(np.float32))


def sums_of(x):
    """fp32 channel sums of an NHWC or (B, N, C) array, over all pixels."""
    x = np.asarray(x, np.float64).reshape(B, -1, x.shape[-1])
    return x.sum(1).astype(np.float32), (x * x).sum(1).astype(np.float32)


# --- K1 ---------------------------------------------------------------------

def test_k1_stats_match_pallas(interpret):
    x = bf16(np.random.RandomState(1), B, RES * RES, C, scale=0.8, shift=0.2)
    want = jfn._compute_stats(jb(x), RES * RES // 2)
    got = tfn.channel_stats(tb(x))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        held(g_, w_, stats=True)


@pytest.mark.parametrize("chained", [True, False], ids=["chained", "own_stats"])
def test_k1_apply_matches_pallas(interpret, chained):
    rs = np.random.RandomState(2)
    x = bf16(rs, B, RES * RES, C, scale=0.8, shift=0.2)
    gamma, beta = fold(rs, C)
    stats = sums_of(x) if chained else None
    want = jfn._pallas_forward(jb(x), jnp.asarray(gamma), jnp.asarray(beta), G, EPS,
                               RES * RES, stats=None if stats is None else
                               tuple(map(jnp.asarray, stats)))[0]
    got = tfn.gn_silu(tb(x), torch.from_numpy(gamma), torch.from_numpy(beta), G, EPS,
                      stats=None if stats is None else tuple(map(torch.from_numpy, stats)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    held(got, want)


# --- K2 / K3 ------------------------------------------------------------------

K2_MODES = {
    "identity_chained": dict(res="identity", chained=True),
    "identity_emit": dict(res="identity", emit=True),
    "identity_up_emit": dict(res="identity_up", emit=True),
    "proj_concat_emit": dict(res="proj", cr=2 * C, emit=True),
    "concat_input_emit": dict(c=2 * C, emit=True),
    "linear_emit": dict(act=False, emit=True, res_hw=RES // 2),
}


@pytest.mark.parametrize("mode", list(K2_MODES))
def test_k2_matches_pallas(interpret, mode):
    m = K2_MODES[mode]
    rs = np.random.RandomState(10 + list(K2_MODES).index(mode))
    c, o, r = m.get("c", C), C, m.get("res_hw", RES)
    act = m.get("act", True)
    x = bf16(rs, B, r, r, c, scale=0.8, shift=0.2)
    gamma, beta = fold(rs, c)
    w = bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c))
    bias = (0.3 * rs.randn(o)).astype(np.float32)
    stats = sums_of(x) if m.get("chained") else None
    jkw, tkw = {}, {}
    res = m.get("res")
    if res == "identity":
        resid = bf16(rs, B, r, r, o)
        jkw, tkw = dict(residual=jb(resid)), dict(residual=tb(resid))
    elif res == "identity_up":
        resid = bf16(rs, B, r // 2, r // 2, o)
        jkw, tkw = dict(residual=jb(resid)), dict(residual=tb(resid), res_up=True)
    elif res == "proj":
        cr = m["cr"]
        resid = bf16(rs, B, r, r, cr)
        skw = bf16(rs, cr, o, scale=1.0 / np.sqrt(cr))
        skb = (0.3 * rs.randn(o)).astype(np.float32)
        jkw = dict(residual=jb(resid), skip_w=jb(skw), skip_b=jnp.asarray(skb))
        tkw = dict(residual=tb(resid), skip_w=tb(skw), skip_b=torch.from_numpy(skb))
    emit = m.get("emit", False)
    want = jfnc._pallas_gnsc(
        jb(x), jnp.asarray(gamma) if act else None, jnp.asarray(beta) if act else None,
        jb(w), jnp.asarray(bias), G if act else 1, EPS, res_mode=res or "none",
        emit_stats=emit, act=act,
        stats=None if stats is None else tuple(map(jnp.asarray, stats)), **jkw)
    got = tfnc.gn_silu_conv(
        tb(x), torch.from_numpy(gamma) if act else None,
        torch.from_numpy(beta) if act else None, tb(w), torch.from_numpy(bias),
        G if act else 0, EPS, emit_stats=emit,
        stats=None if stats is None else tuple(map(torch.from_numpy, stats)), **tkw)
    if emit:
        (got, gstats), (want, *wstats) = got, want
        for g_, w_ in zip(gstats, wstats):
            held(g_, w_, stats=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    held(got, want)


def test_k3_matches_pallas(interpret):
    """K3 with chained statistics and emit_stats against the paired up
    kernel (_pallas_gnsc_up_pair), the one that emits statistics."""
    rs = np.random.RandomState(20)
    x = bf16(rs, B, RES // 2, RES // 2, C, scale=0.8, shift=0.2)
    gamma, beta = fold(rs, C)
    w = bf16(rs, 3, 3, C, C, scale=1.0 / np.sqrt(9 * C))
    bias = (0.3 * rs.randn(C)).astype(np.float32)
    stats = sums_of(x)
    outp, s, ss = jfnc._pallas_gnsc_up_pair(
        jb(x), jnp.asarray(gamma), jnp.asarray(beta), jb(w), jnp.asarray(bias), G, EPS,
        stats=tuple(map(jnp.asarray, stats)), emit_stats=True)
    got, (gs, gss) = tfnc.gn_silu_up_conv(
        tb(x), torch.from_numpy(gamma), torch.from_numpy(beta), tb(w),
        torch.from_numpy(bias), G, EPS, stats=tuple(map(torch.from_numpy, stats)),
        emit_stats=True)
    held(got, jfnc.unpair_array(outp))
    for g_, w_ in ((gs, s), (gss, ss)):
        held(g_, np.asarray(w_)[:, :C] + np.asarray(w_)[:, C:], stats=True)


def test_conv_in_matches_fused_block_paired(interpret):
    rs = np.random.RandomState(21)
    x = bf16(rs, B, RES, RES, 4)
    w = bf16(rs, 3, 3, 4, 64, scale=1.0 / 6.0)
    bias = (0.3 * rs.randn(64)).astype(np.float32)
    outp, sums, sumsq = jfnc.fused_block_paired(
        jfnc.pair_array(jb(x)), None, None, jb(w), jnp.asarray(bias), 1, act=False,
        emit_stats=True)
    got, (gs, gss) = tfnc.narrow_conv(tb(x), tb(w), torch.from_numpy(bias),
                                      emit_stats=True)
    assert got.dtype == torch.bfloat16
    held(got, jfnc.unpair_array(outp))
    held(gs, sums, stats=True)
    held(gss, sumsq, stats=True)


@pytest.mark.parametrize("o", [1, 2])
def test_out_conv_matches_pallas_linear_mode(interpret, o):
    rs = np.random.RandomState(22 + o)
    y = bf16(rs, B, RES, RES, 64, scale=0.8)
    w = bf16(rs, 3, 3, 64, o, scale=1.0 / 24.0)
    bias = (0.3 * rs.randn(o)).astype(np.float32)
    want = jfnc._pallas_gnsc(jb(y), None, None, jb(w), jnp.asarray(bias), 1, EPS,
                             act=False)
    got = tfnc.narrow_conv(tb(y), tb(w), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    held(got, want)


# --- K4 ---------------------------------------------------------------------

def test_k4_matches_pallas(interpret):
    rs = np.random.RandomState(30)
    q, k, v = (bf16(rs, 2, 64, 64) for _ in range(3))
    want = jfa._pallas_fwd(jb(q), jb(k), jb(v))
    got = tfa.attention(tb(q), tb(k), tb(v))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    held(got, want)


# --- dtype checks of the kernel launches --------------------------------------

def _mixed_calls():
    x, w = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16), torch.zeros(3, 3, 16, 16)
    v = torch.zeros(1, 16)
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    return {
        "K1 apply, bf16 gamma": lambda: tfn._gn_silu_kernel(
            x.reshape(1, 64, 16), v.bfloat16(), v, v, v, 4, EPS),
        "K2, fp32 weight": lambda: tfnc._gn_silu_conv_kernel(
            x, v, v, w, None, 4, EPS, (v, v), None, False, None, None, False),
        "K2, bf16 bias": lambda: tfnc._gn_silu_conv_kernel(
            x, v, v, w.bfloat16(), torch.zeros(16, dtype=torch.bfloat16), 4, EPS,
            (v, v), None, False, None, None, False),
        "K2, fp32 residual": lambda: tfnc._gn_silu_conv_kernel(
            x, v, v, w.bfloat16(), None, 4, EPS, (v, v), x.float(), False, None,
            None, False),
        "K3, fp32 weight": lambda: tfnc._gn_silu_up_conv_kernel(
            x, v, v, w, None, 4, EPS, (v, v), False),
        "narrow, fp32 weight": lambda: tfnc._narrow_conv_kernel(
            x[..., :4].contiguous(), w[:, :, :4].contiguous(), None, False),
        "K4, fp32 key": lambda: tfa.attention_fwd(q, q.float(), q),
    }


@pytest.mark.parametrize("case", list(_mixed_calls()))
def test_kernel_launch_refuses_mixed_dtypes(case):
    """The checks run before any library is loaded, so they run here."""
    with pytest.raises(ValueError, match="must be|float32 or bfloat16"):
        _mixed_calls()[case]()


def test_act_dtype():
    assert _launch.act_dtype(torch.zeros(1)) == torch.float32
    assert _launch.act_dtype(torch.zeros(1, dtype=torch.bfloat16)) == torch.bfloat16
    with pytest.raises(ValueError):
        _launch.act_dtype(torch.zeros(1, dtype=torch.float16))
