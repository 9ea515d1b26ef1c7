"""Port parity of the four backward kernels' plain versions (K1 GroupNorm+SiLU,
K2 norm+conv block tail in every mode, K3 norm+upsample+conv, K4 attention)
against the JAX package's Pallas backward kernels, run in interpret mode as
tests/test_pallas.py runs them, and against jax.vjp of the JAX reference
compositions; plus the autograd.Function plumbing on the CPU (float64
gradcheck, zero cotangents for chained statistics).

Tolerance: every gradient to 1e-5 of its largest magnitude (`_close`). Both
sides are fp32 and differ in summation order only (weight gradients sum a
few hundred pixels), and the JAX kernels fold the variance as E[x^2] -
mean^2 where the plain versions take it two-pass; an elementwise relative
bound would mean nothing for entries of a sum that cancel to near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import fused_attention as tfa
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
EPS = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


@pytest.fixture
def interpret(monkeypatch):
    """Force the Pallas kernels on and run them in interpret mode (CPU),
    unpaired, as tests/test_pallas.py does."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    monkeypatch.setattr(jfn.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfnc.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfa.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfn, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jfnc, "pallas_enabled", lambda: True)
    monkeypatch.setenv("MCEDM_PAIR", "0")


class _Inputs:
    """Seeded numpy inputs and cotangents for one norm+conv call."""

    def __init__(self, seed, b=2, h=16, w=16, c=32, o=32, cr=48):
        rs = np.random.RandomState(seed)
        f = lambda *s, sc=1.0, sh=0.0: (rs.randn(*s) * sc + sh).astype(np.float32)
        self.x = f(b, h, w, c, sc=0.8, sh=0.3)
        self.gamma = f(b, c, sc=0.3, sh=1.0)
        self.beta = f(b, c, sc=0.3)
        self.w = f(3, 3, c, o, sc=1.0 / np.sqrt(9 * c))
        self.bias = f(o, sc=0.3)
        self.res = f(b, h, w, o)
        self.res_lo = f(b, h // 2, w // 2, o)
        self.res_proj = f(b, h, w, cr)
        self.skw = f(cr, o, sc=1.0 / np.sqrt(cr))
        self.skb = f(o, sc=0.3)
        self.g = f(b, h, w, o)
        x32 = self.x.reshape(b, h * w, c)
        self.stats = (x32.sum(1), (x32 * x32).sum(1))

    def t(self, name):
        return torch.from_numpy(getattr(self, name))


# --- K1 ---------------------------------------------------------------------

def test_k1_backward_matches_pallas_and_vjp(interpret):
    inp = _Inputs(0)
    b, h, w, c = inp.x.shape
    x, g = inp.x.reshape(b, h * w, c), inp.g[..., :c].reshape(b, h * w, c)
    got = tfn.gn_silu_bwd_plain(torch.from_numpy(g), torch.from_numpy(x),
                                inp.t("gamma"), inp.t("beta"), 8, EPS)
    kern = jfn._pallas_backward(x, inp.gamma, inp.beta, *inp.stats, g, 8, EPS,
                                tile=h * w // 4)
    _, vjp = jax.vjp(lambda *a: jfn.group_norm_silu_reference(*a, 8, EPS),
                     x, inp.gamma, inp.beta)
    for want in (kern, vjp(g)):
        for name, a, e in zip(("dx", "dgamma", "dbeta"), got, want):
            _close(a, e, name=name)


# --- K2 ---------------------------------------------------------------------

def _jax_k2_reference(inp, mode):
    """jax.vjp of the JAX reference composition of one K2 mode."""
    if mode == "linear":
        f = lambda x, w, bias: jfnc.conv3x3_same_reference(x, w, bias)
        args = (inp.x, inp.w, inp.bias)
    else:
        kw_of = {"none": lambda: {}, "identity": lambda r: dict(residual=r),
                 "identity_up": lambda r: dict(
                     residual=jnp.repeat(jnp.repeat(r, 2, 1), 2, 2)),
                 "proj": lambda r, sw, sb: dict(residual=r, skip_w=sw, skip_b=sb)}
        extra = {"none": (), "identity": (inp.res,), "identity_up": (inp.res_lo,),
                 "proj": (inp.res_proj, inp.skw, inp.skb)}[mode]

        def f(x, gamma, beta, w, bias, *rest):
            return jfnc.gn_silu_conv_block_reference(
                x, gamma, beta, w, bias, 8, EPS, **kw_of[mode](*rest))
        args = (inp.x, inp.gamma, inp.beta, inp.w, inp.bias) + extra
    _, vjp = jax.vjp(f, *args)
    return vjp(inp.g)


def _jax_k2_kernel(inp, mode):
    """The Pallas K2 backward (phase A + _dx_from_da), through the entry
    point the JAX package uses for the mode."""
    if mode in ("none", "proj"):
        kw = (dict(residual=inp.res_proj, skip_w=inp.skw, res_mode="proj")
              if mode == "proj" else {})
        out = jfnc._pallas_gnsc_bwd(inp.x, inp.gamma, inp.beta, inp.w,
                                    *inp.stats, inp.g, 8, EPS, **kw)
        return out[:7] if mode == "proj" else out
    if mode == "linear":
        dw9, db, _, _, da = jfnc._bwd_phase_a(
            inp.x, inp.gamma, inp.beta, inp.w, *inp.stats, inp.g, 8, EPS,
            act=False)
        return da, dw9.reshape(inp.w.shape), db.reshape(-1)
    zc = jnp.zeros((0,), jnp.float32)
    res = inp.res if mode == "identity" else inp.res_lo
    residuals = (inp.x, inp.gamma, inp.beta, inp.w, inp.bias, zc, res, zc, zc,
                 zc, zc, zc, inp.stats)
    out = jfnc._block_bwd(8, EPS, mode, False, True, False, False, False,
                          residuals, inp.g)
    return out[:5] + (out[6],)


K2_MODES = ["none", "identity", "identity_up", "proj", "linear"]


def _port_k2(inp, mode):
    """The plain backward's outputs in the JAX kernel's order for the mode."""
    kw = {"identity": dict(residual=inp.t("res")),
          "identity_up": dict(residual=inp.t("res_lo"), res_up=True),
          "proj": dict(residual=inp.t("res_proj"), skip_w=inp.t("skw"))}.get(mode, {})
    act = mode != "linear"
    dx, dgamma, dbeta, dw, dbias, dres, dskw = tfnc.gn_silu_conv_bwd_plain(
        inp.t("g"), inp.t("x"), inp.t("gamma") if act else None,
        inp.t("beta") if act else None, inp.t("w"), 8 if act else 0, EPS, **kw)
    if mode == "linear":
        return dx, dw, dbias
    out = (dx, dgamma, dbeta, dw, dbias)
    if mode == "proj":
        return out + (dres, dskw)
    return out + ((dres,) if mode in ("identity", "identity_up") else ())


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_backward_matches_pallas(interpret, mode):
    inp = _Inputs(1, cr=48)
    got, want = _port_k2(inp, mode), _jax_k2_kernel(inp, mode)
    assert len(got) == len(want)
    for i, (a, e) in enumerate(zip(got, want)):
        _close(a, e, name=f"{mode} output {i}")


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_backward_matches_vjp(mode):
    inp = _Inputs(2, o=24)
    got = _port_k2(inp, mode)
    ref = _jax_k2_reference(inp, mode)
    # reference order: x, gamma, beta, w, bias, then the residual inputs
    if mode == "linear":
        want = ref
    elif mode == "proj":
        want = ref[:5] + (ref[5], ref[6])
        _close(tfnc.gn_silu_conv_bwd_plain(
            inp.t("g"), inp.t("x"), inp.t("gamma"), inp.t("beta"), inp.t("w"),
            8, EPS, residual=inp.t("res_proj"), skip_w=inp.t("skw"))[4],
            ref[7], name="dskip_b = dbias")
    else:
        want = ref
    assert len(got) == len(want)
    for i, (a, e) in enumerate(zip(got, want)):
        _close(a, e, name=f"{mode} gradient {i}")


# --- K3 ---------------------------------------------------------------------

def test_k3_backward_matches_pallas_and_vjp(interpret):
    inp = _Inputs(3, h=8, w=16, c=32, o=32)
    b, h, w, c = inp.x.shape
    g = np.random.RandomState(4).randn(b, 2 * h, 2 * w, 32).astype(np.float32)
    got = tfnc.gn_silu_up_conv_bwd_plain(torch.from_numpy(g), inp.t("x"),
                                         inp.t("gamma"), inp.t("beta"),
                                         inp.t("w"), 8, EPS)
    kern = jfnc._pallas_up_pair_bwd(inp.x, inp.gamma, inp.beta, inp.w,
                                    *inp.stats, jfnc.pair_array(jnp.asarray(g)),
                                    8, EPS)
    _, vjp = jax.vjp(lambda *a: jfnc.gn_silu_up_conv_reference(*a, 8, EPS),
                     inp.x, inp.gamma, inp.beta, inp.w, inp.bias)
    for want in (kern, vjp(g)):
        for i, (a, e) in enumerate(zip(got, want)):
            _close(a, e, name=f"gradient {i}")


# --- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("n,l", [(2, 64), (3, 100)])
def test_k4_backward_matches_pallas_and_vjp(interpret, n, l):
    rs = np.random.RandomState(5)
    q, k, v, g = (rs.randn(n, l, 64).astype(np.float32) for _ in range(4))
    got = tfa.attention_bwd_plain(*(torch.from_numpy(a) for a in (g, q, k, v)))
    _, vjp = jax.vjp(jfa.attention_reference, q, k, v)
    for want in (jfa._pallas_bwd(q, k, v, g), vjp(g)):
        for name, a, e in zip(("dq", "dk", "dv"), got, want):
            _close(a, e, name=name)


# --- the autograd.Function plumbing -------------------------------------

def _f64(rs, *shape, sc=1.0, sh=0.0):
    return torch.from_numpy(rs.randn(*shape) * sc + sh).requires_grad_()


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_function_gradcheck(mode):
    """float64 gradcheck of the CPU Function (plain forward, plain backward
    formulas) in each mode, emitting statistics."""
    rs = np.random.RandomState(6)
    b, h, w, c, o = 2, 4, 6, 8, 6
    x = _f64(rs, b, h, w, c, sc=0.8, sh=0.3)
    gamma, beta = _f64(rs, b, c, sc=0.3, sh=1.0), _f64(rs, b, c, sc=0.3)
    wt, bias = _f64(rs, 3, 3, c, o, sc=0.2), _f64(rs, o)
    extra = {"identity": [("residual", _f64(rs, b, h, w, o))],
             "identity_up": [("residual", _f64(rs, b, h // 2, w // 2, o))],
             "proj": [("residual", _f64(rs, b, h, w, 5)), ("skip_w", _f64(rs, 5, o)),
                      ("skip_b", _f64(rs, o))]}.get(mode, [])
    names = [n for n, _ in extra]
    act = mode != "linear"

    def f(x, gamma, beta, wt, bias, *rest):
        out, _ = tfnc.gn_silu_conv(x, gamma if act else None, beta if act else None,
                                   wt, bias, 2 if act else 0, EPS,
                                   res_up=mode == "identity_up", emit_stats=True,
                                   **dict(zip(names, rest)))
        return out

    assert gradcheck(f, (x, gamma, beta, wt, bias) + tuple(t for _, t in extra))


def test_k1_k3_k4_function_gradcheck():
    rs = np.random.RandomState(7)
    b, c = 2, 8
    x = _f64(rs, b, 24, c, sc=0.8, sh=0.3)
    gamma, beta = _f64(rs, b, c, sc=0.3, sh=1.0), _f64(rs, b, c, sc=0.3)
    assert gradcheck(lambda *a: tfn.gn_silu(*a, 2, EPS), (x, gamma, beta))
    xl, wt, bias = _f64(rs, b, 3, 4, c, sc=0.8, sh=0.3), _f64(rs, 3, 3, c, 5), _f64(rs, 5)
    assert gradcheck(lambda *a: tfnc.gn_silu_up_conv(*a, 2, EPS, emit_stats=True)[0],
                     (xl, gamma, beta, wt, bias))
    q, k, v = (_f64(rs, 2, 5, 4) for _ in range(3))
    assert gradcheck(tfa.attention, (q, k, v))


def test_chained_stats_take_zero_cotangent():
    """Chained statistics are inputs without a gradient: the consumer's
    backward already holds their dependence on x. Emitted statistics are
    not differentiable."""
    inp = _Inputs(8, h=8, w=8, c=16, o=16)
    x = inp.t("x").requires_grad_()
    stats = tuple(s.requires_grad_() for s in tfn.channel_stats_plain(
        inp.t("x").reshape(2, 64, 16)))
    out, ostats = tfnc.gn_silu_conv(x, inp.t("gamma"), inp.t("beta"), inp.t("w"),
                                    inp.t("bias"), 4, EPS, stats=stats,
                                    emit_stats=True)
    assert not any(s.requires_grad for s in ostats)
    gx, g_s, g_ss = torch.autograd.grad((out * inp.t("g")).sum(), (x,) + stats,
                                        allow_unused=True)
    assert g_s is None and g_ss is None
    want = tfnc.gn_silu_conv_bwd_plain(inp.t("g"), inp.t("x"), inp.t("gamma"),
                                       inp.t("beta"), inp.t("w"), 4, EPS)[0]
    torch.testing.assert_close(gx, want, rtol=0, atol=0)
    y = tfn.gn_silu(x.reshape(2, 64, 16), inp.t("gamma"), inp.t("beta"), 4,
                    stats=stats)
    assert torch.autograd.grad(y.sum(), stats, allow_unused=True) == (None, None)
