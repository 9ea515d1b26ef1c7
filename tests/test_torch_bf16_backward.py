"""The bf16 plain versions of the backward kernels (K1, K2 in every mode on
the train path, K3, conv_in's weight gradient, the out conv, K4) against the
Pallas backward kernels in interpret mode on the same bf16 inputs (about 20
s in one process).

On a bf16 network the Pallas backward rounds at fixed points: K1 computes in
fp32 and rounds dx once; K2's phase A rounds the recomputed activation to
bf16 before its products, sums bf16 products in fp32, stores da rounded to
bf16 and leaves dW, dbias, dgamma and dbeta in fp32, and `_dx_from_da` forms
dx from the rounded da in fp32 with one rounding; K3 keeps its ds in fp32
through the low-res tail; K4 computes in fp32 and rounds dq, dk, dv once. The
port's bf16 backward kernels round at those points, and their plain versions
(what the wrappers run on the CPU) are held here. The out conv has no Pallas
kernel of its own: it is held to phase A's linear mode.

The weights go to the Pallas side as fp32 arrays holding bf16 values: the
kernels cast them to the activation's dtype (exactly), and the entry points
then return dW in fp32 instead of rounding it to the weight's dtype, so the
fp32 outputs compare before any rounding. Tolerances: a bf16 output within
1e-2 of its scale at most and 1e-4 on average (tests/test_torch_bf16_kernels.py;
seen: 1.3e-3 and 9.7e-8, one-ulp flips at the rounding); the fp32 outputs
(dW, dbias, dgamma, dbeta) within 1e-3 of their scale (seen: at most 3.5e-7,
summation order); K4's delta row term, from the fp32 output, within 1e-5 of
JAX's sum(dw * w) (seen: 2.9e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import fused_attention as tfa
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from test_torch_bf16_kernels import B, EPS, G, RES, bf16, f32, fold, held, jb, sums_of, tb
from test_torch_bf16_kernels import interpret  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

C = 32
TOL_F32, TOL_DELTA = 1e-3, 1e-5


@pytest.fixture
def unpaired(interpret, monkeypatch):
    """The Pallas kernels in interpret mode on the unpaired layout."""
    monkeypatch.setenv("MCEDM_PAIR", "0")


def held32(got, want, tol=TOL_F32):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, err / scale
    return err / scale


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- K1 ---------------------------------------------------------------------

def _k1_inputs(seed):
    rs = np.random.RandomState(seed)
    x = bf16(rs, B, RES, RES, C, scale=0.8, shift=0.2)
    g = bf16(rs, B, RES, RES, C)
    gamma, beta = fold(rs, C)
    return x, g, gamma, beta, sums_of(x)


def test_k1_backward_matches_pallas(interpret):
    x, g, gamma, beta, stats = _k1_inputs(40)
    n = RES * RES
    want = jfn._pallas_backward(jb(x.reshape(B, n, C)), jnp.asarray(gamma),
                                jnp.asarray(beta), *map(jnp.asarray, stats),
                                jb(g.reshape(B, n, C)), G, EPS, tile=n // 4)
    got = tfn.gn_silu_bwd_plain(tb(g.reshape(B, n, C)), tb(x.reshape(B, n, C)),
                                t32(gamma), t32(beta), G, EPS, tuple(map(t32, stats)))
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    held(got[0], want[0])
    for a, e in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        held32(a, e)


def test_k1_paired_twin_matches(interpret):
    """_gnsp_bwd, the paired-lane twin the JAX U-Net's out head runs."""
    x, g, gamma, beta, stats = _k1_inputs(41)
    js = tuple(map(jnp.asarray, stats))
    xp, gp = jfnc.pair_array(jb(x)), jfnc.pair_array(jb(g))
    dxp, dgamma, dbeta, _, _ = jfnc._gnsp_bwd(
        G, EPS, None, True, (xp, jnp.asarray(gamma), jnp.asarray(beta), *js, js), gp)
    got = tfn.gn_silu_bwd_plain(tb(g.reshape(B, -1, C)), tb(x.reshape(B, -1, C)),
                                t32(gamma), t32(beta), G, EPS, tuple(map(t32, stats)))
    held(got[0].reshape(x.shape), jfnc.unpair_array(dxp))
    held32(got[1], dgamma)
    held32(got[2], dbeta)


def test_k1_function_uses_the_forwards_statistics(interpret):
    """The CPU Function's backward on bf16: the bf16 plain version with the
    chained statistics its forward took."""
    x, g, gamma, beta, stats = _k1_inputs(42)
    xt = tb(x.reshape(B, -1, C)).requires_grad_()
    gt, bt = t32(gamma).requires_grad_(), t32(beta).requires_grad_()
    st = tuple(map(t32, stats))
    y = tfn.gn_silu(xt, gt, bt, G, EPS, stats=st)
    dx, dgamma, dbeta = torch.autograd.grad(y, (xt, gt, bt), tb(g.reshape(B, -1, C)))
    want = tfn.gn_silu_bwd_bf16_plain(tb(g.reshape(B, -1, C)), xt.detach(), gt.detach(),
                                      bt.detach(), G, EPS, st)
    assert dx.dtype == torch.bfloat16
    for a, e in zip((dx, dgamma, dbeta), want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


# --- K2 / K3 ------------------------------------------------------------------

class _K2:
    """Seeded bf16 inputs of one K2 backward call; weights as fp32 arrays of
    bf16 values for the Pallas side (module docstring)."""

    def __init__(self, seed, c=C, o=C, cr=2 * C, act=True):
        rs = np.random.RandomState(seed)
        self.x = bf16(rs, B, RES, RES, c, scale=0.8, shift=0.2)
        self.gamma, self.beta = fold(rs, c)
        self.w = bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c))
        self.bias = (0.3 * rs.randn(o)).astype(np.float32)
        self.g = bf16(rs, B, RES, RES, o)
        self.res = bf16(rs, B, RES, RES, o)
        self.res_lo = bf16(rs, B, RES // 2, RES // 2, o)
        self.res_proj = bf16(rs, B, RES, RES, cr)
        self.skw = bf16(rs, cr, o, scale=1.0 / np.sqrt(cr))
        self.stats = sums_of(self.x)
        self.act = act


def _jax_k2(k, mode):
    """The Pallas K2 backward through the entry point the JAX package uses
    for the mode: (dx, dgamma, dbeta, dw, dbias, dres, dskw), None where the
    mode has none."""
    js = tuple(map(jnp.asarray, k.stats))
    gamma, beta = jnp.asarray(k.gamma), jnp.asarray(k.beta)
    if mode == "proj":
        out = jfnc._pallas_gnsc_bwd(jb(k.x), gamma, beta, jnp.asarray(k.w), *js, jb(k.g),
                                    G, EPS, residual=jb(k.res_proj),
                                    skip_w=jnp.asarray(k.skw), res_mode="proj")
        return out[:7]
    if mode == "linear":
        dw9, db, _, _, da = jfnc._bwd_phase_a(jb(k.x), gamma, beta, jnp.asarray(k.w), *js,
                                              jb(k.g), G, EPS, act=False)
        return da, None, None, dw9.reshape(k.w.shape), db.reshape(-1), None, None
    zc = jnp.zeros((0,), jnp.float32)
    res = jb(k.res if mode == "identity" else k.res_lo)
    residuals = (jb(k.x), gamma, beta, jnp.asarray(k.w), jnp.asarray(k.bias), zc, res,
                 zc, zc, zc, zc, zc, js)
    out = jfnc._block_bwd(G, EPS, mode, False, True, False, False, False, residuals,
                          jb(k.g))
    return out[:5] + (out[6], None)


K2_MODES = ["identity", "identity_up", "proj", "linear"]


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_backward_matches_pallas(unpaired, mode):
    k = _K2(50 + K2_MODES.index(mode))
    act = mode != "linear"
    kw = {"identity": dict(residual=tb(k.res)),
          "identity_up": dict(residual=tb(k.res_lo), res_up=True),
          "proj": dict(residual=tb(k.res_proj), skip_w=tb(k.skw))}.get(mode, {})
    got = tfnc.gn_silu_conv_bwd_plain(
        tb(k.g), tb(k.x), t32(k.gamma) if act else None, t32(k.beta) if act else None,
        tb(k.w), G if act else 0, EPS, stats=tuple(map(t32, k.stats)) if act else None,
        **kw)
    want = _jax_k2(k, mode)
    names = ("dx", "dgamma", "dbeta", "dw", "dbias", "dres", "dskip_w")
    for name, a, e in zip(names, got, want):
        assert (a is None) == (e is None), name
        if a is None:
            continue
        if name in ("dx", "dres"):
            assert a.dtype == torch.bfloat16 and e.dtype == jnp.bfloat16, name
            held(a, e)
        else:
            assert a.dtype == torch.float32, name
            held32(a, e)


def test_conv_in_wgrad_matches_pallas_linear_mode(interpret):
    """conv_in (C = 4 -> 64, no input gradient): its dW and dbias."""
    k = _K2(55, c=4, o=64, act=False)
    z = jnp.zeros((B, 4), jnp.float32)
    dw9, db, *_ = jfnc._bwd_phase_a(jb(k.x), z, z, jnp.asarray(k.w), z, z, jb(k.g), 1,
                                    EPS, act=False)
    _, _, _, dw, dbias, _, _ = tfnc.gn_silu_conv_bwd_plain(tb(k.g), tb(k.x), None, None,
                                                           tb(k.w))
    held32(dw, dw9.reshape(k.w.shape))
    held32(dbias, db.reshape(-1))


def test_k2_function_routes_bf16_to_the_bf16_backward():
    """The CPU Function's backward of a bf16 call with chained statistics
    (the identity tail) is the bf16 plain version with those statistics; dW
    leaves autograd rounded to the weight's bf16."""
    k = _K2(56)
    x = tb(k.x).requires_grad_()
    gamma, beta = t32(k.gamma).requires_grad_(), t32(k.beta).requires_grad_()
    w, res = tb(k.w).requires_grad_(), tb(k.res).requires_grad_()
    st = tuple(map(t32, k.stats))
    out = tfnc.gn_silu_conv(x, gamma, beta, w, t32(k.bias), G, EPS, stats=st, residual=res)
    grads = torch.autograd.grad(out, (x, gamma, beta, w, res), tb(k.g))
    want = tfnc.gn_silu_conv_bwd_plain(tb(k.g), tb(k.x), t32(k.gamma), t32(k.beta),
                                       tb(k.w), G, EPS, residual=tb(k.res), stats=st)
    assert grads[3].dtype == torch.bfloat16
    for a, e in zip(grads, (want[0], want[1], want[2], want[3].bfloat16(), want[5])):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_k3_backward_matches_pallas(interpret):
    rs = np.random.RandomState(57)
    x = bf16(rs, B, RES // 2, RES // 2, C, scale=0.8, shift=0.2)
    gamma, beta = fold(rs, C)
    w = bf16(rs, 3, 3, C, C, scale=1.0 / np.sqrt(9 * C))
    g = bf16(rs, B, RES, RES, C)
    stats = sums_of(x)
    want = jfnc._pallas_up_pair_bwd(jb(x), jnp.asarray(gamma), jnp.asarray(beta),
                                    jnp.asarray(w), *map(jnp.asarray, stats),
                                    jfnc.pair_array(jb(g)), G, EPS)
    got = tfnc.gn_silu_up_conv_bwd_plain(tb(g), tb(x), t32(gamma), t32(beta), tb(w), G,
                                         EPS, tuple(map(t32, stats)))
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    held(got[0], want[0])
    for a, e in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        held32(a, e)


@pytest.mark.parametrize("o", [1, 2])
def test_out_conv_backward_matches_pallas_linear_mode(interpret, o):
    rs = np.random.RandomState(58 + o)
    y = bf16(rs, B, RES, RES, 64, scale=0.8)
    w = bf16(rs, 3, 3, 64, o, scale=1.0 / 24.0)
    g = bf16(rs, B, RES, RES, o)
    z = jnp.zeros((B, 64), jnp.float32)
    dw9, db, _, _, da = jfnc._bwd_phase_a(jb(y), z, z, jnp.asarray(w), z, z, jb(g), 1,
                                          EPS, act=False)
    dx, dw, dbias = tfnc.narrow_conv_bwd_plain(tb(g), tb(y), tb(w))
    assert dx.dtype == torch.bfloat16
    held(dx, da)
    held32(dw, dw9.reshape(w.shape))
    held32(dbias, db.reshape(-1))


# --- K4 ---------------------------------------------------------------------

def _k4_inputs(seed, n=2, l=64):
    rs = np.random.RandomState(seed)
    return tuple(bf16(rs, n, l, 64) for _ in range(4))


@pytest.mark.parametrize("n,l", [(2, 64), (3, 100)])
def test_k4_backward_matches_pallas(interpret, n, l):
    q, k, v, g = _k4_inputs(60 + n, n, l)
    want = jfa._pallas_bwd(jb(q), jb(k), jb(v), jb(g))
    got = tfa.attention_bwd_plain(tb(g), tb(q), tb(k), tb(v))
    for a, e in zip(got, want):
        assert a.dtype == torch.bfloat16 and e.dtype == jnp.bfloat16
        held(a, e)


def delta(g, o):
    """The kernels' row term delta_i = sum_d g_id o_id, in fp32."""
    return (g.float() * o.float()).sum(dim=-1)


def test_k4_delta_from_the_fp32_output():
    """The kernels' delta = rowsum(g * o32) against _bwd_kernel's
    sum(dw * w); the same from the rounded bf16 output, for contrast, is off
    by a bf16 rounding in every row (printed)."""
    q, k, v, g = _k4_inputs(63, 4, 256)
    qf, kf, vf, gf = (jnp.asarray(a) for a in (q, k, v, g))
    w = jax.nn.softmax(jnp.einsum("nqd,nkd->nqk", qf, kf / 8.0), axis=-1)
    want = np.asarray(jnp.sum(jnp.einsum("nqd,nkd->nqk", gf, vf) * w, axis=-1))
    o32 = tfa.attention_plain(*(t32(a) for a in (q, k, v)))
    err32 = held32(delta(tb(g), o32), want, TOL_DELTA)
    o16 = tfa.attention_plain(tb(q), tb(k), tb(v))
    assert o16.dtype == torch.bfloat16
    got16 = delta(tb(g), o16).numpy()
    err16 = float(np.abs(got16 - want).max() / np.abs(want).max())
    print(f"delta from the fp32 output: {err32:.2e} of scale; "
          f"from the bf16 output: {err16:.2e}")
    assert err16 > TOL_DELTA > err32


def test_k4_function_backward_in_bf16():
    q, k, v, g = _k4_inputs(64)
    qt, kt, vt = (tb(a).requires_grad_() for a in (q, k, v))
    out = tfa.attention(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), tb(g))
    for a, e in zip(grads, tfa.attention_bwd_plain(tb(g), tb(q), tb(k), tb(v))):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, e, rtol=0, atol=0)


# --- dtype checks of the backward launches ----------------------------------------

def _mixed_calls():
    x = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)
    v = torch.zeros(1, 16)
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 16)
    return {
        "K1, fp32 cotangent": lambda: tfn.gn_silu_bwd(
            x.reshape(1, 64, 16).float(), x.reshape(1, 64, 16), v, v, (v, v), 4, EPS),
        "K2, fp32 cotangent": lambda: tfnc.gn_silu_conv_bwd(
            x.float(), x, v, v, w, (v, v), 4, EPS),
        "K2, fp32 weight": lambda: tfnc.gn_silu_conv_bwd(
            x, x, v, v, w.float(), (v, v), 4, EPS),
        "K2, fp32 skip weight": lambda: tfnc.gn_silu_conv_bwd(
            x, x, None, None, w, None, 0, EPS, residual=x, skip_w=torch.zeros(16, 16)),
        "K3, fp32 weight": lambda: tfnc.gn_silu_up_conv_bwd(
            torch.zeros(1, 16, 16, 16, dtype=torch.bfloat16), x, v, v, w.float(),
            (v, v), 4, EPS),
        "narrow, fp32 cotangent": lambda: tfnc.narrow_conv_bwd(
            torch.zeros(1, 8, 8, 2), x, w[..., :2].contiguous()),
        "K4, fp32 cotangent": lambda: tfa.attention_bwd(q.float(), q, q, q, q.float(), lse),
        "K4, bf16 output": lambda: tfa.attention_bwd(q, q, q, q, q, lse),
    }


@pytest.mark.parametrize("case", list(_mixed_calls()))
def test_backward_launch_refuses_mixed_dtypes(case):
    """The checks run before any library is loaded, so they run here."""
    with pytest.raises(ValueError, match="must be|float32 or bfloat16"):
        _mixed_calls()[case]()
