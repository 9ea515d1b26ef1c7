"""Port parity of the four forward kernels' plain versions (K1 GroupNorm+SiLU,
K2 norm+conv block tail, K3 norm+upsample+conv, K4 attention) against the
JAX references and against the Pallas kernels themselves, run in interpret
mode as tests/test_pallas.py does; plus the wrappers' dispatch rules, for
the backward wrappers too (tests/test_torch_backward.py holds the backward
plain versions to the JAX package).

Tolerances: both sides are fp32 and differ only in summation order (convs
sum up to 9 * C products, statistics a few thousand pixels), so outputs are
held to rtol 1e-5 / atol 1e-5 and sums of squares to rtol 1e-5 / atol 1e-4.
The CUDA kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_attention as jfa
import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch import kernels
from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels import fused_attention as tfa
from m_cedm_tpu_torch.kernels import fused_block as tfb
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from m_cedm_tpu_torch.kernels import linear_attention as tla
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SQ = dict(rtol=1e-5, atol=1e-4)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Inputs:
    """Seeded numpy inputs for one norm+conv call, as numpy and torch."""

    def __init__(self, seed, b=2, h=16, w=16, c=16, o=24, cr=None):
        rs = np.random.RandomState(seed)
        f = lambda *s, sc=1.0, sh=0.0: (rs.randn(*s) * sc + sh).astype(np.float32)
        self.x = f(b, h, w, c, sc=0.8, sh=0.3)
        self.gamma = f(b, c, sc=0.3, sh=1.0)
        self.beta = f(b, c, sc=0.3)
        self.w = f(3, 3, c, o, sc=1.0 / np.sqrt(9 * c))
        self.bias = f(o, sc=0.3)
        self.res = f(b, h, w, o)
        self.res_lo = f(b, h // 2, w // 2, o)
        cr = cr or 2 * c
        self.res_proj = f(b, h, w, cr)
        self.skw = f(cr, o, sc=1.0 / np.sqrt(cr))
        self.skb = f(o, sc=0.3)
        x32 = self.x.reshape(b, h * w, c)
        self.stats = (x32.sum(1), (x32 * x32).sum(1))
        self.device = torch.device("cpu")

    def t(self, name):
        v = getattr(self, name)
        if isinstance(v, tuple):
            return tuple(torch.from_numpy(a).to(self.device) for a in v)
        return torch.from_numpy(v).to(self.device)


def _leaves(t):
    return [u for s in t for u in _leaves(s)] if isinstance(t, tuple) else [t]


def _assert_out(got, want):
    """Outputs nested as out or (out, (sums, sumsq)) on either side; the
    first leaf is the activation, the others channel statistics."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(a), _np(w), **(TOL if i == 0 else TOL_SQ))


def _jax_block(inp, mode, groups, emit):
    """JAX reference of one K2 mode."""
    if mode == "linear":
        out = jfnc.conv3x3_same_reference(inp.x, inp.w, inp.bias)
    else:
        kw = {}
        if mode == "identity":
            kw = dict(residual=inp.res)
        elif mode == "identity_up":
            kw = dict(residual=jnp.repeat(jnp.repeat(inp.res_lo, 2, 1), 2, 2))
        elif mode == "proj":
            kw = dict(residual=inp.res_proj, skip_w=inp.skw, skip_b=inp.skb)
        out = jfnc.gn_silu_conv_block_reference(inp.x, inp.gamma, inp.beta, inp.w,
                                                inp.bias, groups, 1e-5, **kw)
    if emit:
        return (out,) + tuple(jfnc._out_stats_reference(out))
    return out


def _port_kwargs(inp, mode):
    if mode == "identity":
        return dict(residual=inp.t("res"))
    if mode == "identity_up":
        return dict(residual=inp.t("res_lo"), res_up=True)
    if mode == "proj":
        return dict(residual=inp.t("res_proj"), skip_w=inp.t("skw"),
                    skip_b=inp.t("skb"))
    return {}


def _port_block(fn, inp, mode, groups, emit, stats=None):
    act = mode != "linear"
    return fn(inp.t("x"), inp.t("gamma") if act else None,
              inp.t("beta") if act else None, inp.t("w"), inp.t("bias"),
              groups if act else 0, 1e-5, stats=stats, emit_stats=emit,
              **_port_kwargs(inp, mode))


MODES = ["none", "identity", "identity_up", "proj", "linear"]


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode (CPU), unpaired."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setenv("MCEDM_PAIR", "0")


# --- plain versions against the JAX references ------------------------------

@pytest.mark.parametrize("c,groups", [(32, 8), (64, 16), (128, 32)])
def test_gn_silu_plain_matches_reference(c, groups):
    inp = _Inputs(0, c=c)
    b, h, w, _ = inp.x.shape
    x = inp.x.reshape(b, h * w, c)
    want = jfn.group_norm_silu_reference(x, inp.gamma, inp.beta, groups)
    got = tfn.gn_silu_plain(torch.from_numpy(x), inp.t("gamma"), inp.t("beta"),
                            groups)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    s, ss = tfn.channel_stats_plain(torch.from_numpy(x))
    np.testing.assert_allclose(_np(s), inp.stats[0], **TOL_SQ)
    np.testing.assert_allclose(_np(ss), inp.stats[1], **TOL_SQ)


@pytest.mark.parametrize("emit", [False, True], ids=["plain", "emit_stats"])
@pytest.mark.parametrize("mode", MODES)
def test_gn_silu_conv_plain_matches_reference(mode, emit):
    inp = _Inputs(1, o=16 if mode == "identity_up" else 24)
    got = _port_block(tfnc.gn_silu_conv_plain, inp, mode, 4, emit)
    _assert_out(got, _jax_block(inp, mode, 4, emit))


@pytest.mark.parametrize("emit", [False, True], ids=["plain", "emit_stats"])
def test_gn_silu_up_conv_plain_matches_reference(emit):
    inp = _Inputs(2, h=8, w=12)
    want = jfnc.gn_silu_up_conv_reference(inp.x, inp.gamma, inp.beta, inp.w,
                                          inp.bias, 4)
    if emit:
        want = (want,) + tuple(jfnc._out_stats_reference(want))
    got = tfnc.gn_silu_up_conv_plain(inp.t("x"), inp.t("gamma"), inp.t("beta"),
                                     inp.t("w"), inp.t("bias"), 4, emit_stats=emit)
    _assert_out(got, want)


@pytest.mark.parametrize("n,l", [(2, 64), (3, 100)])
def test_attention_plain_matches_reference(n, l):
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(n, l, 64).astype(np.float32) for _ in range(3))
    want = jfa.attention_reference(q, k, v)
    got = tfa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# --- plain versions against the Pallas kernels in interpret mode -----------

@pytest.mark.parametrize("chained", [False, True], ids=["stats_pass", "chained"])
def test_k1_matches_pallas_interpret(interpret, chained):
    inp = _Inputs(4, c=32)
    b, h, w, c = inp.x.shape
    x = inp.x.reshape(b, h * w, c)
    stats = tuple(jnp.asarray(a) for a in inp.stats) if chained else None
    out, sums, sumsq = jfn._pallas_forward(x, inp.gamma, inp.beta, 8, 1e-5,
                                           tile=h * w // 4, stats=stats)
    got = tfn.gn_silu_plain(torch.from_numpy(x), inp.t("gamma"), inp.t("beta"), 8)
    np.testing.assert_allclose(_np(got), _np(out), **TOL)
    s, ss = tfn.channel_stats_plain(torch.from_numpy(x))
    np.testing.assert_allclose(_np(s), _np(sums), **TOL_SQ)
    np.testing.assert_allclose(_np(ss), _np(sumsq), **TOL_SQ)


@pytest.mark.parametrize("mode,emit,chained", [
    ("none", True, True), ("identity", True, False), ("identity_up", True, False),
    ("proj", True, True), ("proj", False, False), ("linear", True, False)])
def test_k2_matches_pallas_interpret(interpret, mode, emit, chained):
    inp = _Inputs(5, o=16)
    stats = tuple(jnp.asarray(a) for a in inp.stats) if chained else None
    kw = dict(res_mode={"linear": "none"}.get(mode, mode), emit_stats=emit,
              stats=stats, act=mode != "linear")
    if mode == "identity":
        kw.update(residual=inp.res)
    elif mode == "identity_up":
        kw.update(residual=inp.res_lo)
    elif mode == "proj":
        kw.update(residual=inp.res_proj, skip_w=inp.skw, skip_b=inp.skb)
    want = jfnc._pallas_gnsc(inp.x, inp.gamma, inp.beta, inp.w, inp.bias, 4,
                             1e-5, **kw)
    want = tuple(want) if emit else want
    got = _port_block(tfnc.gn_silu_conv_plain, inp, mode, 4, emit,
                      stats=inp.t("stats") if chained else None)
    _assert_out(got, want)


def test_k3_matches_pallas_interpret(interpret):
    inp = _Inputs(6, h=8, w=16, o=16)
    want = jfnc._pallas_gnsc_up(inp.x, inp.gamma, inp.beta, inp.w, inp.bias, 4,
                                1e-5)
    got = tfnc.gn_silu_up_conv_plain(inp.t("x"), inp.t("gamma"), inp.t("beta"),
                                     inp.t("w"), inp.t("bias"), 4)
    _assert_out(got, want)


def test_k4_matches_pallas_interpret(interpret):
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(2, 128, 64).astype(np.float32) for _ in range(3))
    want = jfa._pallas_fwd(q, k, v)
    got = tfa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# --- wrapper dispatch ----------------------------------------------------

def _wrapper_calls(inp):
    b, h, w, c = inp.x.shape
    x3 = inp.t("x").reshape(b, h * w, c)
    q = torch.from_numpy(np.random.RandomState(8).randn(2, 16, 64).astype(np.float32))
    rs = np.random.RandomState(10)
    g2 = torch.from_numpy(rs.randn(b, h, w, inp.w.shape[-1]).astype(np.float32))
    g3 = torch.from_numpy(rs.randn(b, 2 * h, 2 * w, inp.w.shape[-1]).astype(np.float32))
    dots = torch.from_numpy(rs.randn(2, 64, 24).astype(np.float32))
    o = inp.w.shape[-1]
    g1, b1, w1, skw = (torch.from_numpy(a.astype(np.float32)) for a in (
        1.0 + 0.3 * rs.randn(b, o), 0.3 * rs.randn(b, o),
        rs.randn(3, 3, o, o) / np.sqrt(9 * o), rs.randn(c, o) / np.sqrt(c)))
    k7 = (inp.t("x"), inp.t("gamma"), inp.t("beta"), inp.t("w"), inp.t("bias"),
          g1, b1, w1, inp.t("bias"), 4, 4, 1e-5)
    k7_kw = dict(skip_w=skw, skip_b=inp.t("skb"), emit_stats=True)
    # the narrow route: C 4 -> O 24 (narrow C), and C 16 -> O 2 (narrow O)
    x4, w4 = inp.t("x")[..., :4].contiguous(), inp.t("w")[:, :, :4].contiguous()
    w2, b2, g2n = (t[..., :2].contiguous() for t in (inp.t("w"), inp.t("bias"), g2))
    dx_args = (inp.t("x").bfloat16(), g2[..., :c].bfloat16(), inp.t("gamma"),
               torch.stack([inp.t("gamma"), inp.t("beta")]),
               tfn.channel_stats_plain(x3), 4)
    return {
        "K1 gn_silu": (lambda: tfn.gn_silu(x3, inp.t("gamma"), inp.t("beta"), 4),
                       lambda: tfn.gn_silu_plain(x3, inp.t("gamma"), inp.t("beta"), 4)),
        "K1 channel_stats": (lambda: tfn.channel_stats(x3),
                             lambda: tfn.channel_stats_plain(x3)),
        "K2 gn_silu_conv": (
            lambda: _port_block(tfnc.gn_silu_conv, inp, "proj", 4, True),
            lambda: _port_block(tfnc.gn_silu_conv_plain, inp, "proj", 4, True)),
        "K2 narrow_conv": (
            lambda: tfnc.narrow_conv(x4, w4, inp.t("bias"), emit_stats=True),
            lambda: tfnc.narrow_conv_plain(x4, w4, inp.t("bias"), emit_stats=True)),
        "K3 gn_silu_up_conv": (
            lambda: tfnc.gn_silu_up_conv(inp.t("x"), inp.t("gamma"), inp.t("beta"),
                                         inp.t("w"), inp.t("bias"), 4),
            lambda: tfnc.gn_silu_up_conv_plain(inp.t("x"), inp.t("gamma"),
                                               inp.t("beta"), inp.t("w"),
                                               inp.t("bias"), 4)),
        "K4 attention": (lambda: tfa.attention(q, q, q),
                         lambda: tfa.attention_plain(q, q, q)),
        # backward wrappers: autograd through the CPU Function against the
        # plain version of the backward kernel
        "K1 gn_silu_bwd": (
            lambda: _grads(lambda a, g_, b_: tfn.gn_silu(a, g_, b_, 4),
                           (x3, inp.t("gamma"), inp.t("beta")), x3),
            lambda: tfn.gn_silu_bwd_plain(x3, x3, inp.t("gamma"), inp.t("beta"), 4)),
        "K2 gn_silu_conv_bwd": (
            lambda: _grads(lambda a, g_, b_, w_: tfnc.gn_silu_conv(
                a, g_, b_, w_, None, 4), (inp.t("x"), inp.t("gamma"),
                                          inp.t("beta"), inp.t("w")), g2),
            lambda: tfnc.gn_silu_conv_bwd_plain(g2, inp.t("x"), inp.t("gamma"),
                                                inp.t("beta"), inp.t("w"), 4)[:4]),
        "K2 narrow_conv_bwd": (
            lambda: _grads(lambda a, w_, b_: tfnc.gn_silu_conv(a, None, None, w_, b_),
                           (inp.t("x"), w2, b2), g2n),
            lambda: tfnc.narrow_conv_bwd_plain(g2n, inp.t("x"), w2)),
        "K3 gn_silu_up_conv_bwd": (
            lambda: _grads(lambda a, g_, b_, w_: tfnc.gn_silu_up_conv(
                a, g_, b_, w_, None, 4), (inp.t("x"), inp.t("gamma"),
                                          inp.t("beta"), inp.t("w")), g3),
            lambda: tfnc.gn_silu_up_conv_bwd_plain(g3, inp.t("x"), inp.t("gamma"),
                                                   inp.t("beta"), inp.t("w"), 4)[:4]),
        "K4 attention_bwd": (lambda: _grads(tfa.attention, (q, q, q), q),
                             lambda: tfa.attention_bwd_plain(q, q, q, q)),
        # the bf16 backward's dx pass, from a bf16 x and da
        "K2 gn_dx": (lambda: tfnc.gn_dx(*dx_args), lambda: tfnc.gn_dx_plain(*dx_args)),
        # the linear-attention pair (forward only: each backward is the pair)
        "K5 kv_dots": (lambda: tla.kv_dots(x3, x3), lambda: tla.kv_dots_plain(x3, x3)),
        "K6 apply_dots": (lambda: tla.apply_dots(q, dots), lambda: tla.apply_dots_plain(q, dots)),
        # their bf16 instances (bf16 k, v, q; an fp32 factor)
        "K5 kv_dots bf16": (lambda: tla.kv_dots(x3.bfloat16(), x3.bfloat16()),
                            lambda: tla.kv_dots_plain(x3.bfloat16(), x3.bfloat16())),
        "K6 apply_dots bf16": (lambda: tla.apply_dots(q.bfloat16(), dots),
                               lambda: tla.apply_dots_plain(q.bfloat16(), dots)),
        # the whole block (its backward is a recompute through K2/K3)
        "K7 unet_block": (lambda: tfb.fused_unet_block(*k7, **k7_kw),
                          lambda: tfb.fused_unet_block_plain(*k7, **k7_kw)),
    }


def _grads(fn, inputs, cot):
    """The gradients of fn at inputs (each its own leaf) for cotangent cot."""
    inputs = tuple(t.detach().requires_grad_() for t in inputs)
    return tuple(torch.autograd.grad(fn(*inputs), inputs, cot))

@pytest.mark.parametrize("name", sorted(kernels.launches()))
def test_wrapper_runs_plain_on_cpu_without_counting(name):
    """A CPU tensor takes the plain version; only kernel launches count."""
    kernels.reset_launches()
    wrapped, plain = _wrapper_calls(_Inputs(9))[name]
    got, want = _leaves(wrapped()), _leaves(plain())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if name.endswith("_bwd"):  # autograd may sum in its own order
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b)
    assert not any(kernels.launches().values())


def test_wrappers_refuse_other_devices():
    """Only CPU tensors may take the plain path: no silent fallback."""
    x = torch.empty(2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfn.gn_silu(x, x[:, 0], x[:, 0], 2)


def test_kernel_modules_build_lazily(monkeypatch, tmp_path):
    """The wrapper modules import without nvcc; nothing builds at import,
    the build goes to the ignored build directory, and a missing nvcc is a
    clear error at first use."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(_build.BUILD_DIR).startswith(repo)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert set(_build.SOURCES) == {p[:-3] for p in os.listdir(_build.CSRC)
                                   if p.endswith(".cu")}
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("c", [64, 2048])
def test_k1_backward_plan_covers_every_row_once(sms, c):
    """K1's backward cuts each sample's rows into one slab per block: the
    slabs cover every row once, none is empty, and the grid stays within the
    blocks the card keeps co-resident (two an SM, one above
    BWD_WIDE_CHANNELS channels)."""
    per_sm = 1 if c > tfn.BWD_WIDE_CHANNELS else 2
    for n in (1, 7, 263, 264, 265, 4096, 16384, 100_003, 512 * 512):
        slabs, rows = tfn.bwd_plan(n, c, sms)
        assert 1 <= slabs <= per_sm * sms
        starts = [s * rows for s in range(slabs)]
        ends = [min(n, st + rows) for st in starts]
        assert starts[0] == 0 and ends[-1] == n
        assert all(e > s for s, e in zip(starts, ends))
        assert all(e == s2 for e, s2 in zip(ends, starts[1:]))
