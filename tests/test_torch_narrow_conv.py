"""K2's narrow-channel route (csrc/narrow_conv.cu): the rule that sends the
U-Net's conv_in and out conv to it, and its plain versions against the JAX
package at res 16.

  conv_in   C in {2, 4} -> 64 with its emitted statistics, against
            fused_block_paired(act=False, emit_stats=True) with the Pallas
            kernels forced on in interpret mode (C = 4 runs the paired
            Pallas kernel; at C = 2 the paired input has 4 channels, under
            its 8-channel minimum, so it takes its own reference, as the
            JAX U-Net's conv_in does there);
  out conv  64 -> O in {1, 2} against paired_out_conv (an XLA conv), and
            its dx, dW and db against jax.vjp of it.

On the CPU the route runs the narrow kernel's plain versions; the kernel
itself is held to them on the card by tests/test_torch_cuda.py and
chip_smoke.py. Tolerances: fp32 on both sides, another summation order
(a conv output sums 9 * C products, a statistic or a weight gradient a few
hundred pixels): outputs rtol 1e-5 / atol 1e-5, sums of squares rtol 1e-5 /
atol 1e-4, gradients 1e-5 of each one's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RES, B = 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SQ = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    """Force the Pallas kernels on and run them in interpret mode (CPU)."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    monkeypatch.setattr(jfn.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfnc.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfn, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jfnc, "pallas_enabled", lambda: True)


def _arrays(seed, c, o):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, RES, RES, c).astype(np.float32)
    w = (rs.randn(3, 3, c, o) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.3 * rs.randn(o)).astype(np.float32)
    cot = rs.randn(B, RES, RES, o).astype(np.float32)
    return x, w, bias, cot


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale


# --- the route -----------------------------------------------------------

@pytest.mark.parametrize("c,o,act,residual,want", [
    (4, 64, False, False, True),    # the flagship's conv_in
    (2, 64, False, False, True),    # adm_edm_cond_h's conv_in
    (64, 2, False, False, True),    # the flagship's out conv
    (64, 1, False, False, True),    # CondEdmTask's out conv
    (8, 8, False, False, True),
    (1, 512, False, False, True),
    (512, 8, False, False, True),
    (64, 64, False, False, False),  # the down blocks' conv0
    (9, 9, False, False, False),
    (4, 64, True, False, False),    # GroupNorm + SiLU first
    (64, 2, False, True, False),    # a residual tail
    (4, 4, True, True, False),
])
def test_narrow_route(c, o, act, residual, want):
    assert tfnc.narrow_route(c, o, act, residual) is want


@pytest.mark.parametrize("c,o,want", [
    (64, 2, True), (64, 1, True), (8, 8, True), (512, 8, True),
    (4, 64, False), (2, 64, False), (64, 64, False)])
def test_narrow_backward_route(c, o, want):
    assert tfnc.narrow_bwd_route(c, o, False, False) is want


def test_unet_sends_conv_in_and_out_conv_to_the_narrow_route(monkeypatch):
    """A small U-Net (4 input channels, ch 16, 2 outputs) forward and
    backward on the CPU: the narrow plain versions see exactly conv_in and
    the out conv (its backward: the out conv only), K2's every other call,
    the down block's linear conv0 among them, has C > 8 and O > 8."""
    seen = {"narrow": [], "narrow_bwd": [], "k2": [], "k2_bwd": []}

    def spy(key, fn, shapes):
        def call(*a, **k):
            seen[key].append(shapes(*a))
            return fn(*a, **k)
        monkeypatch.setattr(tfnc, fn.__name__, call)

    spy("narrow", tfnc.narrow_conv_plain, lambda x, w, *_: (x.shape[-1], w.shape[-1]))
    spy("narrow_bwd", tfnc.narrow_conv_bwd_plain,
        lambda g, x, w, *_: (x.shape[-1], w.shape[-1]))
    spy("k2", tfnc.gn_silu_conv_plain,
        lambda x, gamma, beta, w, *_: (x.shape[-1], w.shape[-1], gamma is not None))
    spy("k2_bwd", tfnc.gn_silu_conv_bwd_plain,
        lambda g, x, gamma, beta, w, *_: (x.shape[-1], w.shape[-1], gamma is not None))

    cfg = AdmUNetConfig(in_channels=2, out_ch=2, ch=16, ch_mult=(1, 1),
                        num_res_blocks=1, attn_resolutions=(), resolution=RES,
                        cond_channels=2, cat_cond=True)
    model = AdmUNet(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    x, cond = (torch.from_numpy(rs.randn(B, RES, RES, 2).astype(np.float32))
               for _ in range(2))
    model(x, torch.tensor([0.5, -1.0]), cond).sum().backward()

    assert seen["narrow"] == [(4, 16), (16, 2)]
    assert seen["narrow_bwd"] == [(16, 2)]
    assert all(c > 8 and o > 8 for c, o, _ in seen["k2"])
    assert (16, 16, False) in seen["k2"]         # the down block's conv0
    assert (4, 16, False) in seen["k2_bwd"]      # conv_in's weight gradient
    assert all(o > 8 for _, o, _ in seen["k2_bwd"])


# --- the plain versions against the JAX package ---------------------------

@pytest.mark.parametrize("c", [2, 4])
def test_conv_in_matches_fused_block_paired(interpret, c):
    x, w, bias, _ = _arrays(30 + c, c, 64)
    outp, sums, sumsq = jfnc.fused_block_paired(
        jfnc.pair_array(jnp.asarray(x)), None, None, jnp.asarray(w),
        jnp.asarray(bias), 1, act=False, emit_stats=True)
    got, (gs, gss) = tfnc.narrow_conv(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(bias), emit_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfnc.unpair_array(outp)), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(sums), **TOL_SQ)
    np.testing.assert_allclose(gss.numpy(), np.asarray(sumsq), **TOL_SQ)


@pytest.mark.parametrize("o", [1, 2])
def test_out_conv_matches_paired_out_conv(o):
    y, w, bias, _ = _arrays(40 + o, 64, o)
    want = jfnc.paired_out_conv(jfnc.pair_array(jnp.asarray(y)), jnp.asarray(w),
                                jnp.asarray(bias))
    got = tfnc.narrow_conv(torch.from_numpy(y), torch.from_numpy(w),
                           torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("o", [1, 2])
def test_out_conv_backward_matches_jax_vjp(o):
    y, w, bias, cot = _arrays(50 + o, 64, o)
    _, vjp = jax.vjp(jfnc.paired_out_conv, jfnc.pair_array(jnp.asarray(y)),
                     jnp.asarray(w), jnp.asarray(bias))
    dyp, dw, db = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (y, w, bias)]
    got = torch.autograd.grad(tfnc.narrow_conv(*leaves), leaves, torch.from_numpy(cot))
    for a, want in zip(got, (jfnc.unpair_array(dyp), dw, db)):
        _close(a.numpy(), want)
