"""The port's DDPM U-Net (m_cedm_tpu_torch/models/ddpm_unet.py) against the
JAX package's at res 16, ch 32, ch_mult [1, 1], attention at 8 (32 groups:
one channel a group at 32 channels, two at the 64-channel concat), with
seeded non-zero parameters carried across by convert.py.

- The whole forward against JAX's DdpmUNet (its XLA path on the CPU), with
  self-conditioning on and off and with one concatenated cond channel.
- The same forward with operations that honour chained statistics as the
  kernels do (mean and variance from the producer's channel sums), so the
  statistics the port chains across the temb add and the decoder concat's
  halves are held on the CPU too: a wrong adjustment moves the output.
- One ResnetBlock (identity 64 -> 64; projection over a 128-channel concat
  -> 64) against JAX's `_paired` route, whose Pallas kernels chain the
  adjusted statistics, forced on in interpret mode: forward, and the
  gradients of x, temb and every parameter against jax.vjp.
- AttnBlock against JAX's (attention_reference), Downsample's (0, 1, 0, 1)
  pad and stride-2 valid conv, Upsample, build_backbone's routing, the
  paths that raise, and the fused calls per forward at the full config's
  structure (chip_smoke.py's launch counts).

Tolerances: a forward to 1e-5 of its scale (fp32 on both sides, another
summation order); with chained statistics (E[x^2] - mean^2, one pass) to
1e-4; gradients to 1e-4 of each one's largest magnitude.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.models import ddpm_unet as jddpm
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.kernels import DEVICE_OPS, PLAIN_OPS
from m_cedm_tpu_torch.kernels.fused_norm import (gn_silu_plain,
                                                 group_mean_rstd_from_sums)
from m_cedm_tpu_torch.kernels.fused_norm_conv import (gn_silu_conv_plain,
                                                      narrow_route)
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.models import ddpm_unet as tddpm
from m_cedm_tpu_torch.models.adm_unet import AdmUNet
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, B = 16, 2


def hparams(self_cond=False, cond_channels=0, res=RES, ch=32, ch_mult=(1, 1),
            attn=(8,), in_channels=2, **extra):
    return {"name": "ddim",
            "model": {"in_channels": in_channels, "out_ch": in_channels, "ch": ch,
                      "ch_mult": list(ch_mult), "num_res_blocks": 1,
                      "attn_resolutions": list(attn), "resolution": res,
                      "dropout": 0.0, "self_cond": self_cond,
                      "cond_channels": cond_channels,
                      "cat_cond": cond_channels > 0, **extra},
            "diffusion": {"num_diffusion_timesteps": 1000}}


def seeded(shapes, seed):
    """Non-zero fan-in-scaled parameters: norm scales about 1, biases about 0."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if len(a.shape) > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-12)
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def stats_gn_silu_conv(x, gamma, beta, w, bias, num_groups=0, eps=1e-5, *,
                       stats=None, residual=None, res_up=False, skip_w=None,
                       skip_b=None, emit_stats=False):
    """K2's plain version, but normalizing with the chained statistics where
    they are given, as the kernel does."""
    if gamma is not None and stats is not None:
        b, h, wd, _ = x.shape
        mean, rstd = group_mean_rstd_from_sums(*stats, h * wd, num_groups, eps)
        a = ((x - mean[:, None, None]) * rstd[:, None, None] * gamma[:, None, None]
             + beta[:, None, None])
        x, gamma, beta = a * torch.sigmoid(a), None, None
    return gn_silu_conv_plain(x, gamma, beta, w, bias, num_groups, eps,
                              residual=residual, res_up=res_up, skip_w=skip_w,
                              skip_b=skip_b, emit_stats=emit_stats)


def stats_gn_silu(x, gamma, beta, num_groups, eps=1e-5, stats=None):
    if stats is None:
        return gn_silu_plain(x, gamma, beta, num_groups, eps)
    mean, rstd = group_mean_rstd_from_sums(*stats, x.shape[1], num_groups, eps)
    a = (x - mean[:, None]) * rstd[:, None] * gamma[:, None] + beta[:, None]
    return a * torch.sigmoid(a)


STATS_OPS = dataclasses.replace(PLAIN_OPS, gn_silu_conv=stats_gn_silu_conv,
                                gn_silu=stats_gn_silu)


@pytest.fixture(scope="module")
def jax_forwards():
    """JAX's forward of each input variant, with its seeded params."""
    out = {}
    rs = np.random.RandomState(0)
    x = rs.randn(B, RES, RES, 2).astype(np.float32)
    sc = rs.randn(B, RES, RES, 2).astype(np.float32)
    cond = rs.randn(B, RES, RES, 1).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    for name, kw in (("plain", {}), ("self_cond", {"self_cond": True}),
                     ("cat_cond", {"cond_channels": 1})):
        hp = hparams(**kw)
        model = jddpm.DdpmUNet(jddpm.DdpmUNetConfig.from_hparams(to_dotdict(hp)))
        c = cond if kw.get("cond_channels") else None
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t, c)
        params = seeded(shapes, 1)
        x_sc = sc if kw.get("self_cond") else None
        want = np.asarray(model.apply(params, x, t, c, x_self_cond=x_sc))
        out[name] = (hp, params, (x, t, c, x_sc), want)
    return out


def port_model(hp, params, ops=DEVICE_OPS):
    model = tddpm.DdpmUNet(tddpm.DdpmUNetConfig.from_hparams(hp), ops)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def run(model, args):
    x, t, c, x_sc = (None if a is None else torch.from_numpy(a) for a in args)
    return model(x, t, c, x_sc).detach().numpy()


@pytest.mark.parametrize("variant", ["plain", "self_cond", "cat_cond"])
def test_forward_matches_jax(jax_forwards, variant):
    hp, params, args, want = jax_forwards[variant]
    model = port_model(hp, params)
    assert model.cfg.total_in_channels == {"plain": 2, "self_cond": 4, "cat_cond": 3}[variant]
    close(run(model, args), want, 1e-5, variant)
    assert model.calls == 1


@pytest.mark.parametrize("variant", ["plain", "self_cond"])
def test_forward_with_chained_statistics_matches_jax(jax_forwards, variant):
    hp, params, args, want = jax_forwards[variant]
    got = run(port_model(hp, params, STATS_OPS), args)
    close(got, want, 1e-4, variant)
    # the chained statistics are used: a wrong temb adjustment shows
    bad = dataclasses.replace(STATS_OPS, gn_silu_conv=lambda *a, stats=None, **k:
                              stats_gn_silu_conv(*a, stats=None if stats is None else
                                                 (stats[0], stats[1] * 1.01), **k))
    assert np.abs(run(port_model(hp, params, bad), args) - want).max() > 1e-3 * np.abs(want).max()


# --- one ResnetBlock against JAX's paired kernels in interpret mode -----------

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


@pytest.mark.parametrize("c_in,c_out", [(64, 64), (128, 64)], ids=["identity", "projection"])
def test_resnet_block_matches_paired_route(interpret, monkeypatch, c_in, c_out):
    temb_ch = 4 * 32
    rs = np.random.RandomState(c_in)
    x = rs.randn(B, RES, RES, c_in).astype(np.float32)
    temb = rs.randn(B, temb_ch).astype(np.float32)
    cot = rs.randn(B, RES, RES, c_out).astype(np.float32)
    blk = jddpm.ResnetBlock(c_out)
    params = seeded(jax.eval_shape(blk.init, jax.random.PRNGKey(0), x, temb), 2)
    # the paired route runs (it emits and chains the statistics)
    called = []
    monkeypatch.setattr(jddpm.ResnetBlock, "_paired",
                        lambda self, *a, _f=jddpm.ResnetBlock._paired, **k:
                        called.append(1) or _f(self, *a, **k))
    want, vjp = jax.vjp(lambda p, xx, tt: blk.apply(p, xx, tt), params, x, temb)
    dp, dx, dtemb = vjp(jnp.asarray(cot))
    assert called

    port = tddpm.ResnetBlock(c_in, c_out, temb_ch)
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    assert (port.nin_shortcut is None) == (c_in == c_out)
    for ops in (STATS_OPS, DEVICE_OPS):
        got, _ = port(torch.from_numpy(x), torch.from_numpy(temb), None, ops)
        close(got.detach().numpy(), want, 1e-5, "forward")
    xt, tt = (torch.from_numpy(a).requires_grad_() for a in (x, temb))
    out, _ = port(xt, tt, None, DEVICE_OPS)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(out, [xt, tt] + list(port.parameters()),
                                torch.from_numpy(cot))
    close(grads[0].numpy(), dx, 1e-4, "dx")
    close(grads[1].numpy(), dtemb, 1e-4, "dtemb")
    dp = jax_params_to_state_dict(dp)
    for name, g in zip(names, grads[2:]):
        close(g.numpy(), dp[name].numpy(), 1e-4, name)


# --- the other layers ------------------------------------------------------------

def test_attn_block_matches_jax():
    x = np.random.RandomState(3).randn(B, 8, 8, 32).astype(np.float32)
    blk = jddpm.AttnBlock()
    params = seeded(jax.eval_shape(blk.init, jax.random.PRNGKey(0), x), 4)
    port = tddpm.AttnBlock(32)
    sd = jax_params_to_state_dict(params)
    assert "attn_norm.weight" in sd
    port.load_state_dict(sd, strict=True)
    close(port(torch.from_numpy(x), DEVICE_OPS).detach().numpy(),
          blk.apply(params, x), 1e-5)


@pytest.mark.parametrize("with_conv", [True, False])
def test_downsample_matches_jax(with_conv):
    rs = np.random.RandomState(5)
    x = rs.randn(B, RES, RES, 8).astype(np.float32)
    mod = jddpm.Downsample(with_conv)
    params = seeded(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x), 6)
    want = np.asarray(mod.apply(params, x))
    port = tddpm.Downsample(8, with_conv)
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (B, RES // 2, RES // 2, 8)
    close(got, want, 1e-5)
    if with_conv:
        # the pad is (0, 1, 0, 1): output (0, 0) sees input rows and columns
        # 0..2, so a change at the last row reaches the last output row only
        x2 = x.copy()
        x2[:, -1] += 1.0
        diff = np.abs(port(torch.from_numpy(x2)).detach().numpy() - got)
        assert diff[:, :-1].max() == 0.0 and diff[:, -1].max() > 0.0


def test_upsample_matches_jax():
    x = np.random.RandomState(7).randn(B, 8, 8, 16).astype(np.float32)
    mod = jddpm.Upsample(True)
    params = seeded(jax.eval_shape(mod.init, jax.random.PRNGKey(0), x), 8)
    port = tddpm.Upsample(16, True)
    port.load_state_dict(jax_params_to_state_dict(params), strict=True)
    close(port(torch.from_numpy(x), DEVICE_OPS).detach().numpy(), mod.apply(params, x), 1e-5)


def test_build_backbone_routes_by_name():
    model, cfg = build_backbone(hparams(self_cond=True))
    assert isinstance(model, tddpm.DdpmUNet) and cfg.total_in_channels == 4
    adm = dict(hparams(), name="adm_x")
    assert isinstance(build_backbone(adm)[0], AdmUNet)
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert float(model.conv_out.weight.detach().abs().max()) > 0.0  # not zero


@pytest.mark.parametrize("extra", [{"type": "bayesian"}, {"dx_cond": True},
                                   {"cond_channels": 1, "cat_cond": False}])
def test_unported_options_raise(extra):
    hp = hparams()
    hp["model"].update(extra)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_backbone(hp)


def test_training_with_dropout_and_circular_padding_raise():
    model, _ = build_backbone(hparams(dropout=0.1))
    model.train()
    x = torch.zeros(1, RES, RES, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model(x, torch.zeros(1))
    model.eval()
    assert model(x, torch.zeros(1)).shape == x.shape  # dropout is off in eval
    # circular padding serves only the cond encoder, which raises at build
    with pytest.raises(NotImplementedError, match="cond-encoder.*ROADMAP.md"):
        build_backbone(hparams(cond_channels=1, cat_cond=False))


# --- fused calls per forward, at the full config's structure ------------------------

def counting_ops(counts):
    """PLAIN_OPS that count the fused calls as the kernel wrappers count their
    launches: gnsc_kernel or the narrow kernel by K2's route, K1's
    statistics pass where an activated K2 call comes without statistics."""

    def gnsc(x, gamma, beta, w, bias, *a, stats=None, residual=None, **k):
        if narrow_route(x.shape[-1], w.shape[-1], gamma is not None, residual is not None):
            counts["K2 narrow_conv"] += 1
        else:
            counts["K2 gn_silu_conv"] += 1
            if gamma is not None and stats is None:
                counts["K1 channel_stats"] += 1
        return PLAIN_OPS.gn_silu_conv(x, gamma, beta, w, bias, *a, stats=stats,
                                      residual=residual, **k)

    def wrap(name, fn):
        def f(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return f

    return dataclasses.replace(
        PLAIN_OPS, gn_silu_conv=gnsc,
        gn_silu=wrap("K1 gn_silu", PLAIN_OPS.gn_silu),
        attention=wrap("K4 attention", PLAIN_OPS.attention),
        channel_stats=wrap("K1 channel_stats", PLAIN_OPS.channel_stats))


def test_fused_calls_per_forward_match_chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    # the full config's structure (three levels, one block each, attention
    # at the lowest) at res 32
    for name in ("DDIM_HPARAMS", "DDIM_COND_HPARAMS", "EDM_COND_HPARAMS"):
        hp = getattr(chip_smoke, name)
        m = dict(hp["model"], resolution=32, attn_resolutions=[8])
        counts = dict.fromkeys(chip_smoke.DDPM_PER_FORWARD, 0)
        model, cfg = build_backbone(dict(hp, model=m), counting_ops(counts))
        x = torch.zeros(1, 32, 32, cfg.in_channels)
        cond = torch.zeros(1, 32, 32, cfg.cond_channels) if cfg.cond_channels else None
        model(x, torch.ones(1), cond)
        assert counts == chip_smoke.DDPM_PER_FORWARD, name
