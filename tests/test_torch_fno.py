"""The port's FNO modules against the JAX package's (flax), on the CPU: the
truncated-DFT matrices, the spectral conv on both of its routes, FnoState2d
(instance norm on and off, padding_x, spacings and grids) and Fno2d, from
one seeded parameter tree carried across with convert.py.

The JAX package picks its spectral route from MCEDM_FNO_DFT as well as the
shape; every case sets it explicitly, so a stray environment cannot change
the reference route. The port reads no environment: its route follows the
shape alone.

Tolerances: the DFT matrices to 1e-7 (both are float64 numpy cast to
fp32); every module output to 1e-5 of its scale (both sides fp32, the
same contractions in another summation order).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.models import fno as jfno
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.models import fno as tfno
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, X, T = 2, 32, 32
WIDTH, LAYERS, MODES = 16, 2, 4


def seeded(params, seed):
    """Seeded non-zero values in the shape of a flax parameter tree, scaled
    so the spectral path carries as much as the 1x1 conv."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        name = path[-1].key
        if name.startswith("w"):  # spectral (in, out, m1, m2)
            return (rs.randn(*a.shape) / a.shape[0]).astype(np.float32)
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def carried(jmodule, tmodule, seed, *args):
    """Seeded params for the flax module, the same loaded into the port's."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args))
    params = seeded(shapes, seed)
    tmodule.load_state_dict(jax_params_to_state_dict(params))
    return params


@pytest.mark.parametrize("h,w,m1,m2", [(32, 36, 4, 4), (128, 132, 12, 12), (24, 22, 5, 6)])
def test_dft_mats_match_jax(h, w, m1, m2):
    got = tfno._dft_mats(h, w, m1, m2, torch.device("cpu"))
    want = jfno._dft_mats(h, w, m1, m2)
    for name, g, v in zip(("cw", "sw", "ch", "sh", "icw", "isw"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=0, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("h,w,m1,m2,jax_dft", [
    (32, 36, 4, 4, "1"),     # the corners fit: the DFT route on both sides
    (16, 20, 12, 4, "0"),    # 2 m1 > h: rfft2 on both sides
    (32, 36, 4, 4, "0"),     # the port's DFT route against JAX's rfft2 route
], ids=["dft", "fft", "dft_vs_jax_fft"])
def test_spectral_conv_matches_flax(monkeypatch, h, w, m1, m2, jax_dft):
    monkeypatch.setenv("MCEDM_FNO_DFT", jax_dft)
    x = np.random.RandomState(1).randn(B, h, w, 3).astype(np.float32)
    jm = jfno.SpectralConv2d(5, m1, m2)
    tm = tfno.SpectralConv2d(3, 5, m1, m2)
    params = carried(jm, tm, 2, jnp.asarray(x))
    assert tfno.dft_route(h, w, m1, m2) == (2 * m1 <= h)
    close(tm(torch.from_numpy(x)).detach(), jm.apply(params, jnp.asarray(x)), 1e-5,
          "spectral conv")


def test_the_two_routes_agree():
    """The module functions called directly on one input: the truncated DFT
    as matmuls against rfft2 / irfft2 (what chip_smoke.py holds on the
    card, in fp32 and float64)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, 32, 36, 4, generator=g, dtype=torch.float64)
    ws = [torch.randn(4, 6, 5, 5, generator=g, dtype=torch.float64) / 4 for _ in range(4)]
    want = tfno.spectral_conv_fft(x, *ws)
    close(tfno.spectral_conv_dft(x, *ws), want, 1e-12, "float64")
    close(tfno.spectral_conv_dft(x.float(), *(w.float() for w in ws)), want, 1e-5, "fp32")


def fno_cfg(**kw):
    base = dict(modes_1=MODES, modes_2=MODES, width=WIDTH, num_layers=LAYERS,
                time_history=T, padding_t=4)
    base.update(kw)
    return base


@pytest.mark.parametrize("inst_norm,padding_x,spacings", [
    (False, 0, False), (True, 0, False), (False, 3, True), (True, 2, True)])
def test_fno_state_matches_flax(monkeypatch, inst_norm, padding_x, spacings):
    monkeypatch.setenv("MCEDM_FNO_DFT", "1")
    kw = fno_cfg(inst_norm=inst_norm, padding_x=padding_x, input_size=2, state_size=3)
    jm, tm = jfno.FnoState2d(jfno.FnoConfig(**kw)), tfno.FnoState2d(tfno.FnoConfig(**kw))
    rs = np.random.RandomState(4)
    u = rs.randn(B, X, T, 2).astype(np.float32)
    coords = ((rs.rand(B).astype(np.float32) + 0.5, rs.rand(B).astype(np.float32) + 0.1)
              if spacings else (None, None))
    jargs = (jnp.asarray(u),) + tuple(None if c is None else jnp.asarray(c) for c in coords)
    params = carried(jm, tm, 5, *jargs)
    got = tm(torch.from_numpy(u), *(None if c is None else torch.from_numpy(c)
                                   for c in coords)).detach()
    assert got.shape == (B, T, X, 3)
    close(got, jm.apply(params, *jargs), 1e-5, "FnoState2d")


def test_fno2d_matches_flax(monkeypatch):
    monkeypatch.setenv("MCEDM_FNO_DFT", "1")
    kw = fno_cfg(time_history=8, time_future=4)
    jm, tm = jfno.Fno2d(jfno.FnoConfig(**kw)), tfno.Fno2d(tfno.FnoConfig(**kw))
    rs = np.random.RandomState(6)
    u = rs.randn(B, X, X, 8).astype(np.float32)
    dx, dy, dt = (rs.rand(B).astype(np.float32) for _ in range(3))
    jargs = tuple(map(jnp.asarray, (u, dx, dy, dt)))
    params = carried(jm, tm, 7, *jargs)
    got = tm(*map(torch.from_numpy, (u, dx, dy, dt))).detach()
    assert got.shape == (B, X, X, 4)
    close(got, jm.apply(params, *jargs), 1e-5, "Fno2d")


def test_init_and_config_rules():
    """The port's own init (torch's default for fc / conv, [0, 1/(in out))
    for the spectral weights), the flax gelu, bf16 refused, no environment
    switch."""
    cfg = tfno.FnoConfig(**fno_cfg())
    m = tfno.FnoState2d(cfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.fourier_0.w1_real.detach()
    assert 0 <= float(w.min()) and float(w.max()) < 1 / WIDTH ** 2
    assert float(m.fc0.weight.detach().abs().max()) <= 1 / np.sqrt(3)
    assert m.conv_0.weight.shape == (WIDTH, WIDTH)
    x = torch.linspace(-3, 3, 7)
    torch.testing.assert_close(tfno.gelu(x), torch.from_numpy(
        np.array(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True))))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfno.FnoConfig.from_hparams({"dtype": "bfloat16"})
    assert "MCEDM_" not in inspect.getsource(tfno)
