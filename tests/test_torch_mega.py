"""Port parity of K7, the whole-block megakernel, on the CPU.

- `fused_unet_block_plain` against the JAX `_pallas_mega` run in interpret
  mode (forced as tests/test_pallas.py::TestMegaBlock forces it: patched and
  restored, the JAX package untouched) and against
  `fused_unet_block_reference`, at that class's shapes and variants.
- The wrapper's recompute backward against JAX's gradients through
  `_mega_bwd` (jax.vjp of `fused_unet_block`).
- `AdmUNet(mega=True)` under no_grad against the JAX AdmUNet with
  MCEDM_MEGA=1 (on the CPU its blocks run the reference composition), with
  seeded non-zero weights through convert.py; against the port's own
  per-conv path; and the routing of its blocks.

Tolerances: 1e-5 of the output's scale against the reference (fp32, two
chained convs in another summation order); the JAX package's own rtol/atol
2e-4 against interpret mode (its chained-stats norm uses E[x^2] - mean^2);
1e-4 of each gradient's scale for the backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_block as jfb
from m_cedm_tpu.models.adm_unet import AdmUNet as JaxUNet
from m_cedm_tpu.models.adm_unet import AdmUNetConfig as JaxConfig
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.kernels import DEVICE_OPS
from m_cedm_tpu_torch.kernels import fused_block as tfb
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ("x", "g0", "b0", "w0", "bias0", "g1", "b1", "w1", "bias1")
# (B, H, W, C1, C2, O, up, proj, chained stats, emit): test_pallas.py:839-972
CASES = {
    "identity": (2, 32, 16, 16, 0, 16, False, False, False, False),
    "dual-proj-stats-emit": (2, 32, 16, 16, 8, 24, False, True, True, True),
    "up-identity": (2, 16, 8, 16, 0, 16, True, False, False, False),
    "up-proj-emit": (2, 16, 8, 16, 0, 16, True, True, False, True),
}


def block_inputs(case, seed=5):
    b, h, w, c1, c2, o, up, proj, chained, emit = CASES[case]
    rs = np.random.RandomState(seed)
    c = c1 + c2

    def t(*shape, sc=0.1, sh=0.0):
        return (sh + sc * rs.randn(*shape)).astype(np.float32)

    arrs = dict(x=t(b, h, w, c1, sc=1.0), g0=t(b, c, sh=1.0), b0=t(b, c),
                w0=t(3, 3, c, o), bias0=t(o), g1=t(b, o, sh=1.0), b1=t(b, o),
                w1=t(3, 3, o, o), bias1=t(o))
    if c2:
        arrs["x2"] = t(b, h, w, c2, sc=1.0)
    if proj:
        arrs["skip_w"], arrs["skip_b"] = t(c, o), t(o)
    if chained:
        xin = np.concatenate([arrs["x"]] + ([arrs["x2"]] if c2 else []), -1)
        xin = xin.reshape(b, h * w, c).astype(np.float64)
        arrs["stats"] = (xin.sum(1).astype(np.float32),
                         (xin * xin).sum(1).astype(np.float32))
    return arrs, dict(emit_stats=emit, up=up)


def call(fn, arrs, flags, conv):
    """fn(*ARGS, 4, 4, 1e-5, x2=, skip_w=, skip_b=, [stats=], **flags) with
    arrays converted by `conv`; returns a list of numpy outputs."""
    kw = {k: (tuple(map(conv, arrs[k])) if k == "stats" else conv(arrs[k]))
          for k in ("x2", "skip_w", "skip_b", "stats") if k in arrs}
    out = fn(*(conv(arrs[k]) for k in ARGS), 4, 4, 1e-5, **kw, **flags)
    flat = [out] if not isinstance(out, tuple) else (
        [out[0], *out[1]] if isinstance(out[1], tuple) else list(out))
    return [np.asarray(a) for a in flat]


def force_interpret():
    """tests/test_pallas.py::TestMegaBlock._force_interpret: run the Pallas
    calls in interpret mode; returns the function that restores them."""
    from jax.experimental import pallas as pl
    import m_cedm_tpu.pallas.fused_norm as fn
    import m_cedm_tpu.pallas.fused_norm_conv as fnc

    orig_call, orig_enabled = pl.pallas_call, fn.pallas_enabled
    fn.pallas_enabled = lambda: True
    pl.pallas_call = lambda *a, **k: orig_call(*a, **{**k, "interpret": True})
    for mod in (fn, fnc, jfb):
        mod.pl.pallas_call = pl.pallas_call

    def restore():
        pl.pallas_call = orig_call
        for mod in (fn, fnc, jfb):
            mod.pl.pallas_call = orig_call
        fn.pallas_enabled = orig_enabled

    return restore


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_and_reference(case):
    arrs, flags = block_inputs(case)
    got = call(tfb.fused_unet_block_plain, arrs, flags, torch.from_numpy)
    ref_arrs = {k: v for k, v in arrs.items() if k != "stats"}
    want = call(jfb.fused_unet_block_reference, ref_arrs, flags, jnp.asarray)
    restore = force_interpret()
    try:
        interp = call(jfb._pallas_mega, arrs, flags, jnp.asarray)
    finally:
        restore()
    b, h, w, _, _, o, up = CASES[case][:7]
    assert got[0].shape == ((b, 2 * h, 2 * w, o) if up else (b, h, w, o))
    assert len(got) == len(want) == len(interp) == (3 if flags["emit_stats"] else 1)
    for g, r, i in zip(got, want, interp):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
        np.testing.assert_allclose(g, i, rtol=2e-4, atol=2e-4 if g is got[0] else 5e-3)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        call(tfb.fused_unet_block, arrs, flags, torch.from_numpy)[0], got[0])


@pytest.mark.parametrize("case", ["dual-proj-stats-emit", "up-proj-emit"])
def test_recompute_backward_matches_mega_bwd(case):
    arrs, flags = block_inputs(case, seed=7)
    diff = [k for k in ARGS + ("x2", "skip_w", "skip_b") if k in arrs]
    b, h, w, _, _, o, up = CASES[case][:7]
    hout, wout = (2 * h, 2 * w) if up else (h, w)
    g = np.random.RandomState(8).randn(b, hout, wout, o).astype(np.float32)
    fixed = {k: v for k, v in arrs.items() if k not in diff}

    def jax_out(*vals):
        d = dict(fixed, **dict(zip(diff, vals)))
        kw = {k: d[k] for k in ("x2", "skip_w", "skip_b") if k in d}
        if "stats" in d:
            kw["stats"] = tuple(map(jnp.asarray, d["stats"]))
        out = jfb.fused_unet_block(*(d[k] for k in ARGS), 4, 4, 1e-5, **kw, **flags)
        return out[0] if flags["emit_stats"] else out

    want = jax.jit(lambda *v: jax.vjp(jax_out, *v)[1](jnp.asarray(g)))(
        *(jnp.asarray(arrs[k]) for k in diff))
    leaves = {k: torch.from_numpy(arrs[k]).requires_grad_() for k in diff}
    d = dict(fixed, **leaves)
    kw = {k: d[k] for k in ("x2", "skip_w", "skip_b") if k in d}
    if "stats" in d:
        kw["stats"] = tuple(map(torch.from_numpy, d["stats"]))
    out = tfb.fused_unet_block(*(d[k] for k in ARGS), 4, 4, 1e-5, **kw, **flags)
    out = out[0] if flags["emit_stats"] else out
    got = torch.autograd.grad(out, [leaves[k] for k in diff], torch.from_numpy(g))
    for k, a, w_ in zip(diff, got, want):
        w_ = np.asarray(w_)
        assert np.abs(a.numpy() - w_).max() <= 1e-4 * np.abs(w_).max(), k


def test_wrapper_refuses_what_k7_does_not_take():
    arrs, _ = block_inputs("dual-proj-stats-emit")
    args = [torch.from_numpy(arrs[k]) for k in ARGS]
    x2 = torch.from_numpy(arrs["x2"])
    with pytest.raises(ValueError, match="up with x2"):
        tfb.fused_unet_block(*args, 4, 4, x2=x2, skip_w=torch.zeros(24, 24), up=True)
    with pytest.raises(ValueError, match="identity skip"):
        tfb.fused_unet_block(*args, 4, 4, x2=x2[..., :4].contiguous())


# --- the U-Net's megakernel mode ---------------------------------------------

RES, B = 32, 2
# ch 64: ADM's attention has one head per 64 channels, so narrower nets have
# none, and the blocks after an attention site (no chained stats) go untested
KW = dict(in_channels=2, out_ch=2, ch=64, ch_mult=(1, 1), num_res_blocks=1,
          attn_resolutions=(16,), resolution=RES, cond_channels=2, cat_cond=True)


def seeded(params, seed):
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def unets():
    rs = np.random.RandomState(11)
    x = rs.randn(B, RES, RES, 2).astype(np.float32)
    cond = rs.randn(B, RES, RES, 2).astype(np.float32)
    sigma = rs.uniform(-1.5, 1.0, B).astype(np.float32)
    jm = JaxUNet(JaxConfig(**KW))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(sigma), jnp.asarray(cond))
    params = seeded(shapes, 3)
    sd = jax_params_to_state_dict(params)
    mega, plain = AdmUNet(AdmUNetConfig(**KW), mega=True), AdmUNet(AdmUNetConfig(**KW))
    for m in (mega, plain):
        m.load_state_dict(sd, strict=True)  # the parameter names are unchanged
    return jm, params, mega, plain, (x, sigma, cond)


@pytest.fixture(scope="module")
def jax_mega(unets):
    """The JAX U-Net's output with MCEDM_MEGA=1, and the `up` flag of each
    of its blocks that took the megakernel path."""
    jm, params, _, _, (x, sigma, cond) = unets
    traced = []
    orig = jfb.fused_unet_block
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCEDM_MEGA", "1")
        mp.setattr(jfb, "fused_unet_block",
                   lambda *a, **k: traced.append(k["up"]) or orig(*a, **k))
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(sigma),
                                            jnp.asarray(cond)))
    return want, traced


def test_mega_unet_matches_jax_mega(unets, jax_mega):
    _, _, mega, plain, (x, sigma, cond) = unets
    want, traced = jax_mega
    assert len(traced) == 9 and sum(traced) == 1  # every non-down block, one up
    with torch.no_grad():
        args = tuple(map(torch.from_numpy, (x, sigma, cond)))
        got, per_conv = mega(*args).numpy(), plain(*args).numpy()
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - per_conv).max() <= 1e-5 * scale
    assert mega.state_dict().keys() == plain.state_dict().keys()


def test_mega_routes_every_non_down_block_through_unet_block(unets):
    """ch_mult (1, 1): of the ten blocks, nine run as one unet_block call;
    the down block and conv_in / out_conv take K2 (four calls), and no K3
    runs. With gradients on, the per-conv path runs instead."""
    _, _, mega, _, (x, sigma, cond) = unets
    counts = dict.fromkeys(("unet_block", "gn_silu_conv", "gn_silu_up_conv"), 0)

    def spy(name):
        fn = getattr(DEVICE_OPS, name)

        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    mega.ops = dataclasses.replace(DEVICE_OPS, **{n: spy(n) for n in counts})
    args = tuple(map(torch.from_numpy, (x, sigma, cond)))
    try:
        with torch.no_grad():
            mega(*args)
        assert counts == {"unet_block": 9, "gn_silu_conv": 4, "gn_silu_up_conv": 0}
        counts.update(dict.fromkeys(counts, 0))
        mega(*args)
        assert counts == {"unet_block": 0, "gn_silu_conv": 21, "gn_silu_up_conv": 1}
    finally:
        mega.ops = DEVICE_OPS


def _stats_passes(name, args, kw):
    """The K1 statistics passes an op runs on the card: channel_stats is
    one; a kernel wrapper given no chained statistics runs one per input of
    its norm (K7 with x2: two; K2's linear mode has no norm)."""
    if name == "channel_stats":
        return 1
    if kw.get("stats") is not None:
        return 0
    if name == "unet_block":
        return 2 if kw.get("x2") is not None else 1
    if name == "gn_silu_conv":
        return int(args[1] is not None)
    return 1


def test_mega_unet_runs_the_per_conv_paths_stats_passes(unets, jax_mega):
    """A decoder block whose trunk or encoder skip comes with statistics
    runs K1 over the other half alone, as the per-conv path runs it over
    the concat once: five passes a forward on both paths (seven before,
    when the known half's were dropped). The mega output still matches the
    JAX U-Net with MCEDM_MEGA=1."""
    _, _, mega, plain, (x, sigma, cond) = unets
    names = ("channel_stats", "unet_block", "gn_silu_conv", "gn_silu_up_conv", "gn_silu")
    passes = {}

    def spy(model, path):
        def wrap(name):
            fn = getattr(DEVICE_OPS, name)

            def call(*a, **k):
                passes[path] += _stats_passes(name, a, k)
                return fn(*a, **k)
            return call
        model.ops = dataclasses.replace(DEVICE_OPS, **{n: wrap(n) for n in names})

    args = tuple(map(torch.from_numpy, (x, sigma, cond)))
    outs = {}
    try:
        with torch.no_grad():
            for path, model in (("mega", mega), ("per_conv", plain)):
                passes[path] = 0
                spy(model, path)
                outs[path] = model(*args).numpy()
    finally:
        mega.ops = plain.ops = DEVICE_OPS
    assert passes == {"mega": 5, "per_conv": 5}
    want, _ = jax_mega
    assert np.abs(outs["mega"] - want).max() <= 1e-5 * np.abs(want).max()


def test_build_backbone_takes_mega():
    hp = {"name": "adm_edm_mcedm", "model": dict(KW, ch_mult=[1, 1],
                                                 attn_resolutions=[16])}
    assert build_backbone(hp, mega=True)[0].mega
    assert not build_backbone(hp)[0].mega
