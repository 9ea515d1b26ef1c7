"""Port parity of the OFormer's modules and of its two linear-attention
kernels' plain versions against the JAX package, on the CPU.

K5 kv_dots and K6 apply_dots (plain forward and the autograd Functions'
backward) are held to the JAX Pallas kernels run in interpret mode at a
kernel-eligible shape, as tests/test_oformer.py runs them; every module
(RoPE, the token instance norm, LinearAttention with one and two heads,
CrossLinearAttention, FeedForward, the encoder, the decoder at one and three
forward steps) to its flax counterpart on parameters converted by convert.py
after every parameter was replaced by seeded non-zero values.

Tolerances: K5/K6 1e-5 relative on the forward and 2e-5 of each gradient's
largest magnitude (fp32, summation order only; the bounds of
tests/test_oformer.py's own interpret-mode check). Modules 1e-5 of the output
scale: fp32 on both sides, differing in summation order and in the
libraries' sin, cos and tanh; the encoder stacks four attention layers with
LayerNorms on their residuals, and its measured difference is a few 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.models import encoding as jenc
from m_cedm_tpu.models import oformer as jo
from m_cedm_tpu_torch import kernels
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.kernels import PLAIN_OPS
from m_cedm_tpu_torch.kernels import linear_attention as tla
from m_cedm_tpu_torch.models import encoding as tenc
from m_cedm_tpu_torch.models import oformer as to

B, T, X = 2, 8, 8
N = T * X
TOL = 1e-5


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: error {err:.3e} of scale {scale:.3e}"


def seeded(variables, seed):
    """Every parameter replaced by seeded non-zero values: kernels and
    embeddings fan-in-scaled normals, LayerNorm scales 1 + 0.1 N(0, 1),
    biases 0.1 N(0, 1). The frozen Fourier matrix keeps its JAX draw."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        a = np.asarray(a)
        if path[0].key == "constants":
            return a
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def load(module, variables):
    sd = jax_params_to_state_dict(variables)
    if "constants" in variables:
        sd.update(jax_params_to_state_dict(variables, "constants"))
    module.load_state_dict(sd)
    return module


def grid_pos():
    tg, xg = np.meshgrid(np.linspace(0, 1, T), np.linspace(0, 1, X), indexing="ij")
    pos = np.stack([tg, xg], -1).reshape(-1, 2).astype(np.float32)
    return np.broadcast_to(pos[None], (B, N, 2)).copy()


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --- K5 / K6 ---------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """The Pallas linear-attention kernels on, in interpret mode (CPU)."""
    from jax.experimental import pallas as pl

    from m_cedm_tpu.pallas import linear_attention as la

    monkeypatch.setenv("MCEDM_PALLAS", "1")
    orig = pl.pallas_call
    monkeypatch.setattr(la.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    return la


def test_kv_apply_match_pallas_forward_and_backward(interpret):
    la = interpret
    bh, n, d, e = 2, la._TN, 128, 128
    q, k = randn(0, bh, n, d), randn(1, bh, n, d)
    v, g = randn(2, bh, n, e), randn(3, bh, n, e)
    assert la._use_kernel(jnp.asarray(k))

    def jax_fn(q_, k_, v_):
        return jnp.sum(la.apply_dots(q_, la.kv_dots(k_, v_) / n) * g)

    dots_j = np.asarray(la.kv_dots(jnp.asarray(k), jnp.asarray(v)))
    out_j = np.asarray(la.apply_dots(jnp.asarray(q), jnp.asarray(dots_j)))
    np.testing.assert_allclose(tla.kv_dots_plain(_t(k), _t(v)).numpy(), dots_j,
                               rtol=1e-5, atol=1e-5 * np.abs(dots_j).max())
    np.testing.assert_allclose(tla.apply_dots_plain(_t(q), _t(dots_j)).numpy(), out_j,
                               rtol=1e-5, atol=1e-5 * np.abs(out_j).max())

    grads_j = jax.grad(jax_fn, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    loss = torch.sum(tla.apply_dots(qt, tla.kv_dots(kt, vt) / n) * _t(g))
    np.testing.assert_allclose(float(loss.detach()), float(jax_fn(*map(jnp.asarray, (q, k, v)))),
                               rtol=1e-5)
    for got, want, name in zip(torch.autograd.grad(loss, (qt, kt, vt)), grads_j, "qkv"):
        _close(got, want, 2e-5, f"d{name}")


def test_kernel_functions_backward_is_the_other_primitive():
    """The Functions' backward on the CPU: the formulas of the JAX custom
    VJPs, against float64 autograd of the einsums, for ragged shapes."""
    q, k = _t(randn(4, 3, 37, 12)), _t(randn(5, 3, 37, 12))
    v, dots = _t(randn(6, 3, 37, 20)), _t(randn(7, 3, 12, 20))
    for fn, eq, args in ((tla.kv_dots, "bnd,bne->bde", (k, v)),
                         (tla.apply_dots, "bnd,bde->bne", (q, dots))):
        a = [x.clone().requires_grad_() for x in args]
        a64 = [x.double().requires_grad_() for x in args]
        out = fn(*a)
        g = _t(randn(8, *out.shape))
        want = torch.autograd.grad(torch.einsum(eq, *a64), a64, g.double())
        for got, w in zip(torch.autograd.grad(out, a, g), want):
            _close(got, w, 1e-6)


def test_kernel_wrappers_on_cpu_launch_nothing():
    kernels.reset_launches()
    k = torch.randn(2, 9, 4, requires_grad=True)
    out = tla.apply_dots(k, tla.kv_dots(k, k))
    out.sum().backward()
    assert kernels.launches()["K5 kv_dots"] == 0
    assert kernels.launches()["K6 apply_dots"] == 0


# --- modules ----------------------------------------------------------------

def test_rope_matches_jax():
    coords = np.random.RandomState(0).rand(2, 10).astype(np.float32) * 5
    for dim, min_freq, scale in [(16, 1 / 8, 32.0), (64, 1 / 128, 32.0), (64, 1 / 128, 1.0)]:
        fj = np.asarray(jenc.rotary_freqs(jnp.asarray(coords), dim, min_freq, scale))
        ft = tenc.rotary_freqs(_t(coords), dim, min_freq, scale).numpy()
        np.testing.assert_array_equal(ft, fj)  # the phases reach 2e4 rad: bit for bit
    t = randn(1, 2, 3, 10, 32)
    freqs = [np.broadcast_to(np.asarray(jenc.rotary_freqs(jnp.asarray(c), 16, 1 / 8, 16.0))
                             [:, None], (2, 3, 10, 16)) for c in (coords, coords[::-1])]
    got = tenc.apply_rotary_pos_emb_multi(_t(t), [_t(f) for f in freqs])
    want = jenc.apply_rotary_pos_emb_multi(jnp.asarray(t), [jnp.asarray(f) for f in freqs])
    _close(got, want)
    _close(tenc.rotate_half(_t(t)), jenc.rotate_half(jnp.asarray(t)), 0.0)


def test_instance_norm_tokens_matches_jax():
    x = randn(5, 2, 3, 10, 16) * 2 + 0.5
    _close(to.instance_norm_tokens(_t(x)), jo.instance_norm_tokens(jnp.asarray(x)))


def _attention_case(heads, dim_head, dim=32):
    pos = jnp.asarray(grid_pos())
    x = jnp.asarray(randn(6, B, N, dim))
    jm = jo.LinearAttention(dim, "galerkin", heads=heads, dim_head=dim_head,
                            relative_emb=True, scale=16.0, relative_emb_dim=2,
                            min_freq=1 / X)
    variables = seeded(jm.init(jax.random.PRNGKey(0), x, pos), 1)
    tm = load(to.LinearAttention(dim, heads, dim_head, PLAIN_OPS, scale=16.0,
                                 relative_emb_dim=2, min_freq=1 / X),
              variables)
    return jm.apply(variables, x, pos), tm(_t(x), _t(pos)), tm


@pytest.mark.parametrize("heads,dim_head", [(1, 32), (2, 16)],
                         ids=["one-head-no-to_out", "two-heads"])
def test_linear_attention_matches_jax(heads, dim_head):
    want, got, tm = _attention_case(heads, dim_head)
    assert (tm.to_out is None) == (heads == 1)
    _close(got, want)


def test_linear_attention_refuses_unported_paths():
    _, _, tm = _attention_case(1, 32)
    x, pos = torch.zeros(1, N, 32), torch.zeros(1, N, 2)
    for kw in ({"not_assoc": True}, {"padding_mask": torch.ones(1, N, 1)}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tm(x, pos, **kw)


def test_cross_linear_attention_matches_jax():
    pos = jnp.asarray(grid_pos())
    x, z = jnp.asarray(randn(7, B, N, 32)), jnp.asarray(randn(8, B, N, 32))
    jm = jo.CrossLinearAttention(32, "galerkin", heads=4, dim_head=32, relative_emb=True,
                                 scale=32.0, relative_emb_dim=2, min_freq=1 / X)
    variables = seeded(jm.init(jax.random.PRNGKey(0), x, z, pos, pos), 2)
    tm = load(to.CrossLinearAttention(32, 32, 4, 32, PLAIN_OPS, 32.0, 2, 1 / X),
              variables)
    _close(tm(_t(x), _t(z), _t(pos), _t(pos)), jm.apply(variables, x, z, pos, pos))


def test_feed_forward_matches_jax():
    x = jnp.asarray(randn(9, B, N, 32))
    jm = jo.FeedForward(32, 48)
    variables = seeded(jm.init(jax.random.PRNGKey(0), x), 3)
    _close(load(to.GeGELUFeedForward(32, 48), variables)(_t(x)), jm.apply(variables, x))


def enc_cfgs():
    kw = dict(input_channels=3, time_window=1, in_emb_dim=32, out_channels=32,
              max_node_type=2, heads=1, depth=4, res=X, use_ln=True,
              relative_emb_dim=2)
    return jo.OformerEncoderConfig(**kw), to.OformerEncoderConfig(**kw)


def dec_cfgs():
    kw = dict(max_node_type=2, latent_channels=32, out_channels=1, res=X, scale=2.0,
              dropout=0.1, relative_emb_dim=2)
    return jo.OformerDecoderConfig(**kw), to.OformerDecoderConfig(**kw)


def node_types():
    nt = np.zeros((T, X), np.int32)
    nt[[0, -1]] = 1
    nt[:, [0, -1]] = 1
    return np.broadcast_to(nt.reshape(1, N, 1), (B, N, 1)).copy()


def test_encoder_matches_jax():
    jcfg, tcfg = enc_cfgs()
    x, nt, pos = randn(10, B, 1, N, 3), node_types(), grid_pos()
    jm = jo.IrregSTEncoder(jcfg)
    variables = seeded(jm.init(jax.random.PRNGKey(0), x, nt, pos), 4)
    tm = load(to.IrregSTEncoder(tcfg, PLAIN_OPS), variables)
    _close(tm(_t(x), _t(nt), _t(pos)), jm.apply(variables, x, nt, pos))


@pytest.mark.parametrize("steps", [1, 3])
def test_decoder_matches_jax(steps):
    jcfg, tcfg = dec_cfgs()
    z, nt, pos = randn(11, B, N, 32), node_types(), grid_pos()
    jm = jo.IrregSTDecoder(jcfg)
    variables = seeded(jm.init(jax.random.PRNGKey(0), z, pos, nt, steps, pos), 5)
    assert "constants" in variables
    tm = load(to.IrregSTDecoder(tcfg, 32, PLAIN_OPS), variables)
    got = tm(_t(z), _t(pos), _t(nt), steps, _t(pos))
    assert got.shape == (B, steps, N, 1)
    _close(got, jm.apply(variables, z, pos, nt, steps, pos))
    assert not any(name.endswith(".B") for name, _ in tm.named_parameters())


def test_decoder_dropout_site_matches_jax():
    """The decoder's one dropout site, on the JAX mask read back from its
    nn.Dropout output (the model called eagerly with the same rng)."""
    import flax.linen as nn

    jcfg, tcfg = dec_cfgs()
    z, nt, pos = randn(12, B, N, 32), node_types(), grid_pos()
    jm = jo.IrregSTDecoder(jcfg)
    variables = seeded(jm.init(jax.random.PRNGKey(0), z, pos, nt, 1, pos), 6)
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append(np.asarray(out))
        return out

    with nn.intercept_methods(capture):
        want = jm.apply(variables, z, pos, nt, 1, pos, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(3)})
    (dropped,) = seen
    keep = dropped != 0
    assert 0.8 < keep.mean() < 0.97
    tm = load(to.IrregSTDecoder(tcfg, 32, PLAIN_OPS), variables)
    _close(tm(_t(z), _t(pos), _t(nt), 1, _t(pos), dropout_keep=_t(keep)), want)


def test_model_reset_parameters_distributions():
    """A fresh draw from a torch.Generator: JAX's initializer families (the
    numbers differ), B frozen as a buffer of scale `dec.scale`."""
    m = to.OformerModel(enc_cfgs()[1], dec_cfgs()[1], PLAIN_OPS)
    m.reset_parameters(torch.Generator().manual_seed(0))
    sd = dict(m.named_parameters())
    w = sd["encoder.emb1.weight"]
    assert abs(float(w.std()) * np.sqrt(32) - 1.0) < 0.15 and float(w.abs().max()) < 2.01 / np.sqrt(32) / 0.8796
    qkv = sd["encoder.s_transformer.attn_0.to_qkv.weight"]
    q = qkv[:32]  # boosted: orthogonal / dh + eye / dh
    torch.testing.assert_close((q - torch.eye(32) / 32) @ (q - torch.eye(32) / 32).T,
                               torch.eye(32) / 32 ** 2, rtol=0, atol=1e-6)
    assert float(qkv[32:].abs().max()) <= 1 / np.sqrt(32)
    assert torch.equal(sd["encoder.ln.weight"], torch.ones(32))
    b = dict(m.named_buffers())["decoder.fourier_features.B"]
    assert b.shape == (2, 16) and 1.0 < float(b.std()) < 3.5
