"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the backward kernels against autograd of the plain
forwards, and the OFormer's two linear-attention kernels (K5, K6) with the
backward made of them.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor tests/conftest.py's JAX set-up, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The shapes do not fill the kernels' tiles (ragged pixel tiles, a second
64-wide output-channel tile, a sequence length that is no multiple of the key
tile), so the edge handling is what is tested; chip_smoke.py holds the same
kernels to the same plain versions at the flagship shapes.

Tolerances: both sides are fp32 (TF32 off) and differ only in summation
order, plus the fp32 atomics of the emitted statistics: outputs to rtol 1e-5 /
atol 1e-5, sums of squares to rtol 1e-5 / atol 1e-4. Gradients are held to
1e-5 of each gradient's largest magnitude (`_assert_grads`): a weight or
modulation gradient sums over every pixel (a few hundred here) through fp32
atomics in no fixed order, so elementwise relative error means nothing for
its entries near zero.
"""
import numpy as np
import pytest
import torch

from m_cedm_tpu_torch import kernels
from m_cedm_tpu_torch.kernels import PLAIN_OPS
from m_cedm_tpu_torch.kernels import fused_attention as tfa
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SQ = dict(rtol=1e-5, atol=1e-4)
MODES = ["none", "identity", "identity_up", "proj", "linear"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from m_cedm_tpu_torch.kernels._launch import fp32_reference_math

    fp32_reference_math()
    return torch.device("cuda")


def _leaves(t):
    return [u for s in t for u in _leaves(s)] if isinstance(t, tuple) else [t]


def _assert_out(got, want):
    """out or (out, (sums, sumsq)): the first leaf is the activation."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(),
                                   **(TOL if i == 0 else TOL_SQ))


def _inputs(seed, dev, b, h, w, c, o, cr):
    rs = np.random.RandomState(seed)

    def t(*shape, sc=1.0, sh=0.0):
        return torch.from_numpy((rs.randn(*shape) * sc + sh).astype(np.float32)).to(dev)

    x = t(b, h, w, c, sc=0.8, sh=0.3)
    x3 = x.reshape(b, h * w, c)
    return dict(x=x, gamma=t(b, c, sc=0.3, sh=1.0), beta=t(b, c, sc=0.3),
                w=t(3, 3, c, o, sc=1.0 / np.sqrt(9 * c)), bias=t(o, sc=0.3),
                res=t(b, h, w, o), res_lo=t(b, h // 2, w // 2, o),
                res_proj=t(b, h, w, cr), skw=t(cr, o, sc=1.0 / np.sqrt(cr)),
                skb=t(o, sc=0.3), stats=(x3.sum(1), (x3 * x3).sum(1)))


def _block(fn, inp, mode, groups, stats=None):
    act = mode != "linear"
    kw = {}
    if mode == "identity":
        kw = dict(residual=inp["res"])
    elif mode == "identity_up":
        kw = dict(residual=inp["res_lo"], res_up=True)
    elif mode == "proj":
        kw = dict(residual=inp["res_proj"], skip_w=inp["skw"], skip_b=inp["skb"])
    return fn(inp["x"], inp["gamma"] if act else None, inp["beta"] if act else None,
              inp["w"], inp["bias"], groups if act else 0, 1e-5, stats=stats,
              emit_stats=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 12, 20, 24, 40), (1, 10, 6, 8, 70)],
                         ids=["ragged-tile", "two-out-tiles"])
def test_k2_matches_plain(cuda, mode, shape):
    b, h, w, c, o = shape
    if mode == "identity_up":
        h, w = h - h % 2, w - w % 2
    inp = _inputs(10, cuda, b, h, w, c, o, cr=36)
    want = _block(tfnc.gn_silu_conv_plain, inp, mode, 4)
    for stats in (None, inp["stats"]):
        _assert_out(_block(tfnc.gn_silu_conv, inp, mode, 4, stats=stats), want)


@pytest.mark.cuda
def test_k1_k3_k4_match_plain(cuda):
    inp = _inputs(11, cuda, 2, 7, 9, 32, 40, cr=32)
    b, h, w, c = inp["x"].shape
    x3 = inp["x"].reshape(b, h * w, c)
    g, bt = inp["gamma"], inp["beta"]
    want = tfn.gn_silu_plain(x3, g, bt, 8)
    _assert_out(tfn.gn_silu(x3, g, bt, 8), want)
    _assert_out(tfn.gn_silu(x3, g, bt, 8, stats=inp["stats"]), want)
    up = (inp["x"], g, bt, inp["w"], inp["bias"], 8)
    _assert_out(tfnc.gn_silu_up_conv(*up, emit_stats=True),
                tfnc.gn_silu_up_conv_plain(*up, emit_stats=True))
    q, k, v = (torch.randn(3, 100, 64, device=cuda) for _ in range(3))
    _assert_out(tfa.attention(q, k, v), tfa.attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [24, 64, 320])
def test_channel_stats_match_plain(cuda, c):
    """Channel counts that divide the block, do not, and exceed it."""
    x = torch.randn(2, 300, c, device=cuda) * 0.8 + 0.3
    for got, want in zip(tfn.channel_stats(x), tfn.channel_stats_plain(x)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL_SQ)


@pytest.mark.cuda
def test_wrappers_count_kernel_launches(cuda):
    inp = _inputs(12, cuda, 1, 8, 8, 16, 16, cr=16)
    kernels.reset_launches()
    _block(tfnc.gn_silu_conv, inp, "identity", 4)  # channel_stats, then K2
    _block(tfnc.gn_silu_conv_plain, inp, "identity", 4)
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    want.update({"K1 channel_stats": 1, "K2 gn_silu_conv": 1})
    assert kernels.launches() == want


def _assert_grads(got, want, tol=1e-5):
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert (a is None) == (w is None), i
        if a is None:
            continue
        err = float((a - w).abs().max())
        scale = max(float(w.abs().max()), 1e-6)
        assert err <= tol * scale, (i, err, scale)


def _grads_of(fn, inputs, g):
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, inputs, g, allow_unused=True)


def _leaf(t):
    return t.detach().clone().requires_grad_()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 12, 20, 24, 40), (1, 10, 6, 8, 70)],
                         ids=["ragged-tile", "two-out-tiles"])
def test_k2_backward_matches_plain(cuda, mode, shape):
    b, h, w, c, o = shape
    if mode == "identity_up":
        h, w = h - h % 2, w - w % 2
    inp = _inputs(20, cuda, b, h, w, c, o, cr=36)
    names = ["x", "w", "bias"] + ([] if mode == "linear" else ["gamma", "beta"])
    names += {"identity": ["res"], "identity_up": ["res_lo"],
              "proj": ["res_proj", "skw", "skb"]}.get(mode, [])
    leaves = {n: _leaf(inp[n]) for n in names}
    g = torch.randn(b, h, w, o, device=cuda)

    def run(fn, stats=None):
        def f(*ts):
            d = dict(inp, **dict(zip(names, ts)))
            return _block(fn, d, mode, 4, stats=stats)
        return _grads_of(f, [leaves[n] for n in names], g)

    want = run(tfnc.gn_silu_conv_plain)
    kernels.reset_launches()
    _assert_grads(run(tfnc.gn_silu_conv), want)
    _assert_grads(run(tfnc.gn_silu_conv, stats=inp["stats"]), want)
    assert kernels.launches()["K2 gn_silu_conv_bwd"] == 2


@pytest.mark.cuda
def test_k1_k3_k4_backward_match_plain(cuda):
    inp = _inputs(21, cuda, 2, 7, 9, 32, 40, cr=32)
    b, h, w, c = inp["x"].shape
    x3 = _leaf(inp["x"].reshape(b, h * w, c))
    gm, bt = _leaf(inp["gamma"]), _leaf(inp["beta"])
    g1 = torch.randn(b, h * w, c, device=cuda)
    want = _grads_of(lambda *a: tfn.gn_silu_plain(*a, 8), [x3, gm, bt], g1)
    kernels.reset_launches()
    _assert_grads(_grads_of(lambda *a: tfn.gn_silu(*a, 8), [x3, gm, bt], g1), want)
    _assert_grads(_grads_of(lambda *a: tfn.gn_silu(*a, 8, stats=inp["stats"]),
                            [x3, gm, bt], g1), want)
    xl, wt, bs = _leaf(inp["x"]), _leaf(inp["w"]), _leaf(inp["bias"])
    g3 = torch.randn(b, 2 * h, 2 * w, 40, device=cuda)
    args = [xl, gm, bt, wt, bs]
    want = _grads_of(lambda *a: tfnc.gn_silu_up_conv_plain(*a, 8), args, g3)
    _assert_grads(_grads_of(lambda *a: tfnc.gn_silu_up_conv(*a, 8, emit_stats=True),
                            args, g3), want)
    q, k, v = (torch.randn(3, 100, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    g4 = torch.randn(3, 100, 64, device=cuda)
    _assert_grads(_grads_of(tfa.attention, [q, k, v], g4),
                  _grads_of(tfa.attention_plain, [q, k, v], g4))
    got = kernels.launches()
    assert (got["K1 gn_silu_bwd"], got["K3 gn_silu_up_conv_bwd"],
            got["K4 attention_bwd"]) == (2, 1, 1)


@pytest.mark.cuda
def test_channel_stats_refuse_gradients(cuda):
    """The statistics are not differentiable: no silent gradient-free path."""
    x = torch.randn(1, 64, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="not differentiable"):
        tfn.channel_stats(x)


@pytest.mark.cuda
def test_train_step_on_the_card(cuda):
    """One small train step on the kernel path against the plain path: every
    backward counter moves, and loss and updated parameters agree."""
    from m_cedm_tpu_torch.tasks import build_task

    res, b = 32, 2
    hp = {"name": "adm_edm_mcedm",
          "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True,
                    "out_ch": 2, "ch": 64, "ch_mult": [1, 1, 1],
                    "num_res_blocks": 1, "attn_resolutions": [8],
                    "resolution": res},
          "data": {}, "optimization": {"optimizer": "Adam", "lr": 2e-4}}
    rs = np.random.RandomState(0)
    batch = tuple(torch.from_numpy((rs.randn(b, res, res, 1) * 0.3 + s)
                                   .astype(np.float32)).to(cuda)
                  for s in (1.0, 0.0, 0.0, 0.2))
    out = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", PLAIN_OPS)):
        task = build_task(hp, cuda, ops=ops)
        state = task.init_state(torch.Generator().manual_seed(0))
        kernels.reset_launches()
        new, metrics = task.train_step(state, batch,
                                       torch.Generator(cuda).manual_seed(1))
        out[name] = (metrics, new, kernels.launches())
    (mk, sk, lk), (mp, sp, lp) = out["kernel"], out["plain"]
    oformer = ("K5 kv_dots", "K6 apply_dots")  # the OFormer's, not the U-Net's
    assert all(n > 0 for k, n in lk.items() if k not in oformer), lk
    assert not any(lk[k] for k in oformer), lk
    assert not any(lp.values()), lp
    assert lk["K4 attention_bwd"] == 4  # four attention sites at 8x8
    np.testing.assert_allclose(float(mk["train_loss"]), float(mp["train_loss"]),
                               rtol=1e-5)
    for k, v in sk.params.items():
        # one Adam step moves each parameter by about lr; a gradient entry
        # near zero may take the other sign on rounding alone (2 * lr)
        assert float((v - sp.params[k]).abs().max()) <= 2 * 2e-4 + 1e-6, k


# --- K5 kv_dots / K6 apply_dots (the OFormer's linear attention) ------------

LA_SHAPES = [(3, 1000, 12, 20), (2, 2500, 128, 128), (5, 77, 128, 64), (1, 33, 7, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k5_k6_match_plain(cuda, shape):
    """Ragged N (not a multiple of a row stage or tile), widths under 128 and
    not multiples of 4, one and several kv splits."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = shape
    k, q = (torch.randn(bh, n, d, device=cuda) for _ in range(2))
    v = torch.randn(bh, n, e, device=cuda)
    kernels.reset_launches()
    dots = tla.kv_dots(k, v)
    want = tla.kv_dots_plain(k, v)
    np.testing.assert_allclose(dots.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    out = tla.apply_dots(q, want / n)
    ref = tla.apply_dots_plain(q, want / n)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert (kernels.launches()["K5 kv_dots"], kernels.launches()["K6 apply_dots"]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LA_SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_k5_k6_backward_match_float64(cuda, shape):
    """Each Function's backward (made of the two kernels) against float64
    autograd of the plain forward."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = shape
    q, k = (_leaf(torch.randn(bh, n, d, device=cuda)) for _ in range(2))
    v = _leaf(torch.randn(bh, n, e, device=cuda))
    dots = _leaf(torch.randn(bh, d, e, device=cuda) / n)
    kernels.reset_launches()
    for fn, plain, args in ((tla.kv_dots, tla.kv_dots_plain, [k, v]),
                            (tla.apply_dots, tla.apply_dots_plain, [q, dots])):
        out = fn(*args)
        g = torch.randn(out.shape, device=cuda)
        a64 = [_leaf(a.double()) for a in args]
        want = torch.autograd.grad(torch.einsum(
            "bnd,bne->bde" if fn is tla.kv_dots else "bnd,bde->bne", *a64), a64, g.double())
        _assert_grads(torch.autograd.grad(out, args, g), want)
    # forward 1 + 1; kv_dots' backward two apply_dots, apply_dots' one of each
    assert (kernels.launches()["K5 kv_dots"], kernels.launches()["K6 apply_dots"]) == (2, 4)


@pytest.mark.cuda
def test_k5_k6_refuse_what_they_do_not_take(cuda):
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    k = torch.randn(2, 16, 130, device=cuda)
    with pytest.raises(ValueError, match="widths"):
        tla.kv_dots(k, k)
    q = torch.randn(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tla.apply_dots(q.transpose(0, 1).contiguous().transpose(0, 1),
                       torch.randn(2, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        tla.kv_dots(q.double(), q.double())


def _oformer_case(cuda):
    from m_cedm_tpu_torch.data.oformer_data import tokenize_grid

    hp = {"encoder": {"input_channels": 3, "in_emb_dim": 32, "out_channels": 32,
                      "depth": 2, "res": 16},
          "decoder": {"latent_channels": 32, "res": 16}, "lr": 1e-3}
    rs = np.random.RandomState(0)
    g = np.linspace(0, 1, 16, dtype=np.float32)[None].repeat(2, 0)
    tok = tokenize_grid(rs.rand(2, 16, 16, 1) + 1, rs.rand(2, 16, 16, 1), g, g,
                        {"input_mean": 1.5, "input_std": 0.3, "target_mean": 0.5,
                         "target_std": 0.3})
    batch = tuple(torch.from_numpy(np.ascontiguousarray(tok[k])).to(cuda)
                  for k in ("x", "y", "node_type", "pos", "n_time"))
    keep = torch.from_numpy(rs.rand(2, 256, 32) < 0.9).to(cuda)
    return hp, batch, keep


@pytest.mark.cuda
def test_oformer_eval_and_train_step_on_the_card(cuda):
    """A small OformerTask (depth 2: four attention sites) on the kernel path
    against the plain path: eval metrics, one train step, launch counts."""
    from m_cedm_tpu_torch.tasks import OFORMER_TARGET, build_task

    hp, batch, keep = _oformer_case(cuda)
    out = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", PLAIN_OPS)):
        task = build_task(hp, cuda, target=OFORMER_TARGET, ops=ops)
        state = task.init_state(torch.Generator().manual_seed(0))
        kernels.reset_launches()
        metrics, grid = task.eval_step(state, batch)
        eval_launches = kernels.launches()
        kernels.reset_launches()
        new, tm = task.train_step(state, batch, dropout_keep=keep)
        out[name] = (metrics, grid, eval_launches, tm, new, kernels.launches())
    (mk, gk, ek, tk, sk, lk), (mp, gp, ep, tp, sp, lp) = out["kernel"], out["plain"]
    assert (ek["K5 kv_dots"], ek["K6 apply_dots"]) == (4, 4)
    assert (lk["K5 kv_dots"], lk["K6 apply_dots"]) == (8, 16)
    assert not any(ep.values()) and not any(lp.values())
    for k in mp:
        assert abs(float(mk[k]) - float(mp[k])) <= 1e-4 * max(1.0, abs(float(mp[k]))), k
    np.testing.assert_allclose(gk.cpu().numpy(), gp.cpu().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tk["train_loss"]), float(tp["train_loss"]), rtol=1e-5)
    for k, v in sk.params.items():
        assert float((v - sp.params[k]).abs().max()) <= 2 * 1e-3 + 1e-6, k
