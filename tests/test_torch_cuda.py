"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the backward kernels against autograd of the plain
forwards, the OFormer's two linear-attention kernels (K5, K6) with the
backward made of them, and the whole-block K7 with the U-Net's megakernel
mode and the conditional EDM task served through it.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor tests/conftest.py's JAX set-up, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The shapes do not fill the kernels' tiles (ragged pixel tiles, a second
64-wide output-channel tile, sequence lengths that are no multiple of K4's
64-row tiles), so the edge handling is what is tested; chip_smoke.py holds the same
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


def _rel(got, want):
    """max |got - want| / max(1, max |want|), chip_smoke.py's measure."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("peak", [1.0, 6.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("length", [1, 37, 100, 1000, 1024])
def test_k4_tensor_core_kernels(cuda, length, n, peak):
    """K4's 3xTF32 kernels at one key, ragged tails and whole 64-row tiles:
    the forward within 2e-5 of scale of the plain version, lse within 2e-5 of
    torch.logsumexp of the scaled logits, every gradient within 1e-4 of scale
    of float64 autograd of the plain forward (chip_smoke.py's tolerances),
    two backward calls bit-for-bit equal, one launch of each per call. With
    peak 6 the logits have std 6, so a row's max moves between key tiles and
    between the fragments of a tile: the online rescale is what is held."""
    rs = np.random.RandomState(1000 * n + length)
    q, k, v, g = (torch.from_numpy(rs.randn(n, length, 64).astype(np.float32)).to(cuda)
                  for _ in range(4))
    q = q * peak
    leaves = [_leaf(t) for t in (q, k, v)]
    kernels.reset_launches()
    out = tfa.attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    assert (tfa.attention.launches, tfa.attention_bwd.launches) == (1, 1)
    assert _rel(out, tfa.attention_plain(q, k, v)) <= 2e-5
    lse = torch.empty(n, length, device=cuda)
    assert torch.equal(tfa.attention_fwd(q, k, v, lse), out.detach())
    logits = torch.einsum("nqd,nkd->nqk", q, k) / 8
    assert _rel(lse, torch.logsumexp(logits, dim=-1)) <= 2e-5
    in64 = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tfa.attention_plain(*in64), in64, g.double())
    for i, (a, w) in enumerate(zip(got, want)):
        assert _rel(a, w) <= 1e-4, i
    again = tfa.attention_bwd(g, q, k, v, out.detach(), lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
    # the OFormer's kernels, and K7, which runs only on the sampling path
    idle = ("K5 kv_dots", "K6 apply_dots", "K7 unet_block")
    assert all(n > 0 for k, n in lk.items() if k not in idle), lk
    assert not any(lk[k] for k in idle), lk
    assert not any(lp.values()), lp
    assert lk["K4 attention_bwd"] == 4  # four attention sites at 8x8
    np.testing.assert_allclose(float(mk["train_loss"]), float(mp["train_loss"]),
                               rtol=1e-5)
    for k, v in sk.params.items():
        # one Adam step moves each parameter by about lr; a gradient entry
        # near zero may take the other sign on rounding alone (2 * lr)
        assert float((v - sp.params[k]).abs().max()) <= 2 * 2e-4 + 1e-6, k


# --- K2's narrow-channel conv (conv_in, the out conv) ----------------------

TOL_KERNEL = 2e-5  # of max(1, the output's largest magnitude), as chip_smoke.py


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


NARROW_CASES = [(c, o) for c in (1, 2, 4, 8) for o in (1, 2, 8)] + [
    (4, 64), (2, 64), (64, 2), (64, 1), (3, 70), (13, 3)]


def _narrow_inputs(seed, dev, b, h, w, c, o):
    rs = np.random.RandomState(seed)

    def t(*shape, sc=1.0):
        return torch.from_numpy((rs.randn(*shape) * sc).astype(np.float32)).to(dev)

    return t(b, h, w, c), t(3, 3, c, o, sc=1.0 / np.sqrt(9 * c)), t(o, sc=0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", NARROW_CASES, ids=lambda v: str(v))
def test_narrow_conv_matches_plain(cuda, c, o):
    """C <= 8 or O <= 8 at odd H and W (ragged tiles of both kernels), B 1
    and 3, with and without the emitted statistics; the narrow kernel runs,
    gnsc_kernel does not."""
    for b in (1, 3):
        x, w, bias = _narrow_inputs(c * 100 + o + b, cuda, b, 13, 37, c, o)
        want, (ws, wss) = tfnc.narrow_conv_plain(x, w, bias, emit_stats=True)
        kernels.reset_launches()
        got, (gs, gss) = tfnc.gn_silu_conv(x, None, None, w, bias, emit_stats=True)
        assert max(_rel(got, want), _rel(gs, ws), _rel(gss, wss)) <= TOL_KERNEL
        assert _rel(tfnc.narrow_conv(x, w, None), want - bias) <= TOL_KERNEL
        launched = kernels.launches()
        assert (launched["K2 narrow_conv"], launched["K2 gn_silu_conv"]) == (2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(64, 2), (64, 1), (8, 8), (1, 1), (13, 2), (4, 3),
                                 (130, 5)], ids=lambda v: str(v))
def test_narrow_conv_backward_matches_float64(cuda, c, o):
    """dx, dW and db of the narrow route (O <= 8) against float64 autograd of
    the plain forward, 1e-4 of each one's scale; dW and db repeat bit for
    bit; one narrow backward launch a call."""
    for b in (1, 3):
        x, w, bias = _narrow_inputs(c * 10 + o + b, cuda, b, 13, 37, c, o)
        g = torch.randn(b, 13, 37, o, device=cuda)
        leaves = [_leaf(t) for t in (x, w, bias)]
        a64 = [_leaf(t.double()) for t in (x, w, bias)]
        want = torch.autograd.grad(tfnc.narrow_conv_plain(*a64), a64, g.double())
        kernels.reset_launches()
        got = torch.autograd.grad(tfnc.narrow_conv(*leaves), leaves, g)
        for a, w64 in zip(got, want):
            err = float((a.double() - w64).abs().max())
            assert err <= 1e-4 * max(1.0, float(w64.abs().max()))
        again = tfnc.narrow_conv_bwd(g, x, w)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
        assert torch.equal(tfnc.narrow_conv_bwd(g, x, w)[1], again[1])
        assert tfnc.narrow_conv_bwd(g, x, w, need_dx=False)[0] is None
        launched = kernels.launches()
        assert (launched["K2 narrow_conv_bwd"], launched["K2 gn_silu_conv_bwd"]) == (4, 0)


@pytest.mark.cuda
def test_conv_in_backward_stays_on_the_wgrad_kernel(cuda):
    """conv_in (C 4 -> O 64, no input gradient): the narrow forward, K2's
    backward kernels."""
    x, w, bias = _narrow_inputs(7, cuda, 2, 13, 37, 4, 64)
    leaves = [_leaf(w), _leaf(bias)]
    g = torch.randn(2, 13, 37, 64, device=cuda)
    want = torch.autograd.grad(tfnc.narrow_conv_plain(x, *leaves), leaves, g)
    kernels.reset_launches()
    _assert_grads(torch.autograd.grad(tfnc.narrow_conv(x, *leaves), leaves, g), want)
    launched = kernels.launches()
    assert (launched["K2 narrow_conv"], launched["K2 narrow_conv_bwd"],
            launched["K2 gn_silu_conv_bwd"]) == (1, 0, 1)


@pytest.mark.cuda
def test_narrow_conv_refuses_what_it_does_not_take(cuda):
    x, w, bias = _narrow_inputs(8, cuda, 1, 5, 5, 16, 16)
    with pytest.raises(ValueError, match="narrow"):
        tfnc.narrow_conv(x, w, bias)
    x, w, bias = _narrow_inputs(8, cuda, 1, 5, 5, 4, 64)
    with pytest.raises(ValueError, match="narrow backward"):
        tfnc.narrow_conv_bwd(torch.zeros(1, 5, 5, 64, device=cuda), x, w)
    with pytest.raises(ValueError, match="float32"):
        tfnc.narrow_conv(x.double(), w.double(), None)
    with pytest.raises(ValueError, match="shape"):
        tfnc.narrow_conv(x, w[:, :, :3], bias)
    with pytest.raises(ValueError, match="contiguous"):
        tfnc.narrow_conv(x.transpose(1, 2), w, bias)


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


K6_WIDTHS = (1, 7, 8, 64, 100, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 16384])
@pytest.mark.parametrize("d", K6_WIDTHS)
def test_k6_tensor_core_kernel(cuda, n, d):
    """The 3xTF32 apply_dots at every E of K6_WIDTHS: within 2e-5 of scale
    of its plain version and of float64, bit for bit the same on a second
    call, one launch a call."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    for e in K6_WIDTHS:
        q = torch.randn(2, n, d, device=cuda)
        dots = torch.randn(2, d, e, device=cuda) / 8
        kernels.reset_launches()
        got = tla.apply_dots(q, dots)
        assert _rel(got, tla.apply_dots_plain(q, dots)) <= TOL_KERNEL, e
        assert _rel(got, q.double() @ dots.double()) <= TOL_KERNEL, e
        assert torch.equal(tla.apply_dots(q, dots), got), e
        assert kernels.launches()["K6 apply_dots"] == 2


# --- K2 / K3 and K5 on the tensor cores (3xTF32 mma.sync) ------------------

def _double(inp):
    return {k: tuple(t.double() for t in v) if isinstance(v, tuple) else v.double()
            for k, v in inp.items()}


# (B, H, W, C, O, Cr): H and W no multiple of the 8 x 16 pixel tile; 128
# input channels (sixteen 8-channel chunks) and a projection over Cr = 128;
# O = 70 (a second 64-wide output tile) over C and Cr no multiple of 8
K2_TC_SHAPES = [(2, 19, 37, 128, 64, 128), (3, 10, 22, 20, 70, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K2_TC_SHAPES, ids=["c128-cr128", "o70-ragged-c"])
def test_k2_tensor_core_conv(cuda, mode, shape):
    """Every residual mode and the linear mode, with emit_stats, own and
    chained statistics: within 2e-5 of scale of the plain version and of
    float64; the output repeats bit for bit from the same statistics; one
    gnsc_kernel launch a call."""
    b, h, w, c, o, cr = shape
    if mode == "identity_up":
        h, w = h - h % 2, w - w % 2
    inp = _inputs(40, cuda, b, h, w, c, o, cr)
    groups = 4
    want = _leaves(_block(tfnc.gn_silu_conv_plain, inp, mode, groups))
    want64 = _leaves(_block(tfnc.gn_silu_conv_plain, _double(inp), mode, groups))
    kernels.reset_launches()
    for stats in (None, inp["stats"]):
        got = _leaves(_block(tfnc.gn_silu_conv, inp, mode, groups, stats=stats))
        for i, (a, w32, w64) in enumerate(zip(got, want, want64, strict=True)):
            assert _rel(a, w32) <= TOL_KERNEL, i
            assert _rel(a, w64) <= TOL_KERNEL, i
    again = _leaves(_block(tfnc.gn_silu_conv, inp, mode, groups, stats=inp["stats"]))
    assert torch.equal(again[0], got[0])
    assert kernels.launches()["K2 gn_silu_conv"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 19, 128, 64), (1, 12, 9, 20, 70)],
                         ids=["c128", "o70-ragged-c"])
def test_k3_tensor_core_conv(cuda, shape):
    """K3 at a low-res H, W whose doubles are no multiple of the tile, with
    emit_stats, own and chained statistics, against plain and float64."""
    b, h, w, c, o = shape
    inp = _inputs(41, cuda, b, h, w, c, o, cr=8)
    args = ("x", "gamma", "beta", "w", "bias")
    want = _leaves(tfnc.gn_silu_up_conv_plain(*(inp[k] for k in args), 4,
                                              emit_stats=True))
    want64 = _leaves(tfnc.gn_silu_up_conv_plain(*(inp[k].double() for k in args), 4,
                                                emit_stats=True))
    kernels.reset_launches()
    for stats in (None, inp["stats"]):
        got = _leaves(tfnc.gn_silu_up_conv(*(inp[k] for k in args), 4, stats=stats,
                                           emit_stats=True))
        for i, (a, w32, w64) in enumerate(zip(got, want, want64, strict=True)):
            assert _rel(a, w32) <= TOL_KERNEL, i
            assert _rel(a, w64) <= TOL_KERNEL, i
    assert kernels.launches()["K3 gn_silu_up_conv"] == 2


# (BH, N, D, E): N no multiple of the 64-row stage; D and E under 128 and no
# multiples of 8; one split a head-batch (BH 70 on 132 SMs, or N <= 128)
# and many (up to 129)
KV_CASES = [(3, 1000, 12, 20), (70, 1000, 12, 20), (2, 2500, 128, 128),
            (4, 77, 100, 7), (1, 16389, 128, 128), (2, 300, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k5_tensor_core_kernel(cuda, case):
    """The 3xTF32 kv_dots: within 2e-5 of scale of its plain version and of
    float64, bit for bit the same on a second call (the split-N partials
    are summed in a fixed order), one launch a call."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = case
    k = torch.randn(bh, n, d, device=cuda)
    v = torch.randn(bh, n, e, device=cuda)
    kernels.reset_launches()
    got = tla.kv_dots(k, v)
    assert _rel(got, tla.kv_dots_plain(k, v)) <= TOL_KERNEL
    assert _rel(got, k.double().transpose(1, 2) @ v.double()) <= TOL_KERNEL
    assert torch.equal(tla.kv_dots(k, v), got)
    assert kernels.launches()["K5 kv_dots"] == 2


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


# --- K7 unet_block (the whole ADM block, the U-Net's sampling path) ---------

# (B, H, W, C1, C2, O, up, proj, chained stats, emit); H, W are the input's.
# Ragged row and column tiles, widths 8-128, a second 64-wide output tile,
# both inputs at 128 (the kernel's limit), every variant the U-Net runs.
K7_CASES = {
    "identity-chained-emit": (2, 12, 20, 24, 0, 24, False, False, True, True),
    "dual-proj": (2, 10, 18, 16, 8, 40, False, True, False, True),
    "dual-identity": (1, 9, 17, 32, 32, 64, False, False, True, False),
    "up-identity-chained-emit": (2, 5, 7, 16, 0, 16, True, False, True, True),
    "up-proj-emit": (1, 6, 9, 8, 0, 24, True, True, False, True),
    "wide-two-out-tiles": (1, 7, 19, 128, 128, 128, False, True, True, True),
    "narrow": (3, 3, 5, 8, 0, 8, False, False, False, False),
    "o-70": (1, 10, 6, 64, 64, 70, False, True, False, True),
}


def _k7_inputs(case, dev, seed=30):
    b, h, w, c1, c2, o, up, proj, chained, emit = K7_CASES[case]
    rs = np.random.RandomState(seed)
    c = c1 + c2

    def t(*shape, sc=1.0, sh=0.0):
        return torch.from_numpy((rs.randn(*shape) * sc + sh).astype(np.float32)).to(dev)

    args = [t(b, h, w, c1, sc=0.8, sh=0.3), t(b, c, sc=0.3, sh=1.0), t(b, c, sc=0.3),
            t(3, 3, c, o, sc=1.0 / np.sqrt(9 * c)), t(o, sc=0.3),
            t(b, o, sc=0.3, sh=1.0), t(b, o, sc=0.3),
            t(3, 3, o, o, sc=1.0 / np.sqrt(9 * o)), t(o, sc=0.3)]
    kw = dict(emit_stats=emit, up=up)
    if c2:
        kw["x2"] = t(b, h, w, c2, sc=0.8, sh=0.3)
    if proj:
        kw["skip_w"], kw["skip_b"] = t(c, o, sc=1.0 / np.sqrt(c)), t(o, sc=0.3)
    if chained:
        xin = torch.cat([args[0]] + ([kw["x2"]] if c2 else []), -1).reshape(b, h * w, c)
        kw["stats"] = (xin.sum(1), (xin * xin).sum(1))
    # groups dividing the widths, as ADM's do (70 = 2 x 35)
    groups = (4 if c % 4 == 0 else 1, 2 if o == 70 else 4)
    return args, groups, kw


def _assert_scaled(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape, i
        assert torch.isfinite(a).all(), i
        err = float((a.double() - w.double()).abs().max())
        assert err <= tol * max(1.0, float(w.abs().max())), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_matches_plain(cuda, case):
    """Two chained convs of up to 9 * 256 products and a norm over the first
    one's output, in another summation order: 4e-5 of scale."""
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_inputs(case, cuda)
    want = tfb.fused_unet_block_plain(*args, *groups, 1e-5, **kw)
    kernels.reset_launches()
    got = tfb.fused_unet_block(*args, *groups, 1e-5, **kw)
    _assert_scaled(got, want, 4e-5)
    launched = kernels.launches()
    assert launched["K7 unet_block"] == 1
    # without chained statistics K1's pass runs first, once per input
    n_stats = 0 if "stats" in kw else (2 if "x2" in kw else 1)
    assert launched["K1 channel_stats"] == n_stats
    # deterministic: no atomics anywhere in K7
    again = tfb.fused_unet_block(*args, *groups, 1e-5, **kw)
    for a, b_ in zip(_leaves(got), _leaves(again)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dual-proj", "up-proj-emit", "identity-chained-emit"])
def test_k7_recompute_backward(cuda, case):
    """Under grad mode K7's Function recomputes the block through K2 / K3
    (whose backwards are kernels): its gradients against float64 autograd of
    the plain composition, 1e-4 of each gradient's scale."""
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_inputs(case, cuda, seed=31)
    names = [k for k in ("x2", "skip_w", "skip_b") if k in kw]
    leaves = [_leaf(a) for a in args] + [_leaf(kw[k]) for k in names]

    def run(fn, ts, stats=True):
        k = dict(kw, **dict(zip(names, ts[9:])))
        if not stats:
            k.pop("stats", None)
        out = fn(*ts[:9], *groups, 1e-5, **k)
        return out[0] if kw["emit_stats"] else out

    kernels.reset_launches()
    out = run(tfb.fused_unet_block, leaves)
    g = torch.randn(out.shape, device=cuda)
    got = torch.autograd.grad(out, leaves, g)
    launched = kernels.launches()
    l64 = [_leaf(a.double()) for a in leaves]
    want = torch.autograd.grad(run(tfb.fused_unet_block_plain, l64, stats=False), l64,
                               g.double())
    _assert_grads(got, want, tol=1e-4)
    assert launched["K7 unet_block"] == 1
    assert launched["K2 gn_silu_conv_bwd"] >= 1
    assert launched["K3 gn_silu_up_conv_bwd"] == (1 if kw["up"] else 0)


@pytest.mark.cuda
def test_k7_refuses_what_it_does_not_take(cuda):
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_inputs("dual-proj", cuda)
    with pytest.raises(ValueError, match="up with x2"):
        tfb.fused_unet_block(*args, *groups, 1e-5, **dict(kw, up=True))
    wide = [torch.zeros(2, 10, 18, 130, device=cuda)] + args[1:]
    with pytest.raises(ValueError, match="widths"):
        tfb.fused_unet_block(*wide, *groups, 1e-5, **kw)
    with pytest.raises(ValueError, match="float32"):
        tfb.fused_unet_block(*([args[0].double()] + args[1:]), *groups, 1e-5, **kw)
    strided = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fused_unet_block(*([strided] + args[1:]), *groups, 1e-5, **kw)
    with pytest.raises(ValueError, match="groups"):
        tfb.fused_unet_block(*args, 5, groups[1], 1e-5, **kw)
    with pytest.raises(ValueError, match="cpu"):
        tfb.fused_unet_block(*args, *groups, 1e-5, **dict(kw, x2=kw["x2"].cpu()))


def _seeded_state(model, seed):
    """Non-zero fan-in-scaled parameters (ADM's init zeroes conv1 and
    out_conv, which would hide the kernels)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        if v.dim() > 1:
            val = rs.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            is_scale = "norm" in k and k.endswith(".weight")  # norm scales near 1
            val = float(is_scale) + 0.3 * rs.randn(*v.shape)
        out[k] = torch.from_numpy(val.astype(np.float32))
    return out


@pytest.mark.cuda
def test_mega_unet_on_the_card(cuda):
    """A small U-Net (res 32, ch_mult (1, 1), attention at 16 with ADM's one
    64-wide head): the mega path (nine K7 launches, no K3) against the
    per-conv kernel path and the plain path, under no_grad."""
    from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig

    cfg = AdmUNetConfig(in_channels=1, out_ch=1, ch=64, ch_mult=(1, 1),
                        num_res_blocks=1, attn_resolutions=(16,), resolution=32,
                        cond_channels=1, cat_cond=True)
    models = [AdmUNet(cfg, ops, mega=mega) for ops, mega in
              ((kernels.DEVICE_OPS, True), (kernels.DEVICE_OPS, False), (PLAIN_OPS, False))]
    sd = _seeded_state(models[0], 3)
    for m in models:
        m.load_state_dict(sd)
        m.to(cuda).eval()
    rs = np.random.RandomState(4)
    x, cond = (torch.from_numpy(rs.randn(2, 32, 32, 1).astype(np.float32)).to(cuda)
               for _ in range(2))
    sigma = torch.tensor([-1.0, 0.5], device=cuda)
    outs, launched = [], []
    with torch.no_grad():
        for m in models:
            kernels.reset_launches()
            outs.append(m(x, sigma, cond))
            launched.append(kernels.launches())
    scale = float(outs[2].abs().max())
    for o in outs[:2]:
        assert float((o - outs[2]).abs().max()) <= 1e-4 * max(1.0, scale)
    mega, per_conv, plain = launched
    # K2: the down block's two convs; conv_in and the out conv take the
    # narrow kernel
    assert (mega["K7 unet_block"], mega["K2 gn_silu_conv"], mega["K2 narrow_conv"],
            mega["K3 gn_silu_up_conv"], mega["K4 attention"]) == (9, 2, 2, 0, 4)
    assert (per_conv["K7 unet_block"], per_conv["K3 gn_silu_up_conv"]) == (0, 1)
    assert not any(plain.values())


@pytest.mark.cuda
def test_cond_edm_eval_on_the_card(cuda):
    """CondEdmTask.eval_step (res 32, 3 Heun steps) served through K7 with
    mega=True, against the plain path on the same noise."""
    from m_cedm_tpu_torch.tasks import COND_EDM_TARGET, build_task

    res, b, steps = 32, 2, 3
    hp = {"name": "adm_edm_cond_h",
          "model": {"in_channels": 1, "cond_channels": 1, "cat_cond": True,
                    "out_ch": 1, "ch": 64, "ch_mult": [1, 1], "num_res_blocks": 1,
                    "attn_resolutions": [16], "resolution": res},
          "data": {"normalization": "gauss"},
          "sampler": {"type": "edm", "timesteps": steps, "S_churn": 15.0},
          "diffusion": {"beta_schedule": "linear", "beta_start": 1e-4,
                        "beta_end": 0.02, "num_diffusion_timesteps": 1000}}
    rs = np.random.RandomState(5)
    h = torch.from_numpy((rs.randn(b, res, res, 1) * 0.1 + 4.0).astype(np.float32))
    u = torch.from_numpy((rs.randn(b, res, res, 1) * 0.2).astype(np.float32))
    grid = torch.linspace(0, 1, res).reshape(1, res, 1, 1).expand(b, res, res, 1)
    batch = tuple(t.contiguous().to(cuda) for t in (h, grid, grid.transpose(1, 2), u))
    stats = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.0, "target_std": 0.2}
    init = torch.from_numpy(rs.randn(1, b, res, res, 1).astype(np.float32)).to(cuda)
    churn = torch.from_numpy(rs.randn(1, steps, b, res, res, 1).astype(np.float32)).to(cuda)
    out = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", PLAIN_OPS)):
        task = build_task(hp, cuda, target=COND_EDM_TARGET, ops=ops, mega=True)
        state = task.init_state(None, stats, params=_seeded_state(task.model, 6))
        kernels.reset_launches()
        metrics, u_mean = task.eval_step(state, batch, None, split="test",
                                         init_noise=init, churn_noise=churn)
        out[name] = (metrics, u_mean, kernels.launches())
    (mk, uk, lk), (mp, up, lp) = out["kernel"], out["plain"]
    assert lk["K7 unet_block"] == 9 * (2 * steps - 1) and not any(lp.values())
    assert set(mk) == {"test_mae_u", "test_mae_u_un", "test_mae_u_scaled",
                       "test_corr_u", "test_pde_loss", "test_pde_loss_gt"}
    for k in mp:
        assert abs(float(mk[k]) - float(mp[k])) <= 1e-4 * max(1.0, abs(float(mp[k]))), k
    _assert_scaled(uk, up, 1e-4)
