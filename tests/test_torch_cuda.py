"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the backward kernels against autograd of the plain
forwards, the OFormer's two linear-attention kernels (K5, K6) with the
backward made of them, the whole-block K7 with the U-Net's megakernel
mode and the conditional EDM task served through it, and K1 and K2 at the
DDPM U-Net's 32 groups (a ResnetBlock with the statistics chained across
the temb add, forward and gradients) with a DdimTask step and eval.

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
modulation gradient sums over every pixel (a few hundred here) in another
order than the plain version, so elementwise relative error means nothing
for its entries near zero.
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
@pytest.mark.parametrize("peak", [1.0, 6.0], ids=["normal", "peaked"])
def test_k4_at_the_folded_ensemble_batch(cuda, peak):
    """test_k4_tensor_core_kernels at 80 head-batches of 1024 tokens: the
    CLI's test ensemble (5 members of a 16-item batch in one sampler call)."""
    test_k4_tensor_core_kernels(cuda, 1024, 80, peak)


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
    want = dict.fromkeys(kernels.launches(), 0)
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
    # the OFormer's kernels (both instances), K7, which runs only on the
    # sampling path, and the bf16 backward's dx pass (an fp32 step forms dx
    # in PyTorch)
    idle = ("K5 kv_dots", "K6 apply_dots", "K5 kv_dots bf16", "K6 apply_dots bf16",
            "K7 unet_block", "K2 gn_dx")
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
# O = 70 (a second 64-wide output tile) over C and Cr no multiple of 8; B 80,
# the batch of the CLI's test ensemble (5 members of a 16-item test batch
# folded into one sampler call)
K2_TC_SHAPES = [(2, 19, 37, 128, 64, 128), (3, 10, 22, 20, 70, 12),
                (80, 16, 16, 64, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K2_TC_SHAPES, ids=["c128-cr128", "o70-ragged-c",
                                                     "b80"])
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


# (B, H, W, C, O, Cr) of the backward kernels: H and W no multiple of
# dgrad's 8 x 16 or wgrad's 4 x 16 (narrow C: 8 x 32) pixel tile, B 3, 1 and
# 2; 128 input channels and a projection over Cr = 128; O = 70 (a ragged
# third 32-wide output slice of wgrad, a second 64-wide tile of the forward)
# over C and Cr no multiple of 8; C = 12 (a block's 32 channels mostly
# padding); C = 4, conv_in's width (the narrow-C wgrad); B 32, the config's
# train batch (per-block partial buffers sized by the batch)
K2_BWD_SHAPES = [(3, 19, 37, 128, 64, 128), (1, 10, 22, 20, 70, 12),
                 (2, 11, 18, 12, 40, 8), (3, 13, 37, 4, 64, 8),
                 (32, 32, 32, 64, 64, 64)]
TOL_BWD64 = 1e-5  # of each gradient's largest magnitude, against float64


def _same(once, again):
    """Two calls' outputs equal bit for bit (None where both are None)."""
    for i, (a, a2) in enumerate(zip(once, again, strict=True)):
        assert (a is None) == (a2 is None), i
        if a is not None:
            assert torch.equal(a, a2), i


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K2_BWD_SHAPES, ids=["c128-cr128", "o70-ragged-c", "c12",
                                                     "c4", "b32"])
def test_k2_tensor_core_backward(cuda, mode, shape):
    """Every mode of test_k2_backward_matches_plain on the 3xTF32 backward
    kernels, with own and chained statistics: each gradient within 1e-5 of
    its scale of float64 autograd of the plain forward. The backward called
    twice on the same operands repeats bit for bit: dW, dbias, dgamma and
    dbeta are per-block partials summed in a fixed order."""
    b, h, w, c, o, cr = shape
    if mode == "identity_up":
        h, w = h - h % 2, w - w % 2
    inp = _inputs(42, cuda, b, h, w, c, o, cr)
    act = mode != "linear"
    names = ["x", "w", "bias"] + (["gamma", "beta"] if act else [])
    names += {"identity": ["res"], "identity_up": ["res_lo"],
              "proj": ["res_proj", "skw", "skb"]}.get(mode, [])
    g = torch.randn(b, h, w, o, device=cuda)

    def run(fn, src, stats=None):
        def f(*ts):
            return _block(fn, dict(src, **dict(zip(names, ts))), mode, 4, stats=stats)
        return _grads_of(f, [_leaf(src[n]) for n in names], g.to(src["x"].dtype))

    want = run(tfnc.gn_silu_conv_plain, _double(inp))
    kernels.reset_launches()
    for stats in (None, inp["stats"]):
        _assert_grads(run(tfnc.gn_silu_conv, inp, stats), want, tol=TOL_BWD64)
    assert kernels.launches()["K2 gn_silu_conv_bwd"] == 2
    tail = {"identity": dict(residual=inp["res"]),
            "identity_up": dict(residual=inp["res_lo"], res_up=True),
            "proj": dict(residual=inp["res_proj"], skip_w=inp["skw"])}.get(mode, {})
    _same(*(tfnc.gn_silu_conv_bwd(g, inp["x"], inp["gamma"] if act else None,
                                  inp["beta"] if act else None, inp["w"],
                                  inp["stats"] if act else None, 4 if act else 0,
                                  1e-5, **tail) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 7, 11, 64, 64), (1, 5, 9, 128, 70),
                                   (2, 5, 7, 12, 24), (32, 16, 16, 64, 64)],
                         ids=["c64", "c128-o70", "c12", "b32"])
def test_k3_tensor_core_backward(cuda, shape):
    """K3's backward at odd low-res sizes (the up-fold's column pairs at
    ragged tile edges), own and chained statistics, against float64; bit
    for bit on a repeat."""
    b, h, w, c, o = shape
    inp = _inputs(43, cuda, b, h, w, c, o, cr=8)
    args = ("x", "gamma", "beta", "w", "bias")
    g = torch.randn(b, 2 * h, 2 * w, o, device=cuda)

    def run(fn, src, **kw):
        return _grads_of(lambda *ts: fn(*ts, 4, **kw), [_leaf(src[k]) for k in args],
                         g.to(src["x"].dtype))

    want = run(tfnc.gn_silu_up_conv_plain, _double(inp))
    kernels.reset_launches()
    for stats in (None, inp["stats"]):
        _assert_grads(run(tfnc.gn_silu_up_conv, inp, stats=stats), want, tol=TOL_BWD64)
    assert kernels.launches()["K3 gn_silu_up_conv_bwd"] == 2
    _same(*(tfnc.gn_silu_up_conv_bwd(g, *(inp[k] for k in args[:4]), inp["stats"], 4)
            for _ in range(2)))


# K1's backward (B, N, C, groups): ragged N (no multiple of the slabs), C 8 to
# 128 with 2 to 32 groups, B 1 to 16; C 6 takes 4-byte copies (C % 4 != 0);
# C 2048 (wider than a block's lanes) holds no slab row in shared memory; N
# 512 * 512 at B 1 is a slab beyond the shared-memory ring (its rest read
# twice from device memory); N 100 fewer rows than blocks; B 32 at the
# flagship's res 128 and 64 (the config's train batch: 32 per-sample
# hand-offs in one cooperative launch)
K1_BWD_CASES = [(3, 1000, 8, 2), (1, 4099, 32, 8), (16, 4096, 64, 16),
                (3, 5001, 128, 32), (16, 100, 64, 32), (2, 777, 6, 3),
                (2, 300, 2048, 32), (1, 512 * 512, 64, 16),
                (32, 128 * 128, 64, 16), (32, 64 * 64, 64, 16)]


def _k1_bwd_inputs(case, dev, seed):
    b, n, c, groups = case
    rs = np.random.RandomState(seed)

    def t(*shape, sc=1.0, sh=0.0):
        return torch.from_numpy((rs.randn(*shape) * sc + sh).astype(np.float32)).to(dev)

    x, g = t(b, n, c, sc=0.8, sh=0.3), t(b, n, c)
    return x, g, t(b, c, sc=0.3, sh=1.0), t(b, c, sc=0.3), groups


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k1_backward_matches_float64(cuda, case):
    """K1's one-pass backward against its plain version in float64: dx,
    dgamma and dbeta each within 1e-5 of its scale; a second call gives the
    same bits (the sums are per-slab partials added in a fixed order); each
    call counts one launch."""
    x, g, gamma, beta, groups = _k1_bwd_inputs(case, cuda, seed=50)
    stats = (x.sum(1), (x * x).sum(1))
    want = tfn.gn_silu_bwd_plain(*(t.double() for t in (g, x, gamma, beta)), groups)
    kernels.reset_launches()
    got = tfn.gn_silu_bwd(g, x, gamma, beta, stats, groups)
    _assert_grads(got, want, tol=TOL_BWD64)
    _same(got, tfn.gn_silu_bwd(g, x, gamma, beta, stats, groups))
    assert kernels.launches()["K1 gn_silu_bwd"] == 2


@pytest.mark.cuda
def test_k1_backward_refuses_what_it_does_not_take(cuda):
    """Channels that do not split into the groups, or too many, raise; so
    does a grid of more slabs than the card keeps co-resident (the
    cooperative launch is never shrunk)."""
    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels._launch import F, I, P

    x, g, gamma, beta, _ = _k1_bwd_inputs((2, 300, 12, 3), cuda, seed=51)
    stats = (x.sum(1), (x * x).sum(1))
    with pytest.raises(ValueError, match="whole groups"):
        tfn.gn_silu_bwd(g, x, gamma, beta, stats, 5)
    wide = torch.zeros(1, 4, 4096, device=cuda)
    with pytest.raises(ValueError, match="2048 channels"):
        tfn.gn_silu_bwd(wide, wide, wide[:, 0], wide[:, 0], (wide[:, 0], wide[:, 0]), 32)
    n, rows = 100_000, 2
    slabs = n // rows
    b, c = 1, 12
    x, g = torch.randn(b, n, c, device=cuda), torch.randn(b, n, c, device=cuda)
    vec = torch.zeros(b, c, device=cuda)
    outs = [torch.empty(b, c, device=cuda), torch.empty(b, c, device=cuda), torch.empty_like(x)]
    scratch = torch.empty(b * slabs * 24, device=cuda)
    sync = torch.zeros(2 + 4 * b * 3, device=cuda, dtype=torch.int32)
    fn = _build.bind("fused_norm", "mc_gn_silu_bwd", [P] * 11 + [I] * 4 + [F, I, I, P])
    rc = fn(x.data_ptr(), g.data_ptr(), *[vec.data_ptr()] * 4, *[t.data_ptr() for t in outs],
            scratch.data_ptr(), sync.data_ptr(), b, n, c, 3, 1e-5, slabs, rows,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 720  # cudaErrorCooperativeLaunchTooLarge


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
# both inputs at 128 (the kernel's limit), every variant the U-Net runs; more
# items (8 x 16 pixels x 64 channels) than the co-resident grid's 264
# blocks, so each phase's persistent walk takes two rounds; an up-block with
# a projection at an even size that no tile divides.
K7_CASES = {
    "multi-round": (6, 64, 128, 64, 0, 64, False, False, True, True),
    "up-proj-chained-even": (2, 5, 9, 16, 0, 24, True, True, True, True),
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
        assert err <= tol * max(1.0, float(w.detach().abs().max())), (i, err)


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
@pytest.mark.parametrize("case", ["multi-round", "up-proj-chained-even", "dual-proj"])
def test_k7_repeats_bit_for_bit(cuda, case):
    """K7 sums its statistics from per-tile partials in a fixed order, with
    no atomics, so two calls give the same bits, outputs and emitted
    statistics alike, also where the persistent grid walks its items in
    more than one round."""
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_inputs(case, cuda, seed=32)
    b, h, w = args[0].shape[:3]
    items, blocks = tfb.grid(b, 2 * h if kw["up"] else h, 2 * w if kw["up"] else w,
                             args[7].shape[-1], kw["up"])
    if case == "multi-round":
        assert items > blocks
    first = tfb.fused_unet_block(*args, *groups, 1e-5, **kw)
    again = tfb.fused_unet_block(*args, *groups, 1e-5, **kw)
    got, want = _leaves(first), _leaves(again)
    assert len(got) == (3 if kw["emit_stats"] else 1)
    for a, b_ in zip(got, want):
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
    # K1's statistics pass where an input comes without statistics (after
    # the attention sites): five on both paths
    assert mega["K1 channel_stats"] == per_conv["K1 channel_stats"] == 5
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


# --- the DDPM U-Net's shapes: 32 groups, eps 1e-6 ------------------------------

DDPM_BLOCKS = {"identity": (64, 64), "projection": (128, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DDPM_BLOCKS))
def test_ddpm_resnet_block_matches_plain(cuda, case):
    """One DDPM ResnetBlock (two K2 calls at 32 groups, eps 1e-6: 2 channels
    a group at 64, 4 at the 128-channel concat) on the kernel path, its second
    K2 fed the statistics chained across the temb add, against the plain
    path: output, emitted statistics, and the gradients of x, temb and every
    parameter (temb_proj's among them), with the chained statistics given and
    with K1's pass computing the input's."""
    from m_cedm_tpu_torch.models.ddpm_unet import ResnetBlock

    c_in, c_out = DDPM_BLOCKS[case]
    b, res, temb_ch = 2, 20, 256
    blk = ResnetBlock(c_in, c_out, temb_ch).to(cuda)
    blk.load_state_dict({k: v.to(cuda) for k, v in _seeded_state(blk, 30).items()})
    rs = np.random.RandomState(31)
    x = torch.from_numpy((rs.randn(b, res, res, c_in) * 0.8 + 0.3).astype(np.float32)).to(cuda)
    temb = torch.from_numpy(rs.randn(b, temb_ch).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(b, res, res, c_out).astype(np.float32)).to(cuda)
    x3 = x.reshape(b, -1, c_in)
    in_stats = (x3.sum(1), (x3 * x3).sum(1))
    params = list(blk.parameters())

    def run(ops, stats):
        xl, tl = _leaf(x), _leaf(temb)
        out, ostats = blk(xl, tl, stats, ops)
        return (out, ostats), torch.autograd.grad(out, [xl, tl] + params, g)

    (want, want_stats), want_g = run(PLAIN_OPS, None)
    for stats in (None, in_stats):
        kernels.reset_launches()
        (got, got_stats), got_g = run(kernels.DEVICE_OPS, stats)
        launched = kernels.launches()
        _assert_scaled(got, want, 2e-5)
        _assert_scaled(got_stats, want_stats, 2e-5)
        _assert_grads(got_g, want_g, 1e-4)
        assert launched["K2 gn_silu_conv"] == 2 and launched["K2 gn_silu_conv_bwd"] == 2
        assert launched["K1 channel_stats"] == (1 if stats is None else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128], ids=["2-a-group", "4-a-group"])
def test_k1_at_32_groups_matches_plain(cuda, c):
    """K1's apply and backward at the DDPM's 32 groups and eps 1e-6, with
    and without chained statistics."""
    inp = _inputs(32, cuda, 2, 24, 24, c, c, cr=c)
    b, h, w, _ = inp["x"].shape
    x3 = _leaf(inp["x"].reshape(b, h * w, c))
    gm, bt = _leaf(inp["gamma"]), _leaf(inp["beta"])
    g1 = torch.randn(b, h * w, c, device=cuda)
    want = _grads_of(lambda *a: tfn.gn_silu_plain(*a, 32, 1e-6), [x3, gm, bt], g1)
    _assert_out(tfn.gn_silu(x3.detach(), gm.detach(), bt.detach(), 32, 1e-6),
                tfn.gn_silu_plain(x3.detach(), gm.detach(), bt.detach(), 32, 1e-6))
    kernels.reset_launches()
    for stats in (None, inp["stats"]):
        _assert_grads(_grads_of(lambda *a: tfn.gn_silu(*a, 32, 1e-6, stats=stats),
                                [x3, gm, bt], g1), want, 1e-4)
    assert kernels.launches()["K1 gn_silu_bwd"] == 2


@pytest.mark.cuda
def test_ddpm_unet_train_and_eval_on_the_card(cuda):
    """The DDPM U-Net of configs/model/ddim_res32.yaml at res 32 (three
    levels, attention at 8): a DdimTask train step (self-conditioning branch
    taken) and a RePaint Heun eval on the kernel path against the plain path
    on the same draws, every DDPM kernel launched."""
    import yaml

    from m_cedm_tpu_torch.tasks import DDIM_TARGET, build_task

    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "model", "ddim_res32.yaml")) as f:
        hp = yaml.safe_load(f)["hparams"]
    res, b = 32, 2
    hp["model"].update(resolution=res, attn_resolutions=[8])
    hp["sampler"].update(timesteps=3, n_time_h=16)
    rs = np.random.RandomState(33)
    h = torch.from_numpy((rs.randn(b, res, res, 1) * 0.1 + 4.0).astype(np.float32))
    u = torch.from_numpy((rs.randn(b, res, res, 1) * 0.2).astype(np.float32))
    grid = torch.linspace(0, 1, res).reshape(1, res, 1, 1).expand(b, res, res, 1)
    batch = tuple(t.contiguous().to(cuda) for t in (h, grid, grid.transpose(1, 2), u))
    stats = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.0, "target_std": 0.2}
    shape = (b, res, res, 2)
    draws = {"t_half": torch.tensor([10, 700], device=cuda), "use_sc": True,
             "noise": torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)}
    noise = {"init_noise": torch.randn((1,) + shape, device=cuda),
             "churn_noise": torch.randn((1, 3) + shape, device=cuda),
             "repeat_noise": torch.randn((1, 6) + shape, device=cuda)}
    out = {}
    for name, ops in (("kernel", kernels.DEVICE_OPS), ("plain", PLAIN_OPS)):
        task = build_task(hp, cuda, target=DDIM_TARGET, ops=ops)
        state = task.init_state(None, stats, params=_seeded_state(task.model, 34))
        kernels.reset_launches()
        new, tm = task.train_step(state, batch, None, **draws)
        train_launches = kernels.launches()
        kernels.reset_launches()
        em, hu = task.eval_step(new, batch, None, split="test", **noise)
        out[name] = (tm, new, train_launches, em, hu, kernels.launches())
    (tk, sk, lk, ek, huk, lek), (tp, sp, lp, ep, hup, lep) = out["kernel"], out["plain"]
    assert not any(lp.values()) and not any(lep.values())
    for k in ("K1 gn_silu", "K1 channel_stats", "K2 gn_silu_conv", "K2 narrow_conv",
              "K4 attention", "K1 gn_silu_bwd", "K2 gn_silu_conv_bwd",
              "K2 narrow_conv_bwd", "K4 attention_bwd"):
        assert lk[k] > 0, (k, lk)
    assert lek["K2 gn_silu_conv_bwd"] == 0 and lek["K2 gn_silu_conv"] > 0
    for k in tp:
        assert abs(float(tk[k]) - float(tp[k])) <= 1e-4 * abs(float(tp[k])), (
            k, float(tk[k]), float(tp[k]))
    for k, v in sk.params.items():
        assert float((v - sp.params[k]).abs().max()) <= 2 * 2e-4 + 1e-6, k
    for k in ep:
        if k == "test_pde_loss":  # the PDE residual amplifies the samples' rounding
            continue
        assert abs(float(ek[k]) - float(ep[k])) <= 1e-4 * max(1.0, abs(float(ep[k]))), (
            k, float(ek[k]), float(ep[k]))
    _assert_scaled(huk, hup, 1e-4)


# --- bf16 serving: the bf16 kernels against their bf16 plain versions --------
# Both sides sum in fp32 in other orders and round once to bf16: a bf16
# output within 1e-2 of its scale at most and 1e-4 on average (the one-ulp
# flips of that order); emitted fp32 statistics within 1e-5 of their scale.

def _bf16_close(got, want, stats=False):
    assert got.dtype == want.dtype
    err = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max())
    if stats:
        assert float(err.max()) <= 1e-5 * scale
    else:
        assert float(err.max()) <= 1e-2 * scale
        assert float(err.mean()) <= 1e-4 * scale


def _bf16_all(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        _bf16_close(a, w, stats=i > 0 or a.dtype == torch.float32)


def _bf16_rnd(g, dev, *shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)


# The bf16 K7 at K7_CASES' ragged shapes: its output as every bf16 kernel's;
# its emitted statistics within 4e-5 of scale (two chained convs: h's bf16
# rounding flips where the two sides' fp32 sums differ in order, and the
# flips reach the second conv's sums, as on the per-conv path)


def _k7_bf16_inputs(case, dev, seed=40):
    args, groups, kw = _k7_inputs(case, dev, seed)
    args = [a.bfloat16() if i in (0, 3, 7) else a for i, a in enumerate(args)]
    kw = {k: (v.bfloat16() if k in ("x2", "skip_w") else v) for k, v in kw.items()}
    if "stats" in kw:
        xin = torch.cat([args[0]] + ([kw["x2"]] if "x2" in kw else []), -1).float()
        xin = xin.reshape(xin.shape[0], -1, xin.shape[-1])
        kw["stats"] = (xin.sum(1), (xin * xin).sum(1))
    return args, groups, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_bf16_matches_plain(cuda, case):
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_bf16_inputs(case, cuda)
    want = tfb.fused_unet_block_plain(*args, *groups, 1e-5, **kw)
    kernels.reset_launches()
    got = tfb.fused_unet_block(*args, *groups, 1e-5, **kw)
    launched = kernels.launches()
    assert launched["K7 unet_block"] == 1
    assert launched["K1 channel_stats"] == (0 if "stats" in kw else
                                            (2 if "x2" in kw else 1))
    got, want = _leaves(got), _leaves(want)
    assert got[0].dtype == torch.bfloat16 and len(got) == len(want)
    _bf16_close(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        err = float((a.double() - w.double()).abs().max())
        assert err <= 4e-5 * float(w.double().abs().max())
    again = _leaves(tfb.fused_unet_block(*args, *groups, 1e-5, **kw))
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_bf16_route_is_the_shapes(cuda, case):
    """The C plan's route is the TMA kernel exactly where C1, C2 and O are
    multiples of 8 and an identity skip has one input, and its tile plan is
    csrc/k7_plan.h's at the card's SMs and blocks an SM."""
    import ctypes

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    b, h, w, c1, c2, o, up, proj = K7_CASES[case][:8]
    h, w = (2 * h, 2 * w) if up else (h, w)
    plan = tfb._bf16_plan(b, h, w, c1, c2, o, up, proj)
    assert plan[7] == int(all(n % 8 == 0 for n in (c1, c2, o)) and (proj or c2 == 0))
    if plan[7]:
        host = _build.bind("fused_block", "mc_unet_block_bf16_tma_plan",
                           [ctypes.c_int] * 10 + [ctypes.c_void_p])
        want = (ctypes.c_int * 16)()
        assert host(b, h, w, c1, c2, o, int(up), int(proj), plan[4], plan[3],
                    ctypes.cast(want, ctypes.c_void_p)) == 0
        assert list(plan[:9]) == [*want[:6], want[6], 1, want[7]] and plan[9] == want[8]


@pytest.mark.cuda
def test_k7_bf16_refuses_mixed_dtypes(cuda):
    from m_cedm_tpu_torch.kernels import fused_block as tfb

    args, groups, kw = _k7_bf16_inputs("dual-proj", cuda)
    with pytest.raises(ValueError, match="must be"):
        tfb.fused_unet_block(*args[:3], args[3].float(), *args[4:], *groups, **kw)
    with pytest.raises(ValueError, match="must be"):
        tfb.fused_unet_block(*args, *groups, **dict(kw, skip_w=kw["skip_w"].float()))
    with pytest.raises(ValueError, match="must be"):
        tfb.fused_unet_block(*args[:4], args[4].bfloat16(), *args[5:], *groups, **kw)



@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 32, 64, 128])
@pytest.mark.parametrize("chained", [True, False])
def test_k1_bf16_matches_plain(cuda, c, chained):
    g = torch.Generator(device=cuda).manual_seed(c)
    x = _bf16_rnd(g, cuda, 3, 333, c, scale=0.8, shift=0.2)
    gamma = _bf16_rnd(g, cuda, 3, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, cuda, 3, c, scale=0.3, dtype=torch.float32)
    groups = max(c // 4, 1) if c < 128 else 32
    stats = tfn.channel_stats_plain(x) if chained else None
    _bf16_all(tfn.channel_stats(x), tfn.channel_stats_plain(x))
    with torch.no_grad():
        _bf16_all(tfn.gn_silu(x, gamma, beta, groups, stats=stats),
                  tfn.gn_silu_plain(x, gamma, beta, groups, stats=stats))


# K1's bf16 forward at the main path's shapes (the statistics pass at the
# 32 x 32 sites, the apply at res 128 and 64) and at ragged N (no multiple
# of a cluster's or the apply's blocks)
K1_BF16_SHAPES = [(16, 1024, 64), (16, 1024, 128), (16, 4096, 64), (16, 16384, 64),
                  (3, 1001, 64), (2, 2601, 128), (2, 333, 128), (5, 7, 64)]


def _k1_inputs(g, dev, b, n, c, dtype=torch.bfloat16, offset=0):
    """x (B, N, C), `offset` elements into its storage (a misaligned view
    where offset * itemsize is no multiple of 16), gamma, beta, groups."""
    flat = _bf16_rnd(g, dev, b * n * c + offset, scale=0.8, shift=0.2, dtype=dtype)
    x = flat[offset:].view(b, n, c)
    gamma = _bf16_rnd(g, dev, b, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, dev, b, c, scale=0.3, dtype=torch.float32)
    return x, gamma, beta, max(1, min(32, c // 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_bf16_passes_at_main_path_shapes(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, gamma, beta, groups = _k1_inputs(g, cuda, *shape)
    stats = tfn.channel_stats_plain(x)
    _bf16_all(tfn.channel_stats(x), stats)
    with torch.no_grad():
        _bf16_all(tfn.gn_silu(x, gamma, beta, groups, stats=stats),
                  tfn.gn_silu_plain(x, gamma, beta, groups, stats=stats))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c,offset", [(4, 0), (24, 0), (4, 1), (24, 1), (64, 1), (64, 3)])
def test_k1_scalar_instance_matches_plain(cuda, dtype, c, offset):
    """Channels that take no whole 16-byte vector (C 4 in bf16) and views of
    x off a 16-byte boundary take the kernels' one-element instance."""
    g = torch.Generator(device=cuda).manual_seed(c + offset)
    x, gamma, beta, groups = _k1_inputs(g, cuda, 3, 333, c, dtype, offset)
    assert (x.data_ptr() % 16 != 0) == (offset > 0)
    stats = tfn.channel_stats_plain(x)
    with torch.no_grad():
        got = (tfn.channel_stats(x), tfn.gn_silu(x, gamma, beta, groups, stats=stats),
               tfn.gn_silu(x, gamma, beta, groups))
        want = (stats, tfn.gn_silu_plain(x, gamma, beta, groups, stats=stats),
                tfn.gn_silu_plain(x, gamma, beta, groups))
    if dtype == torch.bfloat16:
        for a, w in zip(got, want):
            _bf16_all(a, w)
    else:
        for a, w in zip(got, want):
            _assert_out(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(16, 1024, 64), (16, 1024, 128), (3, 1001, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_channel_stats_same_bits_in_one_operation(cuda, dtype, shape):
    """Two calls give the same bits (no atomics), and a call is one device
    operation (no buffer zeroed first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(7)
    x = _k1_inputs(g, cuda, *shape, dtype=dtype)[0]
    first = tfn.channel_stats(x)
    torch.cuda.synchronize()
    # a capture that recorded no device event at all (the profiler's, seen
    # on the card's machine) is taken again; one that did must hold one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = tfn.channel_stats(x)
            torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == 1, ops


@pytest.mark.cuda
def test_k1_forward_plans_match_the_source(cuda):
    """kernels/fused_norm.py's stats_plan and apply_plan are the plans the
    CUDA source launches (mc_channel_stats_plan, mc_gn_silu_plan)."""
    import ctypes

    from m_cedm_tpu_torch.kernels import _build

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stats_fn = _build.bind("fused_norm", "mc_channel_stats_plan", [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    apply_fn = _build.bind("fused_norm", "mc_gn_silu_plan", [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
    for b, n, c in [(16, 1024, 64), (16, 16384, 64), (80, 1024, 128), (1, 7, 4),
                    (3, 100_003, 320), (2, 1, 24), (16, 4096, 2056)]:
        for vec in (1, 4, 8):
            if c % vec:
                continue
            out = (ctypes.c_int * 4)()
            assert stats_fn(n, c, vec, out) == 0
            assert tuple(out)[:3] == tfn.stats_plan(n, c, vec)
            assert apply_fn(b, n, c, vec, out) == 0
            assert tuple(out) == (*tfn.apply_plan(b, n, c, vec, sms), sms)


# (B, H, W, C, O, Cr): ragged tiles, two output blocks (O 80), the scalar
# copies and stores (C 12, O 20 or 40), C 128 (two chunks, resident at 8 x
# 16 rows) and C 192 (weights streamed a chunk a step), one res-128 image
# (8 x 16 tiles), 16 x 16 tiles with ragged edges (B 5 at 130 x 100), res 32
# at B 16, and the projection from 128 channels
K2_BF16_SHAPES = [(2, 13, 21, 24, 40, 24), (1, 18, 36, 64, 80, 24), (1, 9, 17, 12, 20, 24),
                  (2, 16, 16, 128, 64, 24), (2, 13, 21, 12, 40, 12), (1, 128, 128, 64, 64, 24),
                  (5, 130, 100, 64, 64, 24), (16, 32, 32, 64, 64, 24),
                  (2, 24, 40, 64, 64, 128), (1, 20, 24, 192, 64, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K2_BF16_SHAPES)
def test_k2_bf16_matches_plain(cuda, mode, shape):
    b, h, w, c, o, cr = shape
    if mode == "identity_up" and (h % 2 or w % 2):
        pytest.skip("identity_up needs an even height and width")
    g = torch.Generator(device=cuda).manual_seed(h * w + c)
    x = _bf16_rnd(g, cuda, b, h, w, c, scale=0.8, shift=0.2)
    act = mode != "linear"
    gamma = _bf16_rnd(g, cuda, b, c, scale=0.3, shift=1.0, dtype=torch.float32) if act else None
    beta = _bf16_rnd(g, cuda, b, c, scale=0.3, dtype=torch.float32) if act else None
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    bias = _bf16_rnd(g, cuda, o, scale=0.3, dtype=torch.float32)
    kw = {}
    if mode == "identity":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h, w, o))
    elif mode == "identity_up":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h // 2, w // 2, o), res_up=True)
    elif mode == "proj":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h, w, cr),
                  skip_w=_bf16_rnd(g, cuda, cr, o, scale=0.2),
                  skip_b=_bf16_rnd(g, cuda, o, scale=0.3, dtype=torch.float32))
    groups = 4 if act else 0
    stats = tfn.channel_stats_plain(x.reshape(b, -1, c)) if act else None
    with torch.no_grad():
        _bf16_all(tfnc.gn_silu_conv(x, gamma, beta, wt, bias, groups, stats=stats,
                                    emit_stats=True, **kw),
                  tfnc.gn_silu_conv_plain(x, gamma, beta, wt, bias, groups, stats=stats,
                                          emit_stats=True, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 11, 24, 40), (1, 8, 16, 64, 64), (16, 64, 64, 64, 64),
                                   (2, 20, 36, 128, 64), (1, 13, 9, 12, 40)])
def test_k3_bf16_matches_plain(cuda, shape):
    b, h, w, c, o = shape
    g = torch.Generator(device=cuda).manual_seed(h * w)
    x = _bf16_rnd(g, cuda, b, h, w, c, scale=0.8, shift=0.2)
    gamma = _bf16_rnd(g, cuda, b, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, cuda, b, c, scale=0.3, dtype=torch.float32)
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    bias = _bf16_rnd(g, cuda, o, scale=0.3, dtype=torch.float32)
    stats = tfn.channel_stats_plain(x.reshape(b, -1, c))
    with torch.no_grad():
        _bf16_all(tfnc.gn_silu_up_conv(x, gamma, beta, wt, bias, 4, stats=stats,
                                       emit_stats=True),
                  tfnc.gn_silu_up_conv_plain(x, gamma, beta, wt, bias, 4, stats=stats,
                                             emit_stats=True))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(4, 64), (2, 64), (3, 70), (64, 2), (64, 1), (37, 5)])
def test_narrow_conv_bf16_matches_plain(cuda, c, o):
    g = torch.Generator(device=cuda).manual_seed(c * 100 + o)
    x = _bf16_rnd(g, cuda, 2, 19, 37, c)
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    bias = _bf16_rnd(g, cuda, o, scale=0.3, dtype=torch.float32)
    before = tfnc.narrow_conv.launches
    with torch.no_grad():
        _bf16_all(tfnc.narrow_conv(x, wt, bias, emit_stats=True),
                  tfnc.narrow_conv_plain(x, wt, bias, emit_stats=True))
    assert tfnc.narrow_conv.launches == before + 1


# The bf16 narrow convs on the tensor cores (csrc/narrow_conv.cu:
# narrow_c_bf16_kernel for C <= 8, narrow_o_bf16_kernel for O <= 8): the
# route's calls (C, O), ragged, at batch 80 and at a res-128 height with a
# ragged width
NARROW_BF16_CASES = [(4, 64), (2, 64), (3, 70), (64, 2), (64, 1), (37, 5), (8, 8), (8, 320),
                     (320, 8)]


def _narrow_bf16_inputs(g, dev, b, h, w, c, o, offset=0):
    """x and w `offset` elements into their storage (a misaligned view when
    offset * 2 is no multiple of 16), fp32 bias."""
    x = _bf16_rnd(g, dev, b * h * w * c + offset)[offset:].view(b, h, w, c)
    wt = (_bf16_rnd(g, dev, 9 * c * o + offset, scale=1.0 / (3 * c ** 0.5))[offset:]
          .view(3, 3, c, o))
    bias = _bf16_rnd(g, dev, o, scale=0.3, dtype=torch.float32)
    return x, wt, bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(80, 19, 37), (2, 128, 129)], ids=["b80", "res128"])
@pytest.mark.parametrize("c,o", NARROW_BF16_CASES)
def test_narrow_bf16_kernels_match_plain_and_repeat(cuda, c, o, b, h, w):
    """Output and statistics against the bf16 plain version; the same bits on
    a repeat; one narrow launch a call."""
    g = torch.Generator(device=cuda).manual_seed(c * 1000 + o + b)
    x, wt, bias = _narrow_bf16_inputs(g, cuda, b, h, w, c, o)
    before = tfnc.narrow_conv.launches
    with torch.no_grad():
        got = tfnc.narrow_conv(x, wt, bias, emit_stats=True)
        again = tfnc.narrow_conv(x, wt, bias, emit_stats=True)
        _bf16_all(got, tfnc.narrow_conv_plain(x, wt, bias, emit_stats=True))
    assert tfnc.narrow_conv.launches == before + 2
    assert all(torch.equal(a, a2) for a, a2 in zip(_leaves(got), _leaves(again)))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(4, 64), (2, 64), (64, 2), (64, 1), (8, 8)])
def test_narrow_bf16_misaligned_views_match_plain(cuda, c, o):
    """x and w off a 16-byte boundary take the element copies."""
    g = torch.Generator(device=cuda).manual_seed(c + o)
    x, wt, bias = _narrow_bf16_inputs(g, cuda, 3, 16, 40, c, o, offset=1)
    assert x.data_ptr() % 16 and wt.data_ptr() % 16
    with torch.no_grad():
        _bf16_all(tfnc.narrow_conv(x, wt, bias, emit_stats=True),
                  tfnc.narrow_conv_plain(x, wt, bias, emit_stats=True))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o,n_ops", [(4, 64, 1), (2, 64, 1), (64, 2, 1)])
def test_narrow_bf16_is_one_device_operation(cuda, c, o, n_ops):
    """conv_in with its statistics is one device operation (the blocks finish
    the sums after a grid-wide barrier); the out conv without them one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(9)
    x, wt, bias = _narrow_bf16_inputs(g, cuda, 16, 128, 128, c, o)
    emit = o > 8
    with torch.no_grad():
        tfnc.narrow_conv(x, wt, bias, emit_stats=emit)
        torch.cuda.synchronize()
        for _ in range(3):  # a capture with no device event at all is taken again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tfnc.narrow_conv(x, wt, bias, emit_stats=emit)
                torch.cuda.synchronize()
            ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            if ops:
                break
    assert len(ops) == n_ops, ops


@pytest.mark.cuda
def test_narrow_bf16_plan_is_the_sources(cuda):
    """kernels/fused_norm_conv.py's narrow_bf16_plan is the plan the source
    launches (mc_narrow_conv_plan), and its tiles size the statistics scratch
    (mc_narrow_conv_tiles)."""
    import ctypes

    from m_cedm_tpu_torch.kernels import _build

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = _build.bind("narrow_conv", "mc_narrow_conv_plan", [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    tiles = _build.bind("narrow_conv", "mc_narrow_conv_tiles", [ctypes.c_int] * 3)
    for b, h, w in [(16, 128, 128), (80, 128, 128), (1, 1, 1), (3, 37, 13), (80, 129, 129)]:
        for c, o in NARROW_BF16_CASES:
            out = (ctypes.c_int * 6)()
            assert plan(b, h, w, c, o, out) == 0
            mirror = tfnc.narrow_bf16_plan(b, h, w, c, o, sms)
            assert tuple(out)[:4] == mirror
            assert tiles(h, w, 0 if o <= tfnc.NARROW else 3) == mirror[1]


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(64, 2), (8, 8)])
def test_narrow_bf16_backward_repeats_at_batch_80(cuda, c, o):
    """The dgrad on narrow_c_bf16_kernel (mirrored taps) and the wgrad: the
    bf16 plain version, and the same bits on a repeat."""
    g = torch.Generator(device=cuda).manual_seed(c + 3 * o)
    x, wt, _ = _narrow_bf16_inputs(g, cuda, 80, 19, 37, c, o)
    gy = _bf16_rnd(g, cuda, 80, 19, 37, o)
    got = tfnc.narrow_conv_bwd(gy, x, wt)
    again = tfnc.narrow_conv_bwd(gy, x, wt)
    _bf16_grads_close(got, tfnc.narrow_conv_bwd_plain(gy, x, wt))
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 63, 64, 65, 200, 1024])
def test_k4_bf16_matches_plain(cuda, length):
    g = torch.Generator(device=cuda).manual_seed(length)
    q, k, v = (_bf16_rnd(g, cuda, 3, length, 64, scale=2.0) for _ in range(3))
    with torch.no_grad():
        _bf16_all(tfa.attention(q, k, v), tfa.attention_plain(q, k, v))


@pytest.mark.cuda
def test_bf16_kernels_refuse_mixed_dtypes_and_backward(cuda):
    """Mixed dtypes raise; the backward of a bf16 call launches the bf16
    backward kernels."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = _bf16_rnd(g, cuda, 1, 8, 8, 16)
    gamma = _bf16_rnd(g, cuda, 1, 16, dtype=torch.float32)
    wt = _bf16_rnd(g, cuda, 3, 3, 16, 16)
    with pytest.raises(ValueError, match="must be"):
        tfnc.gn_silu_conv(x, gamma, gamma, wt.float(), None, 4)
    with pytest.raises(ValueError, match="must be"):
        tfnc.gn_silu_conv(x, gamma.bfloat16(), gamma, wt, None, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfn.channel_stats(x.half().reshape(1, 64, 16))
    xg = x.clone().requires_grad_()
    out = tfnc.gn_silu_conv(xg, gamma, gamma, wt, None, 4)
    before = tfnc.gn_silu_conv_bwd.launches
    out.float().sum().backward()
    assert tfnc.gn_silu_conv_bwd.launches == before + 1
    assert xg.grad.dtype == torch.bfloat16 and bool(torch.isfinite(xg.grad.float()).all())


# --- bf16 training: the bf16 backward kernels against their bf16 plain versions
# bf16 outputs (dx, da, dq, dk, dv) as above; the fp32 outputs (dW, dbias,
# dgamma, dbeta) within 1e-3 of their scale: sums of exact bf16 products in
# other orders, and the one-ulp flips of a rounded activation where the two
# sides' fp32 activations differ in the last bit.

def _bf16_grads_close(got, want):
    for i, (a, w) in enumerate(zip(got, want)):
        assert (a is None) == (w is None), i
        if a is None:
            continue
        assert a.dtype == w.dtype, i
        if a.dtype == torch.bfloat16:
            _bf16_close(a, w)
        else:
            err = float((a.double() - w.double()).abs().max())
            assert err <= 1e-3 * float(w.double().abs().max()), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 128])
def test_k1_bf16_backward_matches_plain(cuda, c):
    g = torch.Generator(device=cuda).manual_seed(c + 1)
    x = _bf16_rnd(g, cuda, 3, 700, c, scale=0.8, shift=0.2)
    gy = _bf16_rnd(g, cuda, 3, 700, c)
    gamma = _bf16_rnd(g, cuda, 3, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, cuda, 3, c, scale=0.3, dtype=torch.float32)
    stats = tfn.channel_stats_plain(x)
    groups = 32 if c == 128 else c // 4
    before = tfn.gn_silu_bwd.launches
    got = tfn.gn_silu_bwd(gy, x, gamma, beta, stats, groups)
    assert tfn.gn_silu_bwd.launches == before + 1
    _bf16_grads_close(got, tfn.gn_silu_bwd_bf16_plain(gy, x, gamma, beta, groups,
                                                      stats=stats))
    with pytest.raises(ValueError, match="multiple of 8"):
        tfn.gn_silu_bwd(*(t[..., :12].contiguous() for t in (gy, x, gamma, beta)),
                        tuple(t[:, :12].contiguous() for t in stats), 4)


# K2_BF16_SHAPES: (B, H, W, C, O, Cr). "tiles16" has more 16 x 16 tiles than
# an H100 has SMs, neither dividing H nor W, so persistent blocks take one or
# two tiles and cross images; "tiles8" the same on 8 x 16 tiles; "o128" two
# o-chunks of dgrad's K and two O-blocks of wgrad's N; "c128-o64" two
# C-blocks (the decoder's conv0 shape)
K2_BF16_SHAPES = {"ragged": (2, 12, 20, 24, 40, 24), "two-o-blocks": (1, 10, 6, 64, 70, 24),
                  "c128": (2, 16, 16, 128, 64, 128), "scalar": (1, 9, 17, 12, 20, 24),
                  "tiles16": (3, 100, 120, 64, 64, 64), "tiles8": (4, 64, 80, 64, 64, 128),
                  "o128": (1, 18, 34, 64, 128, 64), "c128-o64": (1, 33, 20, 128, 64, 64)}


def _k2_bf16_case(cuda, mode, shape):
    b, h, w, c, o, cr = shape
    g = torch.Generator(device=cuda).manual_seed(h * w + c + 7)
    act = mode != "linear"
    x = _bf16_rnd(g, cuda, b, h, w, c, scale=0.8, shift=0.2)
    gy = _bf16_rnd(g, cuda, b, h, w, o)
    gamma = _bf16_rnd(g, cuda, b, c, scale=0.3, shift=1.0, dtype=torch.float32) if act else None
    beta = _bf16_rnd(g, cuda, b, c, scale=0.3, dtype=torch.float32) if act else None
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    kw = {}
    if mode == "identity":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h, w, o))
    elif mode == "identity_up":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h // 2, w // 2, o), res_up=True)
    elif mode == "proj":
        kw = dict(residual=_bf16_rnd(g, cuda, b, h, w, cr),
                  skip_w=_bf16_rnd(g, cuda, cr, o, scale=0.2))
    groups = 4 if act else 0
    stats = tfn.channel_stats_plain(x.reshape(b, -1, c)) if act else None
    return (gy, x, gamma, beta, wt, stats, groups, 1e-5), kw


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(K2_BF16_SHAPES.values()), ids=list(K2_BF16_SHAPES))
def test_k2_bf16_backward_matches_plain(cuda, mode, shape):
    if mode == "identity_up" and (shape[1] % 2 or shape[2] % 2):
        pytest.skip("identity_up needs an even height and width")
    (gy, x, gamma, beta, wt, stats, groups, eps), kw = _k2_bf16_case(cuda, mode, shape)
    got = tfnc.gn_silu_conv_bwd(gy, x, gamma, beta, wt, stats, groups, eps, **kw)
    want = tfnc.gn_silu_conv_bwd_plain(gy, x, gamma, beta, wt, groups, eps, stats=stats, **kw)
    _bf16_grads_close(got, want)


# (B, h, w, C, O) at the low resolution; "tiles16": 168 high-res 16 x 16
# tiles (ragged in both axes) for 132 persistent blocks
K3_BF16_SHAPES = {"ragged": (2, 7, 11, 24, 40), "one-tile": (1, 8, 16, 64, 64),
                  "c128": (2, 10, 18, 128, 64), "scalar": (1, 13, 9, 12, 40),
                  "tiles16": (3, 50, 60, 64, 64), "o128": (1, 9, 17, 64, 128)}


def _k3_bf16_case(cuda, shape):
    b, h, w, c, o = shape
    g = torch.Generator(device=cuda).manual_seed(h * w + 3)
    x = _bf16_rnd(g, cuda, b, h, w, c, scale=0.8, shift=0.2)
    gy = _bf16_rnd(g, cuda, b, 2 * h, 2 * w, o)
    gamma = _bf16_rnd(g, cuda, b, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, cuda, b, c, scale=0.3, dtype=torch.float32)
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    return gy, x, gamma, beta, wt, tfn.channel_stats_plain(x.reshape(b, -1, c))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K3_BF16_SHAPES.values()), ids=list(K3_BF16_SHAPES))
def test_k3_bf16_backward_matches_plain(cuda, shape):
    gy, x, gamma, beta, wt, stats = _k3_bf16_case(cuda, shape)
    before = tfnc.gn_dx.launches
    _bf16_grads_close(tfnc.gn_silu_up_conv_bwd(gy, x, gamma, beta, wt, stats, 4),
                      tfnc.gn_silu_up_conv_bwd_plain(gy, x, gamma, beta, wt, 4, stats=stats))
    assert tfnc.gn_dx.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k2 identity tiles16", "k2 proj tiles8", "k2 linear o128",
                                  "k3 up tiles16"])
def test_k2_k3_bf16_backward_repeat_bit_for_bit(cuda, case):
    """dW, dbias, dgamma, dbeta (and dskip_w) from fixed-order partials: two
    calls give the same bits; the bf16 outputs too (no atomics)."""
    kind, mode, name = case.split()
    if kind == "k3":
        args = _k3_bf16_case(cuda, K3_BF16_SHAPES[name])
        runs = [tfnc.gn_silu_up_conv_bwd(*args, 4) for _ in range(2)]
    else:
        (gy, x, gamma, beta, wt, stats, groups, eps), kw = _k2_bf16_case(
            cuda, mode, K2_BF16_SHAPES[name])
        runs = [tfnc.gn_silu_conv_bwd(gy, x, gamma, beta, wt, stats, groups, eps, **kw)
                for _ in range(2)]
    for i, (a, b_) in enumerate(zip(*runs)):
        assert (a is None) == (b_ is None), i
        assert a is None or torch.equal(a, b_), i


@pytest.mark.cuda
@pytest.mark.parametrize("da_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,groups", [((2, 7, 13, 24), 4), ((3, 5, 9, 12), 3),
                                          ((16, 128, 128, 64), 16), ((16, 64, 64, 64), 16)],
                         ids=["ragged", "scalar", "flagship-k2", "flagship-k3"])
def test_gn_dx_matches_plain(cuda, da_dtype, shape, groups):
    """The dx kernel alone: bf16 da (K2) and fp32 da (K3's low-res tail)
    against gn_dx_plain; C % 8 != 0 takes its element path."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    b, c = shape[0], shape[-1]
    x = _bf16_rnd(g, cuda, *shape, scale=0.8, shift=0.2)
    da = _bf16_rnd(g, cuda, *shape, scale=0.1, dtype=da_dtype)
    gamma = _bf16_rnd(g, cuda, b, c, scale=0.3, shift=1.0, dtype=torch.float32)
    dstats = _bf16_rnd(g, cuda, 2, b, c, scale=30.0, dtype=torch.float32)
    stats = tfn.channel_stats_plain(x.reshape(b, -1, c))
    before = tfnc.gn_dx.launches
    got = tfnc.gn_dx(x, da, gamma, dstats, stats, groups)
    assert tfnc.gn_dx.launches == before + 1
    _bf16_close(got, tfnc.gn_dx_plain(x, da, gamma, dstats, stats, groups))
    with pytest.raises(ValueError, match="bf16 x"):
        tfnc.gn_dx(x.float(), da, gamma, dstats, stats, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(64, 2), (64, 1), (37, 5), (8, 8)])
def test_narrow_conv_bf16_backward_matches_plain(cuda, c, o):
    g = torch.Generator(device=cuda).manual_seed(c * 10 + o)
    x = _bf16_rnd(g, cuda, 2, 19, 37, c)
    gy = _bf16_rnd(g, cuda, 2, 19, 37, o)
    wt = _bf16_rnd(g, cuda, 3, 3, c, o, scale=1.0 / (3 * c ** 0.5))
    before = tfnc.narrow_conv_bwd.launches
    got = tfnc.narrow_conv_bwd(gy, x, wt)
    assert tfnc.narrow_conv_bwd.launches == before + 1
    _bf16_grads_close(got, tfnc.narrow_conv_bwd_plain(gy, x, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 63, 65, 200, 1024])
def test_k4_bf16_backward_matches_plain(cuda, length):
    g = torch.Generator(device=cuda).manual_seed(length + 5)
    q, k, v, gy = (_bf16_rnd(g, cuda, 3, length, 64, scale=2.0) for _ in range(4))
    lse = torch.empty(3, length, device=cuda)
    o32 = torch.empty(3, length, 64, device=cuda)
    out = tfa.attention_fwd(q, k, v, lse, o32)
    _bf16_close(out, o32.to(torch.bfloat16))
    err = float((o32 - tfa.attention_plain(q.float(), k.float(), v.float())).abs().max())
    assert err <= 1e-5 * float(o32.abs().max())
    got, want = tfa.attention_bwd(gy, q, k, v, o32, lse), tfa.attention_bwd_plain(gy, q, k, v)
    if length == 1:
        # one key: the softmax is 1, dS = dP - delta is zero in exact
        # arithmetic and both sides hold rounding noise in dq and dk
        assert all(float(t.float().abs().max()) <= 1e-5 for t in got[:2] + want[:2])
        got, want = got[2:], want[2:]
    _bf16_grads_close(got, want)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = tfa.attention_bwd.launches
    tfa.attention(qg, kg, vg).backward(gy)
    assert tfa.attention_bwd.launches == before + 1
    _bf16_close(vg.grad, want[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("peak", [1.0, 6.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("length, n", [(length, n) for length in (1, 63, 65, 1024)
                                        for n in (3, 16)] + [(1024, 80)])
def test_k4_bf16_wgmma_kernels(cuda, length, n, peak):
    """The bf16 K4 kernels (wgmma, P and dS in three bf16 pieces) at one key,
    ragged tails and whole tiles, and at 80 head-batches of 1024 tokens (the
    bf16 CLI test's folded ensemble: 5 members of a 16-item batch): the
    output within the bf16 tolerances of
    the bf16 plain version, o32 within 1e-5 of scale of the fp32 plain
    attention, lse within 2e-5 of torch.logsumexp, the gradients within the
    bf16 tolerances of the bf16 plain backward, two backward calls bit for
    bit equal, one launch of each per autograd call. With peak 6 the logits
    have std 6, so a row's max moves between key tiles and between the
    fragments of a tile: the online rescale is what is held."""
    g = torch.Generator(device=cuda).manual_seed(1000 * n + length + int(peak))
    q, k, v, gy = (_bf16_rnd(g, cuda, n, length, 64) for _ in range(4))
    q = (q.float() * peak).to(torch.bfloat16)
    lse = torch.empty(n, length, device=cuda)
    o32 = torch.empty(n, length, 64, device=cuda)
    out = tfa.attention_fwd(q, k, v, lse, o32)
    _bf16_close(out, tfa.attention_plain(q, k, v))
    assert torch.equal(out, o32.to(torch.bfloat16))
    err = float((o32 - tfa.attention_plain(q.float(), k.float(), v.float())).abs().max())
    assert err <= 1e-5 * float(o32.abs().max())
    logits = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) / 8
    assert _rel(lse, torch.logsumexp(logits, dim=-1)) <= 2e-5
    got, want = tfa.attention_bwd(gy, q, k, v, o32, lse), tfa.attention_bwd_plain(gy, q, k, v)
    again = tfa.attention_bwd(gy, q, k, v, o32, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if length == 1:
        # one key: dS = dP - delta is zero in exact arithmetic
        assert all(float(t.float().abs().max()) <= 1e-5 for t in got[:2] + want[:2])
        got, want = got[2:], want[2:]
    _bf16_grads_close(got, want)
    leaves = [_leaf(t) for t in (q, k, v)]
    kernels.reset_launches()
    torch.autograd.grad(tfa.attention(*leaves), leaves, gy)
    assert (tfa.attention.launches, tfa.attention_bwd.launches) == (1, 1)


@pytest.mark.cuda
def test_bf16_train_step_on_the_card(cuda):
    """A bf16 McedmTask step on the kernel path against the bf16 plain path
    from one state (loss and gradient norm 1e-2, params 2 lr), the master
    params, Adam state and EMA fp32, every backward kernel launched."""
    from m_cedm_tpu_torch.tasks import build_task

    hp = {"name": "adm_edm_mcedm",
          "model": {"in_channels": 2, "cond_channels": 2, "cat_cond": True, "out_ch": 2,
                    "ch": 64, "ch_mult": [1, 1], "num_res_blocks": 1,
                    "attn_resolutions": [16], "dropout": 0.0, "resolution": 32,
                    "ema": True, "cond_p": 1.0, "dtype": "bfloat16"},
          "data": {"normalization": "gauss"},
          "optimization": {"optimizer": "Adam", "lr": 2e-4}}
    stats = {"input_mean": 4.0, "input_std": 0.1, "target_mean": 0.1, "target_std": 0.3}
    kern = build_task(hp, cuda)
    plain = build_task(hp, cuda, ops=PLAIN_OPS)
    state = kern.init_state(torch.Generator().manual_seed(0), stats)
    for k_, v in state.params.items():  # non-zero weights everywhere
        if v.dim() > 1:
            v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k_)))
                    .to(v.device) / float(np.prod(v.shape[:-1])) ** 0.5)
    rs = np.random.RandomState(3)
    h = torch.from_numpy((rs.randn(4, 32, 32, 1) * 0.1 + 4.0).astype(np.float32)).to(cuda)
    u = torch.from_numpy((rs.randn(4, 32, 32, 1) * 0.2).astype(np.float32)).to(cuda)
    grid = torch.zeros_like(h)
    draws = dict(mask=torch.from_numpy(rs.randint(0, 2, (4, 32, 32, 2)).astype(np.float32)).to(cuda),
                 cond_noise=torch.randn(4, 32, 32, 2, device=cuda),
                 noise=torch.randn(4, 32, 32, 2, device=cuda),
                 rnd_normal=torch.randn(4, 1, 1, 1, device=cuda),
                 keep=torch.ones((), device=cuda))
    counters = (tfn.gn_silu_bwd, tfnc.gn_silu_conv_bwd, tfnc.gn_silu_up_conv_bwd,
                tfnc.narrow_conv_bwd, tfa.attention_bwd)
    before = [f.launches for f in counters]
    s_k, m_k = kern.train_step(state, (h, grid, grid, u), None, **draws)
    assert all(f.launches > n for f, n in zip(counters, before))
    s_p, m_p = plain.train_step(state, (h, grid, grid, u), None, **draws)
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(float(m_k[key]), float(m_p[key]), rtol=1e-2)
    for k_ in s_p.params:
        assert s_k.params[k_].dtype == s_k.ema_params[k_].dtype == torch.float32
        assert s_k.opt_state["mu"][k_].dtype == torch.float32
        assert float((s_k.params[k_] - s_p.params[k_]).abs().max()) <= 2 * 2e-4


# --- K5 / K6 bf16 (the OFormer in bf16) -------------------------------------
# K5's bf16 instance: bf16 products are exact in fp32, so its fp32 output
# holds to its plain version (the fp32 sum of the upcasts) and to float64 as
# the fp32 kernel does. K6's: the factor rounded to bf16, fp32 sums, the
# output rounded once, as every bf16 kernel's output (_bf16_close). Ragged N;
# widths not multiples of 8 (the mma.sync kernels, element copies); on the
# TMA route widths 40 and 8 (boxes zero-filled past them), clusters of one
# to eight ranks (an empty last rank at N 2,049 in eight), BH 20 (clusters
# of four that do not tile the SMs), the ragged case of chip_smoke.py.

LA_BF16_SHAPES = [(3, 1000, 12, 20), (2, 2500, 128, 128), (5, 77, 128, 64),
                  (1, 33, 7, 128), (4, 16389, 40, 40), (70, 300, 128, 8),
                  (20, 4096, 128, 128), (3, 1037, 40, 40), (4, 2049, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LA_BF16_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k5_k6_bf16_match_plain(cuda, shape):
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = shape
    g = torch.Generator(device=cuda).manual_seed(n + d)
    k, q = (_bf16_rnd(g, cuda, bh, n, d) for _ in range(2))
    v = _bf16_rnd(g, cuda, bh, n, e)
    kernels.reset_launches()
    dots = tla.kv_dots(k, v)
    assert dots.dtype == torch.float32
    assert _rel(dots, tla.kv_dots_plain(k, v)) <= TOL_KERNEL
    assert _rel(dots, k.double().transpose(1, 2) @ v.double()) <= TOL_KERNEL
    for factor in (dots / n, (dots / n).bfloat16()):
        out = tla.apply_dots(q, factor)
        assert out.dtype == torch.bfloat16
        _bf16_close(out, tla.apply_dots_plain(q, factor))
        assert torch.equal(tla.apply_dots(q, factor), out)
    got = kernels.launches()
    assert (got["K5 kv_dots bf16"], got["K6 apply_dots bf16"]) == (1, 4)
    assert (got["K5 kv_dots"], got["K6 apply_dots"]) == (0, 0)
    assert torch.equal(tla.kv_dots(k, v), dots)  # fixed order: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LA_BF16_SHAPES[1:5:3], ids=lambda s: "x".join(map(str, s)))
def test_k5_k6_bf16_backward(cuda, shape):
    """The Functions' backward in bf16, with the JAX VJPs' dtypes: kv_dots'
    fp32 cotangent rounded to bf16 as K6's factor, dk, dv bf16; apply_dots'
    dq bf16 and ddots fp32. Each against its plain formula and against
    float64 autograd of the plain forward with the cotangent or factor
    rounded as the VJP rounds it (bf16 outputs: one rounding, 1e-2 of
    scale; ddots 1e-4)."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = shape
    g = torch.Generator(device=cuda).manual_seed(7 * n)
    q, k = (_leaf(_bf16_rnd(g, cuda, bh, n, d)) for _ in range(2))
    v = _leaf(_bf16_rnd(g, cuda, bh, n, e))
    dots = _leaf(torch.randn(bh, d, e, generator=g, device=cuda) / 8)
    kernels.reset_launches()
    cot = torch.randn(bh, d, e, generator=g, device=cuda)
    dk, dv = torch.autograd.grad(tla.kv_dots(k, v), (k, v), cot)
    assert dk.dtype == dv.dtype == torch.bfloat16
    _bf16_close(dk, tla.apply_dots_plain(v.detach(), cot.transpose(1, 2).contiguous()))
    _bf16_close(dv, tla.apply_dots_plain(k.detach(), cot))
    c64 = cot.bfloat16().double()
    k64, v64 = (_leaf(t.detach().double()) for t in (k, v))
    want = torch.autograd.grad(torch.einsum("bnd,bne->bde", k64, v64), (k64, v64), c64)
    for a, w in zip((dk, dv), want):
        assert _rel(a, w) <= 1e-2
    cot = _bf16_rnd(g, cuda, bh, n, e)
    dq, ddots = torch.autograd.grad(tla.apply_dots(q, dots), (q, dots), cot)
    assert dq.dtype == torch.bfloat16 and ddots.dtype == torch.float32
    _bf16_close(dq, tla.apply_dots_plain(cot, dots.detach().transpose(1, 2).contiguous()))
    assert _rel(ddots, tla.kv_dots_plain(q.detach(), cot)) <= TOL_KERNEL
    q64, d64 = _leaf(q.detach().double()), _leaf(dots.detach().bfloat16().double())
    want = torch.autograd.grad(torch.einsum("bnd,bde->bne", q64, d64), (q64, d64),
                               cot.double())
    assert _rel(dq, want[0]) <= 1e-2
    assert _rel(ddots, want[1]) <= 1e-4
    got = kernels.launches()
    # kv_dots' backward two K6 calls, apply_dots' one K6 and one K5
    assert (got["K5 kv_dots bf16"], got["K6 apply_dots bf16"]) == (2, 4)
    assert (got["K5 kv_dots"], got["K6 apply_dots"]) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4096, 128, 128), (3, 1037, 40, 40), (3, 1000, 12, 20),
                                   (2, 300, 36, 128)], ids=lambda s: "x".join(map(str, s)))
def test_k5_k6_bf16_route_by_shape(cuda, shape):
    """Widths that are multiples of 8 take the TMA kernels, K5 as exactly
    one device kernel a call (no workspace pass); other widths the bf16
    mma.sync kernels (K5's partials and their reduce)."""
    from torch.profiler import ProfilerActivity, profile

    from m_cedm_tpu_torch.kernels import linear_attention as tla

    bh, n, d, e = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    k, q = (_bf16_rnd(g, cuda, bh, n, d) for _ in range(2))
    v = _bf16_rnd(g, cuda, bh, n, e)
    dots = tla.kv_dots(k, v)
    tla.apply_dots(q, dots)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tla.kv_dots(k, v)
        torch.cuda.synchronize()
    k5 = [ev.name for ev in prof.events() if ev.device_type.name == "CUDA"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tla.apply_dots(q, dots)
        torch.cuda.synchronize()
    k6 = [ev.name for ev in prof.events() if ev.device_type.name == "CUDA"]
    if tla.tma_route(d, e):
        assert len(k5) == 1 and "kv_dots_tma_kernel" in k5[0], k5
        assert len(k6) == 1 and "apply_dots_tma_kernel" in k6[0], k6
    else:
        assert all("tma" not in nm for nm in k5 + k6), (k5, k6)
        assert any("kv_dots_partial_bf16_kernel" in nm for nm in k5), k5
        assert len(k6) == 1 and "apply_dots_bf16_kernel" in k6[0], k6


@pytest.mark.cuda
def test_k5_bf16_clusters_fit_one_wave(cuda):
    """The wrapper's cluster at the OFormer's BH: every cluster co-resident
    by cudaOccupancyMaxActiveClusters, and 2, 4, 8 blocks a head-batch
    where that holds."""
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    active = tla._active_clusters(cuda.index or 0)
    assert len(active) == tla.KV_CLUSTER_MAX and active[0] >= 1
    for bh in (1, 3, 16, 20, 64):
        c = tla.kv_cluster(bh, 16384, active)
        assert c in (1, 2, 4, 8) and (c == 1 or bh <= active[c - 1])


@pytest.mark.cuda
def test_k5_k6_bf16_refuse_other_mixes(cuda):
    from m_cedm_tpu_torch.kernels import linear_attention as tla

    q = torch.randn(2, 64, 32, device=cuda).bfloat16()
    dots = torch.randn(2, 32, 32, device=cuda)
    with pytest.raises(ValueError, match="must be"):
        tla.kv_dots(q, q.float())
    with pytest.raises(ValueError, match="must be"):
        tla.kv_dots(q.float(), q)
    with pytest.raises(ValueError, match="must be"):
        tla.apply_dots(q.float(), dots.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        tla.apply_dots(q, dots.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tla.apply_dots(q.half(), dots)


# --- K1's bf16 backward on clusters (gn_silu_bwd_cluster_kernel) and conv_in's
# bf16 wgrad on wgmma (wgrad_narrow_bf16_kernel): ragged rows, every channel
# width the kernels take, batches that fill one wave or not, bits on a repeat

K1_BWD_BF16_CASES = [(b, n, c) for b in (1, 80) for n in (333, 100003) for c in (8, 128, 2048)
                     if not (b == 80 and n == 100003 and c == 2048)]


def _k1_bwd_bf16_inputs(g, dev, b, n, c):
    x = _bf16_rnd(g, dev, b, n, c, scale=0.8, shift=0.2)
    gy = _bf16_rnd(g, dev, b, n, c)
    gamma = _bf16_rnd(g, dev, b, c, scale=0.3, shift=1.0, dtype=torch.float32)
    beta = _bf16_rnd(g, dev, b, c, scale=0.3, dtype=torch.float32)
    return gy, x, gamma, beta, tfn.channel_stats_plain(x)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", K1_BWD_BF16_CASES, ids=lambda v: str(v))
def test_k1_bf16_backward_cluster_kernel(cuda, b, n, c):
    """Against the bf16 plain version, bit for bit on a repeat, one launch
    counted a call; groups 32 where C takes them (eps 1e-6, the DDPM U-Net's
    norms), else one channel a group."""
    g = torch.Generator(device=cuda).manual_seed(b + n + c)
    gy, x, gamma, beta, stats = _k1_bwd_bf16_inputs(g, cuda, b, n, c)
    groups, eps = (32, 1e-6) if c % 32 == 0 else (c, 1e-5)
    before = tfn.gn_silu_bwd.launches
    got = tfn.gn_silu_bwd(gy, x, gamma, beta, stats, groups, eps)
    again = tfn.gn_silu_bwd(gy, x, gamma, beta, stats, groups, eps)
    assert tfn.gn_silu_bwd.launches == before + 2
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
    _bf16_grads_close(got, tfn.gn_silu_bwd_bf16_plain(gy, x, gamma, beta, groups, eps,
                                                      stats=stats))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,groups", [(32, 16384, 64, 16), (80, 16384, 8, 8)])
def test_k1_bf16_backward_repeats_over_many_calls(cuda, b, n, c, groups):
    """Shapes whose ring of chunk slots turns over many times (a sample's
    rows read again through it): 200 calls queued back to back, each
    checked against the first call's bits every 20."""
    g = torch.Generator(device=cuda).manual_seed(b + c)
    gy, x, gamma, beta, stats = _k1_bwd_bf16_inputs(g, cuda, b, n, c)
    first = [t.clone() for t in tfn.gn_silu_bwd(gy, x, gamma, beta, stats, groups)]
    for i in range(200):
        got = tfn.gn_silu_bwd(gy, x, gamma, beta, stats, groups)
        if i % 20 == 19:
            assert all(torch.equal(a, f) for a, f in zip(got, first)), i


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(16, 16384), (16, 4096), (32, 16384)])
def test_k1_bf16_backward_is_one_device_operation(cuda, b, n):
    """The train step's shapes: one launch and nothing else on the device
    (no buffer zeroed), and a plan that fills the card in one wave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(n)
    gy, x, gamma, beta, stats = _k1_bwd_bf16_inputs(g, cuda, b, n, 64)
    plan = tfn.bwd_bf16_plan(b, n, 64, 16, cuda)
    assert plan["waves"] == 1 and plan["grid"] <= plan["sms"]
    assert plan["grid"] // plan["cluster"] <= plan[f"active_{plan['cluster']}"]
    tfn.gn_silu_bwd(gy, x, gamma, beta, stats, 16)
    torch.cuda.synchronize()
    for _ in range(3):  # a capture with no device event at all is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tfn.gn_silu_bwd(gy, x, gamma, beta, stats, 16)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == 1 and "gn_silu_bwd_cluster_kernel" in ops[0], ops


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 4, 8, 3])
@pytest.mark.parametrize("o", [24, 64, 20, 21])
def test_narrow_wgrad_bf16_on_wgmma(cuda, c, o):
    """conv_in's bf16 wgrad (no input gradient) at ragged H and W: dW and
    dbias against the plain version, bit for bit on a repeat; O 24 and 64
    take g by TMA, O 20 by 4-byte cp.async pairs, O 21 by element copies."""
    g = torch.Generator(device=cuda).manual_seed(10 * c + o)
    x = _bf16_rnd(g, cuda, 3, 13, 37, c)
    gy = _bf16_rnd(g, cuda, 3, 13, 37, o)
    got = tfnc._wgrad(x, gy, None, None, None, 0, 1e-5, 9, False, True)
    again = tfnc._wgrad(x, gy, None, None, None, 0, 1e-5, 9, False, True)
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
    want = (tfnc.conv3x3_wgrad_plain(x.float(), gy.float()), gy.float().sum(dim=(0, 1, 2)))
    _bf16_grads_close(got, want)
    plan = tfnc._bf16_bwd_plan(1, False, 3, 13, 37, c, o, 9, cuda)
    assert plan[0] == 0 and plan[3] > 0  # the narrow route, with its shared memory
