"""The arithmetic of K4's bf16 kernels on wgmma, emulated on the CPU.

csrc/fused_attention.cu runs every product of its bf16 kernels as bf16
tensor-core products with fp32 accumulation. S = q k^T and dP = g v^T take
their bf16 operands as they are: a product of two bf16 values is exact in
fp32, so an fp32 matrix product of the bf16 values reproduces the tensor
core's terms, and only the order of the fp32 sums differs. The products with
an fp32 operand (P V, P^T g, dS k, dS^T q) split P or dS in three bf16
pieces (`split_bf16x3`, the kernel's `split3`) and sum the three products,
the small piece first, into the fp32 accumulator.

Held here, for the kernels' order (64-key tiles of an online softmax in the
forward; the dq walk over key tiles and the dk/dv walk over query tiles in
the backward, delta from the fp32 output):

- the split gives back every fp32 value exactly, negative and tiny ones and
  those next to 1 among them, where two pieces do not;
- the forward before its rounding within 1e-5 of scale of the Pallas
  `_fwd_kernel` (via `_pallas_fwd`, in interpret mode) on the same bf16
  values (the kernel upcasts bf16 to fp32 first, so fp32 copies of the bf16
  inputs give its output before the rounding), lse within 1e-5 of
  torch.logsumexp, and rounded to bf16 within the bf16 tolerances (1e-2 of
  scale at most, 1e-4 on average) of `_pallas_fwd` on the bf16 inputs;
- the backward within 1e-4 of each gradient's scale of `_bwd_kernel` (via
  `_pallas_bwd`) the same way, and rounded within the bf16 tolerances.

At L = 1 the softmax is 1 and dq, dk are zero in exact arithmetic: both
sides hold rounding noise there, held to 1e-5 absolute. Recorded, not
asserted: the errors with three pieces and with two instead of three. About 10 s in one
process, most of it the interpret-mode kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_attention as jfa
from m_cedm_tpu_torch.kernels.fused_attention import split_bf16x3
from test_torch_bf16_kernels import bf16, held, jb, tb
from test_torch_bf16_kernels import interpret  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TILE = 64  # csrc/fused_attention.cu's kTile: keys (queries) a streamed tile
SCALE = 0.125  # 1 / sqrt(64), a power of two
LOG2E = np.float32(1.4426950408889634)
C = np.float32(SCALE * LOG2E)  # the kernels' c: exp(x / 8 - m) = 2^(x c - m c)
TOL_FWD, TOL_BWD = 1e-5, 1e-4
LENGTHS = [1, 63, 65, 256]
N = 2


def products(acc, x, b, pieces=3):
    """acc + x @ b as the kernels run it: x (fp32) in bf16 pieces, the small
    piece first, each product of bf16 values summed in fp32; b holds bf16
    values."""
    hi, mid, lo = split_bf16x3(x)
    if pieces == 2:
        hi, mid, lo = hi, (x - hi.float()).to(torch.bfloat16), None
    for piece in (lo, mid, hi):
        if piece is not None:
            acc = acc + piece.float() @ b
    return acc


def fma(a, b, c):
    """a * b + c rounded once to fp32 (the product exact in float64)."""
    return (a.double() * float(b) + c.double()).float()


def forward_emulated(q, k, v, pieces=3):
    """(o32, lse): S exact in fp32 products, an online softmax over 64-key
    tiles on the raw dots (m their running max; exp(s / 8 - m / 8) as 2^(s c
    - m c), one FMA), P V from P's pieces."""
    n, length, d = q.shape
    m = torch.full((n, length), -torch.inf)
    l = torch.zeros(n, length)
    acc = torch.zeros(n, length, d)
    for k0 in range(0, length, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = q @ kt.transpose(1, 2)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2((m - m_new) * C)
        p = torch.exp2(fma(s, C, -(m_new * C)[..., None]))
        l = l * corr + p.sum(dim=-1)
        acc = products(acc * corr[..., None], p, vt, pieces)
        m = m_new
    return acc / l[..., None], m * SCALE + torch.log(l)


def backward_emulated(q, k, v, g, o32, lse, pieces=3):
    """(dq, dk, dv) in fp32: the dq kernel over key tiles (delta = rowsum(g *
    o32), P = exp(S / 8 - lse) = 2^(S c - lse log2(e)), dS = P (dP - delta),
    dq += dS k), then the dk/dv kernel over query tiles (S^T = k q^T, dv +=
    P^T g, dk += dS^T q)."""
    delta = (g * o32).sum(dim=-1)
    lse2 = lse * LOG2E
    length = q.shape[1]
    dq = torch.zeros_like(q)
    for k0 in range(0, length, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        p = torch.exp2(fma(q @ kt.transpose(1, 2), C, -lse2[..., None]))
        ds = p * (g @ vt.transpose(1, 2) - delta[..., None])
        dq = products(dq, ds, kt, pieces)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, length, TILE):
        qt, gt = q[:, q0:q0 + TILE], g[:, q0:q0 + TILE]
        lt, dt = lse2[:, None, q0:q0 + TILE], delta[:, None, q0:q0 + TILE]
        pt = torch.exp2(fma(k @ qt.transpose(1, 2), C, -lt))
        dst = pt * (v @ gt.transpose(1, 2) - dt)
        dv = products(dv, pt, gt, pieces)
        dk = products(dk, dst, qt, pieces)
    return dq * SCALE, dk * SCALE, dv


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def inputs(length, peak, n=N, count=3):
    """bf16 values (as fp32 numpy) from a seed; q scaled by `peak`, so that at
    peak 6 a row's max moves between key tiles (the online rescale)."""
    rs = np.random.RandomState(1000 * int(peak) + length)
    arrays = [bf16(rs, n, length, 64) for _ in range(count)]
    arrays[0] = np.asarray(tb(arrays[0] * peak).float())  # bf16 values again
    return arrays


def test_split_gives_back_every_value(record_property):
    rs = np.random.RandomState(0)
    draws = [rs.randn(4096) * np.exp(rs.uniform(-60, 60, 4096)),  # any sign and size
             -rs.uniform(0, 1, 4096),                            # negative dS
             rs.choice([-1, 1], 4096) * 10.0 ** rs.uniform(-33, -20, 4096),  # tiny dS
             1.0 - rs.uniform(0, 1e-6, 4096),                    # next to 1
             [1.0 - 2.0 ** -24, 1.0 - 2.0 ** -23, 1.0, 2.0 ** -126, 0.0, -0.0]]
    x = torch.from_numpy(np.concatenate(draws).astype(np.float32))
    hi, mid, lo = split_bf16x3(x)
    assert (hi.dtype, mid.dtype, lo.dtype) == (torch.bfloat16,) * 3
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert torch.equal(hi.float() + (mid.float() + lo.float()), x)
    # each piece at most half an ulp of the one before: |mid| <= 2^-9 |hi|
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    # below 2^-110 a residual falls under 2^-126, where bf16 keeps fewer bits:
    # the sum is then off by at most bf16's least subnormal step, 2^-133
    sub = torch.from_numpy((rs.uniform(-1, 1, 4096) * 2.0 ** -110).astype(np.float32))
    pieces = [t.float() for t in split_bf16x3(sub)]
    assert float(((pieces[0] + pieces[1]) + pieces[2] - sub).abs().max()) <= 2.0 ** -133
    two = hi.float() + (x - hi.float()).to(torch.bfloat16).float()
    record_property("two_pieces_max_rel", float(((two - x).abs() / x.abs().clamp_min(1e-38)).max()))
    assert not torch.equal(two, x)


@pytest.mark.parametrize("peak", [1.0, 6.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("length", LENGTHS)
def test_forward_order_matches_pallas(interpret, length, peak, record_property):
    q, k, v = inputs(length, peak)
    o32, lse = forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)))
    want = np.asarray(jfa._pallas_fwd(*(jnp.asarray(a) for a in (q, k, v))))
    assert want.dtype == np.float32
    record_property("three_pieces_rel", rel(o32, want))
    assert rel(o32, want) <= TOL_FWD
    logits = torch.from_numpy(q).double() @ torch.from_numpy(k).double().transpose(1, 2)
    assert rel(lse, torch.logsumexp(logits * SCALE, dim=-1)) <= TOL_FWD
    want16 = jfa._pallas_fwd(jb(q), jb(k), jb(v))
    assert want16.dtype == jnp.bfloat16
    held(o32.to(torch.bfloat16), want16)
    two, _ = forward_emulated(*(torch.from_numpy(a) for a in (q, k, v)), pieces=2)
    record_property("two_pieces_rel", rel(two, want))


@pytest.mark.parametrize("peak", [1.0, 6.0], ids=["normal", "peaked"])
@pytest.mark.parametrize("length", LENGTHS)
def test_backward_order_matches_pallas(interpret, length, peak, record_property):
    q, k, v, g = inputs(length, peak, count=4)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o32, lse = forward_emulated(tq, tk, tv)
    got = backward_emulated(tq, tk, tv, tg, o32, lse)
    want = [np.asarray(a) for a in jfa._pallas_bwd(*(jnp.asarray(a) for a in (q, k, v, g)))]
    want16 = jfa._pallas_bwd(jb(q), jb(k), jb(v), jb(g))
    two = backward_emulated(tq, tk, tv, tg, o32, lse, pieces=2)
    for i, (a, w, w16) in enumerate(zip(got, want, want16)):
        assert w.dtype == np.float32 and w16.dtype == jnp.bfloat16
        if length == 1 and i < 2:
            # one key: dS = dP - delta is zero in exact arithmetic
            assert float(a.abs().max()) <= 1e-5 and float(np.abs(w).max()) <= 1e-5
            continue
        record_property(f"three_pieces_rel_{i}", rel(a, w))
        assert rel(a, w) <= TOL_BWD, i
        held(a.to(torch.bfloat16), w16)
        record_property(f"two_pieces_rel_{i}", rel(two[i], w))
