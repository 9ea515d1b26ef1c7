"""The arithmetic of K4's tensor-core kernels, emulated on the CPU.

csrc/fused_attention.cu runs every product of the attention on TF32 tensor
cores: each fp32 operand x is split as hi = tf32(x), lo = tf32(x - hi), and
a product a * b is summed in fp32 as lo_a hi_b + hi_a lo_b + hi_a hi_b
(3xTF32). tf32() rounds to 10 mantissa bits, to nearest: the kernels use
`cvt.rn.tf32.f32` (ties to even), one instruction on sm_90; `cvt.rna`
(ties away from zero) is held here too. A product of two TF32 values is
exact in fp32, so fp32 matrix products of the split parts reproduce the
tensor core's terms; only the order of the fp32 sums differs.

Held here: attention at the flagship's (L, D) = (1024, 64) computed that way
stays within 2e-5 of scale of float64, the bound chip_smoke.py holds the
forward kernel to. Recorded, not asserted: the error of one TF32 pass.
K6 (csrc/linear_attention.cu::apply_dots_kernel) runs q @ dots the same
way: at (N, D, E) = (256, 128, 128) and at ragged widths it stays within
1e-6 of scale of float64, and one TF32 pass is shown to exceed the 2e-5
bound. JAX-free; well under a second a case.
"""
import math

import numpy as np
import pytest
import torch

TOL_KERNEL = 2e-5  # chip_smoke.py's forward-kernel tolerance, of max(1, scale)


def tf32_round(x: torch.Tensor, ties: str) -> torch.Tensor:
    """cvt.rn / cvt.rna .tf32.f32 on float32 bits: add just under (ties to
    even: 0xfff plus the lowest kept bit) or exactly (ties away: 0x1000)
    half of the 13 dropped bits' range to the magnitude, then clear them.
    The bits are sign-magnitude, so this rounds the magnitude."""
    bits = x.contiguous().view(torch.int32)
    half = 0x1000 if ties == "away" else 0xFFF + ((bits >> 13) & 1)
    return ((bits + half) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, ties: str):
    hi = tf32_round(x, ties)
    return hi, tf32_round(x - hi, ties)


def attention(q, k, v, mm):
    """The forward kernel's math: scale 1/8 applied exactly to the dot,
    softmax in fp32, both products through `mm`."""
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return mm(torch.softmax(s, dim=-1), v)


def rel_err(got, want):
    return float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("ties", ["even", "away"])
def test_tf32_rounding_and_split(ties):
    one = 1.0 + 2.0 ** -10  # the TF32 neighbours of 1.0 are 1.0 and `one`
    tie = 1.0 + 2.0 ** -11  # halfway; 1.0 has an even last bit
    x = torch.tensor([tie, -tie, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12,
                      one + 2.0 ** -11, 3.0, 0.0], dtype=torch.float32)
    tie_to = 1.0 if ties == "even" else one
    want = torch.tensor([tie_to, -tie_to, 1.0, one, 1.0 + 2.0 ** -9, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_round(x, ties), want)
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    hi, lo = split(x, ties)
    # lo keeps 11 of the up to 13 bits that hi drops: 2^-22 of x at most
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("ties", ["even", "away"])
def test_3xtf32_attention_keeps_fp32_accuracy(ties, record_property):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 1024, 64).astype(np.float32) for _ in range(3))
    want = attention(*(torch.from_numpy(a).double() for a in (q, k, v)),
                     mm=torch.matmul)

    def mm_3x(a, b):
        (ah, al), (bh, bl) = split(a, ties), split(b, ties)
        return al @ bh + ah @ bl + ah @ bh  # small terms first, as the kernel

    def mm_1x(a, b):
        return tf32_round(a, ties) @ tf32_round(b, ties)

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    err_3x = rel_err(attention(tq, tk, tv, mm_3x), want)
    err_1x = rel_err(attention(tq, tk, tv, mm_1x), want)
    err_fp32 = rel_err(attention(tq, tk, tv, torch.matmul), want)
    record_property("err_3xtf32", err_3x)
    record_property("err_1xtf32", err_1x)
    record_property("err_fp32", err_fp32)
    print(f"attention vs float64, of scale, ties {ties}: 3xTF32 {err_3x:.2e}, "
          f"1xTF32 {err_1x:.2e}, fp32 {err_fp32:.2e}")
    assert err_3x <= TOL_KERNEL


def mm_3xtf32(a, b, ties="even"):
    """a @ b as the kernels sum it: lo*hi + hi*lo + hi*hi, small terms first."""
    (ah, al), (bh, bl) = split(a, ties), split(b, ties)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("d,e", [(128, 128), (100, 7), (7, 100), (1, 64)])
def test_3xtf32_apply_dots_keeps_fp32_accuracy(d, e, record_property):
    """K6's product q @ (k^T v / n) on the OFormer's operands (normal q, k,
    v; the factor as the attention forms it), cvt.rn rounding."""
    rs = np.random.RandomState(d * 1000 + e)
    n = 256
    q, k = (torch.from_numpy(rs.randn(2, n, d).astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rs.randn(2, n, e).astype(np.float32))
    dots = (k.transpose(1, 2) @ v) / n
    want = q.double() @ dots.double()
    err_3x = rel_err(mm_3xtf32(q, dots), want)
    err_1x = rel_err(tf32_round(q, "even") @ tf32_round(dots, "even"), want)
    record_property("err_3xtf32", err_3x)
    record_property("err_1xtf32", err_1x)
    print(f"apply_dots ({d}, {e}) vs float64, of scale: 3xTF32 {err_3x:.2e}, "
          f"1xTF32 {err_1x:.2e}")
    assert err_3x <= 1e-6
    assert err_1x > TOL_KERNEL
