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
bound. K2/K3's conv core (csrc/fused_norm_conv.cu::gnsc_kernel) and K5
(kv_dots_partial_kernel) are emulated in their own order: the conv in
8-channel chunks of nine taps each, then the 1x1 projection's chunks, and
kv_dots in split-N blocks of row stages of 8-row k-steps whose partials
are summed in a fixed order; each sums kTempSteps (kKvTempSteps) k-steps of
the three products into a zeroed partial before one fp32 add, as the
constants in the CUDA sources say. Both are held within 2e-5 of scale of
float64; the error of one TF32 pass is recorded. JAX-free; well under a
second a case.
"""
import math
import re
from pathlib import Path

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


CSRC = Path(__file__).resolve().parents[1] / "m_cedm_tpu_torch" / "csrc"


def _constant(source: str, name: str) -> int:
    """An integer constexpr of a CUDA source, as the kernel is built."""
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, (source, name)
    return int(found[0])


def _mma_steps(pairs, acc, temp_steps, mm):
    """acc + the k-steps of `pairs` ((a, b) operand pairs, one a k-step),
    temp_steps of them summed into a zeroed partial through `mm` before one
    fp32 add, as the kernels' accumulation does."""
    for k0 in range(0, len(pairs), temp_steps):
        part = torch.zeros_like(acc)
        for a, b in pairs[k0:k0 + temp_steps]:
            part = mm(part, a, b)
        acc = acc + part
    return acc


def _mm_3x(part, a, b):
    """The three tensor-core products of a k-step, small terms first."""
    (ah, al), (bh, bl) = split(a, "even"), split(b, "even")
    return part + al @ bh + ah @ bl + ah @ bh


def _mm_1x(part, a, b):
    return part + tf32_round(a, "even") @ tf32_round(b, "even")


def conv_emulated(act, w, res, skip_w, mm):
    """gnsc_kernel's products on an activated NHWC input: 8-channel chunks,
    each the nine taps in order (k-steps of eight channels), then the 1x1
    projection's 8-channel chunks (one k-step each) into the same
    accumulator; bias and residual adds left out (exact fp32 adds on both
    sides)."""
    temp = _constant("fused_norm_conv.cu", "kTempSteps")
    b, h, wd, c = act.shape
    o = w.shape[-1]
    pad = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(b * h * wd, o)
    for c0 in range(0, c, 8):
        pairs = [(pad[:, dy:dy + h, dx:dx + wd, c0:c0 + 8].reshape(-1, min(8, c - c0)),
                  w[dy, dx, c0:c0 + 8]) for dy in range(3) for dx in range(3)]
        acc = _mma_steps(pairs, acc, temp, mm)
    if res is not None:
        flat = res.reshape(-1, res.shape[-1])
        for c0 in range(0, flat.shape[1], 8):
            acc = _mma_steps([(flat[:, c0:c0 + 8], skip_w[c0:c0 + 8])], acc, temp, mm)
    return acc.reshape(b, h, wd, o)


# (B, H, W, C, O, Cr): a block tail over 64 channels, the decoder's conv0
# over the 128-channel concat with its 1x1 projection over Cr = 128, and
# ragged channel counts
K2_CASES = [(2, 12, 20, 64, 64, 0), (1, 10, 14, 128, 64, 128), (2, 7, 9, 20, 40, 12)]


@pytest.mark.parametrize("case", K2_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_conv_core_keeps_fp32_accuracy(case, record_property):
    """K2/K3's conv core, emulated in the kernel's order and accumulation,
    against float64: within 2e-5 of scale (activations as a SiLU leaves
    them, fan-in-scaled weights); one TF32 pass recorded."""
    b, h, wd, c, o, cr = case
    rs = np.random.RandomState(sum(case))
    act = torch.from_numpy((rs.randn(b, h, wd, c) * 0.8 + 0.3).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32))
    res = skip_w = None
    if cr:
        res = torch.from_numpy(rs.randn(b, h, wd, cr).astype(np.float32))
        skip_w = torch.from_numpy((rs.randn(cr, o) / math.sqrt(cr)).astype(np.float32))
    want = torch.nn.functional.conv2d(act.double().permute(0, 3, 1, 2),
                                      w.double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    if cr:
        want = want + res.double() @ skip_w.double()
    err_3x = rel_err(conv_emulated(act, w, res, skip_w, _mm_3x), want)
    err_1x = rel_err(conv_emulated(act, w, res, skip_w, _mm_1x), want)
    record_property("err_3xtf32", err_3x)
    record_property("err_1xtf32", err_1x)
    print(f"conv core {case} vs float64, of scale: 3xTF32 {err_3x:.2e}, "
          f"1xTF32 {err_1x:.2e}")
    assert err_3x <= TOL_KERNEL


def kv_dots_emulated(k, v, splits, mm):
    """kv_dots_partial_kernel's products for one head-batch: k, v (N, D / E)
    split into `splits` row ranges (rounded up to the kKvRows-row stage, as
    the wrapper asks), each walked in stages of 8-row k-steps, the partial
    tiles then summed in the order s = 0, 1, ..."""
    temp = _constant("linear_attention.cu", "kKvTempSteps")
    stage = _constant("linear_attention.cu", "kKvRows")
    n = k.shape[0]
    rows = math.ceil(math.ceil(n / splits) / stage) * stage
    out = torch.zeros(k.shape[1], v.shape[1])
    for s0 in range(0, splits * rows, rows):
        acc = torch.zeros_like(out)
        for c0 in range(s0, min(n, s0 + rows), stage):
            c1 = min(n, s0 + rows, c0 + stage)
            pairs = [(k[r:min(r + 8, c1)].T, v[r:min(r + 8, c1)]) for r in range(c0, c1, 8)]
            acc = _mma_steps(pairs, acc, temp, mm)
        out = out + acc
    return out


# (N, D, E, splits): N no multiple of the stage, D and E under 128 and no
# multiples of 8, one split and several (the last one empty: 77 rows in
# three splits of 64)
KV_CASES = [(1000, 12, 20, 3), (77, 100, 7, 3), (4096, 128, 128, 8), (300, 1, 1, 1)]


@pytest.mark.parametrize("case", KV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_kv_dots_keeps_fp32_accuracy(case, record_property):
    """K5's k^T v, emulated in the kernel's order and accumulation, on
    normal operands against float64: within 2e-5 of scale; one TF32 pass
    recorded."""
    n, d, e, splits = case
    rs = np.random.RandomState(n + d + e)
    k = torch.from_numpy(rs.randn(n, d).astype(np.float32))
    v = torch.from_numpy(rs.randn(n, e).astype(np.float32))
    want = k.double().T @ v.double()
    err_3x = rel_err(kv_dots_emulated(k, v, splits, _mm_3x), want)
    err_1x = rel_err(kv_dots_emulated(k, v, splits, _mm_1x), want)
    record_property("err_3xtf32", err_3x)
    record_property("err_1xtf32", err_1x)
    print(f"kv_dots {case} vs float64, of scale: 3xTF32 {err_3x:.2e}, 1xTF32 {err_1x:.2e}")
    assert err_3x <= TOL_KERNEL
