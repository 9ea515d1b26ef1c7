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
float64; the error of one TF32 pass is recorded. The K2/K3 backward
(csrc/fused_norm_conv_bwd.cu) is emulated the same way, each in its own
order: dgrad as the forward's loop on the cotangent with the mirrored,
transposed weight, then silu'(a) and dgamma / dbeta as per-tile partials
summed in colsum_kernel's fixed order; wgrad as 8-pixel k-steps of each
image's tile runs (nine taps, or one spread over the nine warps), a
zeroed partial per kWTempSteps k-steps, and the runs' partials summed in
the fixed order (at C <= 8 its fp32 narrow-C kernel, pixel by pixel). They are held within 1e-4 of scale of float64 (the
bound chip_smoke.py holds the backward to). Beside them, each named
variant of kernels/attention_sources.py is held to apply to its source.
JAX-free; well under a second a case.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from m_cedm_tpu_torch.kernels.attention_sources import KERNELS, VARIANTS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


def conv_emulated(act, w, res, skip_w, mm, source="fused_norm_conv.cu"):
    """gnsc_kernel's products on an activated NHWC input: 8-channel chunks,
    each the nine taps in order (k-steps of eight channels), then the 1x1
    projection's 8-channel chunks (one k-step each) into the same
    accumulator; bias and residual adds left out (exact fp32 adds on both
    sides). dgrad_kernel runs the same loop on the cotangent (`source` names
    the kTempSteps to read)."""
    temp = _constant(source, "kTempSteps")
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


# ---------------------------------------------------------------------------
# the K2 / K3 backward (csrc/fused_norm_conv_bwd.cu)
# ---------------------------------------------------------------------------

BWD = "fused_norm_conv_bwd.cu"
TOL_BWD = 1e-4  # chip_smoke.py's backward tolerance, of max(1, scale)


def colsum_emulated(parts):
    """colsum_kernel on (n, K) partials: group i of kSumGroups adds rows i,
    i + groups, ... in order, then the groups' sums are added in order."""
    groups = _constant(BWD, "kSumGroups")
    sums = [torch.zeros(parts.shape[1:])] * groups
    for i in range(parts.shape[0]):
        sums[i % groups] = sums[i % groups] + parts[i]
    total = sums[0]
    for t in sums[1:]:
        total = total + t
    return total


def wgrad_emulated(act, g, runs, taps, mm):
    """wgrad_kernel on the activated conv input `act` (K3: already
    upsampled) and the cotangent g, both (B, H, W, *): each image's
    kWTH x kWTW pixel tiles in raster order, cut into `runs` runs; per run
    the 8-pixel k-steps (half a tile row; none past the last image row) in
    order, each tap's product into a zeroed partial that is added to the
    fp32 sum after every kWTempSteps k-steps of a tile and at its end. One
    tap: the k-steps go round the kWWarps warps, whose sums are added in
    warp order. Then the (B * runs) partials in colsum's order. Returns
    (dw (taps, C, O), dbias (O,))."""
    th, tw = _constant(BWD, "kWTH"), _constant(BWD, "kWTW")
    temp, warps = _constant(BWD, "kWTempSteps"), _constant(BWD, "kWWarps")
    b, h, wd, c = act.shape
    o = g.shape[-1]
    tiles_w, tiles = math.ceil(wd / tw), math.ceil(h / th) * math.ceil(wd / tw)
    per = math.ceil(tiles / runs)
    pad = torch.nn.functional.pad(act, (0, 0, 1, tw + 1, 1, th + 1))
    gp = torch.nn.functional.pad(g, (0, 0, 0, tw, 0, th))
    slots = warps if taps == 1 else 1
    shifts = [(dy, dx) for dy in range(3) for dx in range(3)] if taps == 9 else [(1, 1)]
    parts = []
    for bi in range(b):
        for r in range(runs):
            acc = torch.zeros(slots, taps, c, o)
            kstep, gsum = 0, torch.zeros(o)
            for tile in range(r * per, min(tiles, (r + 1) * per)):
                ty0, tx0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
                nsteps = 2 * min(th, h - ty0)
                for s0 in range(0, nsteps, temp):
                    part = torch.zeros_like(acc)
                    for s in range(s0, min(s0 + temp, nsteps)):
                        y, x0 = ty0 + s // 2, tx0 + 8 * (s % 2)
                        gk = gp[bi, y, x0:x0 + 8]
                        gsum = gsum + gk.sum(0)
                        ak = torch.stack([pad[bi, y + dy, x0 + dx:x0 + dx + 8].T
                                          for dy, dx in shifts])
                        w = (kstep + s) % slots
                        part[w] = mm(part[w], ak, gk)
                    acc = acc + part
                kstep += nsteps
            total = acc[0]
            for w in range(1, slots):
                total = total + acc[w]
            parts.append(torch.cat([total.reshape(-1), gsum]))
    out = colsum_emulated(torch.stack(parts))
    return out[:-o].reshape(taps, c, o), out[-o:]


def wgrad_narrow_emulated(act, g, runs):
    """wgrad_narrow_kernel (C <= kNC, 3 x 3) in fp32 on the CUDA cores: each
    image's kNTH x kNTW tiles in raster order cut into `runs` runs; per run a
    thread for each output channel and pair of tile rows adds act x g with
    one fmaf a weight, pixel by pixel along its rows; then the row pairs'
    sums in order, and the runs' partials in colsum's order."""
    th, tw = _constant(BWD, "kNTH"), _constant(BWD, "kNTW")
    b, h, wd, c = act.shape
    o = g.shape[-1]
    tiles_w, tiles = math.ceil(wd / tw), math.ceil(h / th) * math.ceil(wd / tw)
    per = math.ceil(tiles / runs)
    pad = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1)).double()
    parts = []
    for bi in range(b):
        for r in range(runs):
            accs, gs = torch.zeros(th // 2, 9, c, o), torch.zeros(th // 2, o)
            for tile in range(r * per, min(tiles, (r + 1) * per)):
                ty0, tx0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
                for y in range(ty0, min(h, ty0 + th)):
                    pg = (y - ty0) // 2
                    for x in range(tx0, min(wd, tx0 + tw)):
                        win = pad[bi, y:y + 3, x:x + 3].reshape(9, c)
                        gv = g[bi, y, x]
                        # fmaf: the product exact, one rounding of the sum
                        accs[pg] = (accs[pg].double() + win[:, :, None] * gv.double()).float()
                        gs[pg] = gs[pg] + gv
            total, gsum = accs[0], gs[0]
            for q in range(1, th // 2):
                total, gsum = total + accs[q], gsum + gs[q]
            parts.append(torch.cat([total.reshape(-1), gsum]))
    out = colsum_emulated(torch.stack(parts))
    return out[:-o].reshape(9, c, o), out[-o:]


def _bwd_operands(seed, b, h, wd, c, o):
    rs = np.random.RandomState(seed)
    act = torch.from_numpy((rs.randn(b, h, wd, c) * 0.8 + 0.3).astype(np.float32))
    g = torch.from_numpy(rs.randn(b, h, wd, o).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32))
    return act, g, w


# (B, H, W, C, O, taps, runs, up): C 64 and 128, ragged C and O, K3 (the
# activation upsampled from a low-res 5 x 7), the 1x1 projection over
# Cr = 128, C = 12 (a block's 32 channels mostly padding), conv_in's C = 4
# (the narrow-C kernel, fp32); H and W no multiple of the 4 x 16 or 8 x 32
# tile
WGRAD_CASES = [(2, 9, 20, 64, 64, 9, 3, False), (1, 6, 18, 128, 64, 9, 2, False),
               (2, 7, 9, 20, 70, 9, 2, False), (2, 10, 14, 64, 40, 9, 2, True),
               (2, 9, 20, 128, 64, 1, 2, False), (2, 9, 20, 12, 64, 9, 3, False),
               (2, 12, 40, 4, 64, 9, 3, False)]


@pytest.mark.parametrize("case", WGRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_conv_wgrad_keeps_fp32_accuracy(case, record_property):
    """mc_conv_wgrad's dW and dbias, emulated in the order and accumulation
    of the kernel it launches, against float64: within 1e-4 of scale. The
    tensor-core kernel's one TF32 pass is recorded; at C <= kNC (3 x 3, not
    K3) the narrow-C kernel's fp32 sums are emulated instead."""
    from m_cedm_tpu_torch.kernels.fused_norm_conv import (conv3x3_wgrad_plain,
                                                          upsample2x_nearest)

    b, h, wd, c, o, taps, runs, up = case
    act, g, _ = _bwd_operands(sum(case[:6]), b, h, wd, c, o)
    if up:
        act = upsample2x_nearest(act[:, :h // 2, :wd // 2])
    if taps == 9:
        want = conv3x3_wgrad_plain(act.double(), g.double())
    else:
        want = torch.einsum("bhwc,bhwo->co", act.double(), g.double())[None]
    want_b = g.double().sum(dim=(0, 1, 2))
    if c <= _constant(BWD, "kNC") and taps == 9 and not up:
        dw, db = wgrad_narrow_emulated(act, g, runs)
        err = max(rel_err(dw.reshape(want.shape), want), rel_err(db, want_b))
        record_property("err_fp32", err)
        print(f"wgrad {case} (narrow C, fp32) vs float64, of scale: {err:.2e}")
        assert err <= TOL_BWD
        return
    errs = {}
    for name, mm in (("3x", _mm_3x), ("1x", _mm_1x)):
        dw, db = wgrad_emulated(act, g, runs, taps, mm)
        errs[name] = max(rel_err(dw.reshape(want.shape), want), rel_err(db, want_b))
    record_property("err_3xtf32", errs["3x"])
    record_property("err_1xtf32", errs["1x"])
    print(f"wgrad {case} vs float64, of scale: 3xTF32 {errs['3x']:.2e}, "
          f"1xTF32 {errs['1x']:.2e}")
    assert errs["3x"] <= TOL_BWD


def dgrad_emulated(g, w, mm):
    """dgrad_kernel's products: the forward's loop on the cotangent with the
    mirrored, transposed weight W'[dy, dx] = w[2 - dy, 2 - dx]^T."""
    return conv_emulated(g, w.flip(0, 1).transpose(2, 3), None, None, mm, source=BWD)


def tile_partials(t, th, tw):
    """(B, H, W, C) -> (B, tiles, C): per-pixel-tile sums in raster order."""
    b, h, wd, c = t.shape
    tp = torch.nn.functional.pad(t, (0, 0, 0, -wd % tw, 0, -h % th))
    tp = tp.reshape(b, tp.shape[1] // th, th, tp.shape[2] // tw, tw, c)
    return tp.sum(dim=(2, 4)).reshape(b, -1, c)


# (B, H, W, C, O, mode): C 64 and 128 (the decoder conv0's dgrad), ragged C
# and O, the linear mode, and K3's up-fold at high resolution 8 x 12
DGRAD_CASES = [(2, 9, 20, 64, 64, "act"), (1, 10, 14, 128, 64, "act"),
               (2, 7, 9, 20, 70, "act"), (2, 9, 20, 64, 64, "linear"),
               (2, 8, 12, 64, 64, "up")]


@pytest.mark.parametrize("case", DGRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_conv_dgrad_keeps_fp32_accuracy(case, record_property):
    """dgrad_kernel's da (and in the act mode dgamma, dbeta from per-tile
    partials in colsum's order; in the up-fold the column pairs, then the
    row pairs), emulated in its own order, against float64: within 1e-4 of
    scale; one TF32 pass recorded."""
    from m_cedm_tpu_torch.kernels.fused_norm import group_mean_rstd_from_sums
    from m_cedm_tpu_torch.kernels.fused_norm_conv import (_fold2x2,
                                                          conv3x3_dgrad_plain)

    b, h, wd, c, o, mode = case
    x, g, w = _bwd_operands(sum(case[:5]), b, h, wd, c, o)
    rs = np.random.RandomState(b + c)
    gamma = torch.from_numpy((rs.randn(b, c) * 0.3 + 1.0).astype(np.float32))
    beta = torch.from_numpy((rs.randn(b, c) * 0.3).astype(np.float32))
    th, tw = _constant(BWD, "kTH"), _constant(BWD, "kTW")

    def epilogue(ds, t):  # t: float32 or float64, as the kernel or the reference
        if mode == "up":
            return (_fold2x2(ds),)
        if mode == "linear":
            return (ds,)
        xs = x.to(t)
        sums, sumsq = xs.sum(dim=(1, 2)), (xs * xs).sum(dim=(1, 2))
        mean, rstd = group_mean_rstd_from_sums(sums, sumsq, h * wd, 4, 1e-5)
        xhat = (xs - mean[:, None, None]) * rstd[:, None, None]
        a = xhat * gamma.to(t)[:, None, None] + beta.to(t)[:, None, None]
        sig = torch.sigmoid(a)
        da = ds * sig * (1 + a * (1 - sig))
        if t == torch.float64:
            return da, (da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))
        parts = torch.stack([tile_partials(da * xhat, th, tw), tile_partials(da, th, tw)])
        dstats = colsum_emulated(parts.permute(2, 0, 1, 3))  # tiles first
        return da, dstats[0], dstats[1]

    want = epilogue(conv3x3_dgrad_plain(g.double(), w.double()), torch.float64)
    errs = {}
    for name, mm in (("3x", _mm_3x), ("1x", _mm_1x)):
        got = epilogue(dgrad_emulated(g, w, mm), torch.float32)
        errs[name] = max(rel_err(a, w_) for a, w_ in zip(got, want, strict=True))
    record_property("err_3xtf32", errs["3x"])
    record_property("err_1xtf32", errs["1x"])
    print(f"dgrad {case} vs float64, of scale: 3xTF32 {errs['3x']:.2e}, "
          f"1xTF32 {errs['1x']:.2e}")
    assert errs["3x"] <= TOL_BWD


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_measurement_variants_apply_to_their_sources(name):
    """Each named variant of kernels/attention_sources.py (the rivals and
    diagnostics the records cite) replaces exactly one passage of its
    kernel's package source, or of the csrc header it names; the tool
    refuses it on the card otherwise."""
    kernel, old, _, *header = VARIANTS[name]
    path = CSRC / (header[0] if header else KERNELS[kernel][0])
    assert path.read_text().count(old) == 1
    if header:  # a header the kernel's source includes
        assert f'#include "{header[0]}"' in (CSRC / KERNELS[kernel][0]).read_text()


# ---------------------------------------------------------------------------
# K7, the whole block (csrc/fused_block.cu)
# ---------------------------------------------------------------------------

K7 = "fused_block.cu"
TOL_MEGA = 4e-5  # chip_smoke.py's K7 tolerance, of max(1, scale)


def k7_tile_partials(v):
    """unet_block_kernel's per-item statistics of v (B, H, W, O): each
    thread of a kTH x kTW tile adds its four pixels (row 2 rg + m, column
    g + 8 h; m, then h), a butterfly over g (xor 1, 2, 4) adds the
    threads of a row pair, then the four row pairs are added in order.
    Returns (B, tiles, O), tiles in raster order."""
    th, tw = _constant(K7, "kTH"), _constant(K7, "kTW")
    b, h, wd, o = v.shape
    vp = torch.nn.functional.pad(v, (0, 0, 0, -wd % tw, 0, -h % th))
    ty, tx = vp.shape[1] // th, vp.shape[2] // tw
    v8 = vp.reshape(b, ty, th // 2, 2, tx, 2, tw // 2, o).permute(0, 1, 4, 2, 3, 5, 6, 7)
    s = torch.zeros(b, ty, tx, th // 2, tw // 2, o)
    for m in range(2):
        for hh in range(2):
            s = s + v8[:, :, :, :, m, hh]
    lanes = torch.arange(tw // 2)
    for k in (1, 2, 4):
        s = s + s[:, :, :, :, lanes ^ k]
    total = torch.zeros(b, ty, tx, o)
    for rg in range(th // 2):
        total = total + s[:, :, :, rg, 0]
    return total.reshape(b, ty * tx, o)


def k7_reduce_partials(part):
    """reduce_partials on (B, tiles, O): lane l of a warp adds tiles l,
    l + 32, ... in order, then a butterfly (xor 16, 8, 4, 2, 1)."""
    b, tiles, o = part.shape
    lanes = torch.zeros(32, b, o)
    for t in range(tiles):
        lanes[t % 32] = lanes[t % 32] + part[:, t]
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ off]
    return lanes[0]


def k7_act(x, sums, sumsq, gamma, beta, groups, cnt_pix, eps=1e-5):
    """The staging pass's norm + SiLU: the group statistics folded with
    gamma / beta into one fp32 scale and shift per channel."""
    b, c = sums.shape
    per = c // groups
    gs, gss = (t.reshape(b, groups, per).sum(-1).repeat_interleave(per, -1)
               for t in (sums, sumsq))
    mean = gs / (cnt_pix * per)
    var = torch.clamp(gss / (cnt_pix * per) - mean * mean, min=0.0)
    a = gamma * torch.rsqrt(var + eps)
    y = x * a[:, None, None] + (beta - a * mean)[:, None, None]
    return y / (1 + torch.exp(-y))


def k7_emulated(t, groups, up, mm):
    """unet_block_kernel's arithmetic on the block's fp32 inputs `t`: conv0
    of the activated xin on the conv core (fused_block.cu's kTempSteps),
    norm1 folded from the per-item partials of h summed in the fixed order,
    conv1 of the activated h with the 1x1 projection of xin in the same
    accumulators, the biases and the skip added after; and the emitted
    statistics of out, summed the same way."""
    xin = torch.cat([t["x"]] + ([t["x2"]] if "x2" in t else []), -1)
    b, hin, win, _ = xin.shape
    act0 = k7_act(xin, xin.sum(dim=(1, 2)), (xin * xin).sum(dim=(1, 2)), t["g0"], t["b0"],
                  groups[0], hin * win)
    if up:
        act0 = act0.repeat_interleave(2, 1).repeat_interleave(2, 2)
        xin = xin.repeat_interleave(2, 1).repeat_interleave(2, 2)
    h = conv_emulated(act0, t["w0"], None, None, mm, source=K7) + t["bias0"]
    sums1 = k7_reduce_partials(k7_tile_partials(h))
    sumsq1 = k7_reduce_partials(k7_tile_partials(h * h))
    act1 = k7_act(h, sums1, sumsq1, t["g1"], t["b1"], groups[1], h.shape[1] * h.shape[2])
    proj = "skip_w" in t
    out = conv_emulated(act1, t["w1"], xin if proj else None, t.get("skip_w"), mm,
                        source=K7) + t["bias1"]
    out = out + t["skip_b"] if proj else out + xin
    return [out, k7_reduce_partials(k7_tile_partials(out)),
            k7_reduce_partials(k7_tile_partials(out * out))]


# (B, H, W, C1, C2, O, up, proj), H and W the input's: the identity block,
# the decoder's dual input with a projection, the up block with a
# projection; no H or W a multiple of the 8 x 16 tile
K7_EMU_CASES = [(2, 12, 20, 32, 0, 32, False, False), (2, 10, 18, 16, 8, 24, False, True),
                (2, 5, 9, 16, 0, 24, True, True)]


@pytest.mark.parametrize("case", K7_EMU_CASES, ids=lambda c: "x".join(map(str, c)))
def test_3xtf32_k7_keeps_fp32_accuracy(case, record_property):
    """K7's two chained conv cores, emulated in the kernel's order and
    accumulation with norm1 folded from fixed-order partials between them,
    against the plain block in float64: output and emitted statistics
    within K7's 4e-5 of scale; one TF32 pass recorded."""
    from m_cedm_tpu_torch.kernels.fused_block import fused_unet_block_plain

    b, h, wd, c1, c2, o, up, proj = case
    c = c1 + c2
    rs = np.random.RandomState(sum(case[:6]))

    def rnd(*shape, sc=1.0, sh=0.0):
        return torch.from_numpy((rs.randn(*shape) * sc + sh).astype(np.float32))

    t = dict(x=rnd(b, h, wd, c1, sc=0.8, sh=0.3), g0=rnd(b, c, sc=0.3, sh=1.0),
             b0=rnd(b, c, sc=0.3), w0=rnd(3, 3, c, o, sc=1.0 / math.sqrt(9 * c)),
             bias0=rnd(o, sc=0.3), g1=rnd(b, o, sc=0.3, sh=1.0), b1=rnd(b, o, sc=0.3),
             w1=rnd(3, 3, o, o, sc=1.0 / math.sqrt(9 * o)), bias1=rnd(o, sc=0.3))
    if c2:
        t["x2"] = rnd(b, h, wd, c2, sc=0.8, sh=0.3)
    if proj:
        t["skip_w"], t["skip_b"] = rnd(c, o, sc=1.0 / math.sqrt(c)), rnd(o, sc=0.3)
    groups = (4, 4)
    args = [t[k].double() for k in ("x", "g0", "b0", "w0", "bias0", "g1", "b1", "w1",
                                    "bias1")]
    out, stats = fused_unet_block_plain(
        *args, *groups, 1e-5, emit_stats=True, up=up,
        **{k: t[k].double() for k in ("x2", "skip_w", "skip_b") if k in t})
    want = [out, *stats]
    errs = {name: max(rel_err(a, w) for a, w in zip(k7_emulated(t, groups, up, mm), want,
                                                    strict=True))
            for name, mm in (("3x", _mm_3x), ("1x", _mm_1x))}
    record_property("err_3xtf32", errs["3x"])
    record_property("err_1xtf32", errs["1x"])
    print(f"K7 {case} vs float64, of scale: 3xTF32 {errs['3x']:.2e}, "
          f"1xTF32 {errs['1x']:.2e}")
    assert errs["3x"] <= TOL_MEGA
