"""K1's bf16 forward passes as csrc/fused_norm.cu runs them, on the CPU (about
12 s in one process, most of it JAX's import).

The statistics pass is one cluster launch a sample that sums in a fixed
order; the apply a grid of about APPLY_BLOCKS_PER_SM blocks an SM whose
threads each own one channel chunk. Neither kernel runs here, so this file
holds what surrounds them:

- the Python mirror of both launch plans (`kernels/fused_norm.py`:
  `stats_plan`, `apply_plan`, with the source's constexprs) covers every row
  and channel once, with no block left without rows;
- a numpy emulation of the statistics pass's order (each thread over its
  rows in order, the warps' butterfly over their row slots, the warps in
  order, then the cluster's ranks in order), in fp32 on bf16 inputs, against
  the Pallas `_compute_stats` in interpret mode and float64: 1e-6 of scale
  (the squares of bf16 values are exact in fp32, so the kernel's fused
  multiply-add gives the same bits as this multiply and add);
- an fp32 emulation of the bf16 apply's SiLU (y / (1 + e^-y) by __expf, an
  ex2.approx of y log2(e), and __fdividef, a multiply by an approximate
  reciprocal) against `gn_silu_bf16_plain`: 1e-2 of scale at most and 1e-4
  on average, the bf16 tolerances.

On the card, tests/test_torch_cuda.py holds the kernels themselves (and the
mirror against the source's mc_channel_stats_plan / mc_gn_silu_plan).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_norm as jfn
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(__file__).resolve().parents[1] / "m_cedm_tpu_torch" / "csrc" / "fused_norm.cu"
N_CASES = (1, 7, 333, 1024, 4096, 16384, 100_003)
C_CASES = (4, 24, 64, 128, 320)


def _constant(name: str) -> int:
    """An integer constexpr of csrc/fused_norm.cu, as the kernels are built."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_plan_constants_are_the_sources():
    assert (tfn.STATS_THREADS, tfn.STATS_CLUSTER, tfn.STATS_MIN_ROWS, tfn.STATS_UNROLL) == (
        _constant("kStatsThreads"), _constant("kStatsCluster"), _constant("kStatsMinRows"),
        _constant("kStatsUnroll"))
    assert (tfn.APPLY_THREADS, tfn.APPLY_BLOCKS_PER_SM) == (
        _constant("kApplyThreads"), _constant("kApplyBlocksPerSm"))


def _thread_rows(row0, row_end, slot, slots, unroll):
    """The rows one thread of a block takes, in its loop's order: a step of
    `unroll` loads `slots` rows apart (the statistics pass; the apply takes
    one row a step), each row below row_end."""
    rows = []
    for r in range(row0 + slot, row_end, unroll * slots):
        rows += [r + u * slots for u in range(unroll) if r + u * slots < row_end]
    return rows


def _assert_covers(n, parts, threads_rows):
    """parts (row0, row_end) cut [0, n) in order, none empty; the threads'
    rows of each part cover it once."""
    assert parts[0][0] == 0 and parts[-1][1] == n
    assert all(e > s for s, e in parts)
    assert all(e == s2 for (_, e), (s2, _) in zip(parts, parts[1:]))
    for (s, e), rows in zip(parts, threads_rows):
        assert sorted(rows) == list(range(s, e))


def _assert_channels(c, vec, lanes):
    """Every vec-channel chunk of a row falls to one lane of one pass."""
    chunks = [l0 + lane for l0 in range(0, c // vec, lanes) for lane in range(lanes)
              if l0 + lane < c // vec]
    assert sorted(chunks) == list(range(c // vec))


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", C_CASES)
def test_plans_cover_every_row_once(c, itemsize):
    """Both forward plans, each N: the blocks of a sample cut its rows into
    contiguous runs, none empty, and their threads take every row once (the
    vector instance and, for the same C, the one-element one)."""
    for vec in sorted({tfn.fwd_vec(c, itemsize, True), 1}):
        for n in N_CASES:
            cl, lanes, slots = tfn.stats_plan(n, c, vec)
            assert 1 <= cl <= tfn.STATS_CLUSTER and cl & (cl - 1) == 0
            assert lanes * slots <= tfn.STATS_THREADS
            _assert_channels(c, vec, lanes)
            parts = [(tfn.part_begin(i, cl, n), tfn.part_begin(i + 1, cl, n))
                     for i in range(cl)]
            _assert_covers(n, parts, [
                [r for slot in range(slots)
                 for r in _thread_rows(s, e, slot, slots, tfn.STATS_UNROLL)]
                for s, e in parts])
            for b in (1, 16, 80):
                blocks, lanes, slots = tfn.apply_plan(b, n, c, vec, 132)
                assert 1 <= blocks <= min(-(-n // slots), -(-tfn.APPLY_BLOCKS_PER_SM * 132 // b))
                _assert_channels(c, vec, lanes)
                parts = [(tfn.part_begin(i, blocks, n), tfn.part_begin(i + 1, blocks, n))
                         for i in range(blocks)]
                _assert_covers(n, parts, [
                    [r for slot in range(slots)
                     for r in _thread_rows(s, e, slot, slots, 1)]
                    for s, e in parts])


def _bf16_values(rs, *shape, scale=0.8, shift=0.2):
    """A draw rounded to bf16, as float32."""
    a = torch.from_numpy((rs.randn(*shape) * scale + shift).astype(np.float32))
    return a.bfloat16().float().numpy()


def emulate_stats(x: np.ndarray):
    """channel_stats_kernel<8, bf16>'s sums and sums of squares of x (B, N,
    C; bf16 values as float32, C % 8 == 0), in its order, in fp32: the
    constants read from the source."""
    threads, cluster_max = _constant("kStatsThreads"), _constant("kStatsCluster")
    min_rows = _constant("kStatsMinRows")
    b, n, c = x.shape
    vec = 8
    cl = cluster_max
    while cl > 1 and cl * min_rows > n:
        cl //= 2
    lanes = min(c // vec, threads)
    slots = threads // lanes
    width = lanes * vec
    shuffle = lanes <= 32 and 32 % lanes == 0
    sums, sumsq = np.zeros((b, c), np.float32), np.zeros((b, c), np.float32)
    for l0 in range(0, c // vec, lanes):
        ch0, w = l0 * vec, min(width, c - l0 * vec)
        parts = []
        for rank in range(cl):
            row0, row_end = rank * n // cl, (rank + 1) * n // cl
            s = np.zeros((b, slots, w), np.float32)
            ss = np.zeros((b, slots, w), np.float32)
            for k in range(-(-(row_end - row0) // slots)):  # each thread's rows in order
                rows = row0 + np.arange(slots) + k * slots
                valid = (rows < row_end)[None, :, None]
                v = x[:, np.minimum(rows, n - 1), ch0:ch0 + w]
                s = np.where(valid, s + v, s)
                ss = np.where(valid, ss + v * v, ss)
            if shuffle:  # the butterfly over a warp's slots, then the warps
                per_warp = 32 // lanes
                s = s.reshape(b, slots // per_warp, per_warp, w)
                ss = ss.reshape(b, slots // per_warp, per_warp, w)
                while s.shape[2] > 1:
                    s = s[:, :, 0::2] + s[:, :, 1::2]
                    ss = ss[:, :, 0::2] + ss[:, :, 1::2]
                s, ss = s[:, :, 0], ss[:, :, 0]
            ts, tss = s[:, 0], ss[:, 0]
            for k in range(1, s.shape[1]):  # the sets in order
                ts, tss = ts + s[:, k], tss + ss[:, k]
            parts.append((ts, tss))
        ts, tss = parts[0]
        for q in range(1, cl):  # the cluster's ranks in order
            ts, tss = ts + parts[q][0], tss + parts[q][1]
        sums[:, ch0:ch0 + w], sumsq[:, ch0:ch0 + w] = ts, tss
    return sums, sumsq


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernels in interpret mode (CPU)."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    monkeypatch.setattr(jfn.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("shape,tile", [((2, 1024, 64), 512), ((2, 1024, 128), 512),
                                        ((2, 1001, 64), 143), ((2, 2601, 128), 867)],
                         ids=["1024x64", "1024x128", "ragged-1001x64", "ragged-2601x128"])
def test_stats_order_matches_pallas_and_float64(interpret, shape, tile):
    rs = np.random.RandomState(sum(shape))
    x = _bf16_values(rs, *shape)
    got = emulate_stats(x)
    want = [np.asarray(a) for a in jfn._compute_stats(jnp.asarray(x, jnp.bfloat16), tile)]
    x64 = x.astype(np.float64)
    exact = (x64.sum(axis=1), (x64 * x64).sum(axis=1))
    for g, w, e in zip(got, want, exact):
        scale = np.abs(e).max()
        assert np.abs(g - e).max() <= 1e-6 * scale
        assert np.abs(g - w.astype(np.float64)).max() <= 1e-6 * scale


LOG2E = np.float32(1.4426950408889634)


def silu_fast(y: torch.Tensor) -> torch.Tensor:
    """The bf16 apply's SiLU in fp32: __fdividef(y, 1 + __expf(-y)), __expf
    as 2^(fp32(-y * log2 e)) and __fdividef as y times fp32(1 / d)."""
    e = torch.exp2((-y) * torch.tensor(LOG2E))
    return y * (1.0 / (1.0 + e))


def gn_silu_fast(x, gamma, beta, num_groups, eps=1e-5):
    """gn_silu_apply_kernel<8, bf16> with chained statistics: a and b folded
    from the sums, y = x a + b in fp32, silu_fast, one rounding to bf16."""
    xf = x.float()
    sums, sumsq = tfn.channel_stats_plain(xf)
    mean, rstd = tfn.group_mean_rstd_from_sums(sums, sumsq, x.shape[1], num_groups, eps)
    a = gamma * rstd
    return silu_fast(xf * a[:, None] + (beta - a * mean)[:, None]).to(x.dtype)


@pytest.mark.parametrize("scale", [0.8, 8.0], ids=["unit", "wide"])
def test_fast_silu_within_the_bf16_tolerance(scale):
    """The fast SiLU against gn_silu_bf16_plain (torch.sigmoid), on inputs
    that put y well into both tails at the wide scale."""
    rs = np.random.RandomState(3)
    b, n, c = 2, 1024, 64
    x = torch.from_numpy(_bf16_values(rs, b, n, c, scale=scale)).bfloat16()
    gamma = torch.from_numpy((rs.randn(b, c) * 0.3 * scale + 1.0).astype(np.float32))
    beta = torch.from_numpy((rs.randn(b, c) * scale).astype(np.float32))
    got = gn_silu_fast(x, gamma, beta, 16).double()
    want = tfn.gn_silu_bf16_plain(x, gamma, beta, 16).double()
    err = (got - want).abs()
    s = float(want.abs().max())
    assert float(err.max()) <= 1e-2 * s and float(err.mean()) <= 1e-4 * s
    y = torch.tensor([-120.0, -88.0, -20.0, 0.0, 20.0, 100.0])
    assert torch.isfinite(silu_fast(y)).all()
