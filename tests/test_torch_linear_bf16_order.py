"""The bf16 K5 on TMA (csrc/linear_attention.cu::kv_dots_tma_kernel): its
order of summation emulated on the CPU, and the wrapper's route and split
rules as functions of the shape.

The kernel sums k_n^T v_n of one head-batch in a thread-block cluster of
`kv_cluster` ranks. Rank r takes tokens r * rows .. (`kv_cluster_rows`:
whole stages of kKvTmaRows tokens, so a rank may be empty), sums each
stage's bf16 products on the tensor cores (a bf16 x bf16 product is exact in
fp32) into a zeroed partial and adds it to its fp32 accumulator; then the
ranks' accumulators are summed in rank order over distributed shared
memory. `kv_emulated` does that in float32, a stage's sum as one float32
matmul (the tensor core sums a stage's 64 terms in its own order: only the
rounding of that sum differs), with the constants read from the source. It
is held to float64 and to the Pallas `_kv_pallas` in interpret mode (at
N a multiple of its 2,048-row tile) within TOL_KERNEL, 2e-5 of scale, the
bound chip_smoke.py holds the kernel to. The bf16 operands are rounded
from normal draws made with numpy, the same for every side.

About 6 s in one process, most of it JAX's import and the Pallas
interpretation.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu_torch.kernels import linear_attention as tla
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(tla.__file__).resolve().parent.parent / "csrc" / "linear_attention.cu"
TOL_KERNEL = 2e-5  # chip_smoke.py's K5 tolerance, of scale
# clusters of 1 .. 8 blocks of kv_dots_tma_kernel that one H100 80GB HBM3
# holds at once, as cudaOccupancyMaxActiveClusters reports them
# (mc_kv_dots_bf16_tma_clusters; kernels/attention_sources.py --kernel k5bf16)
H100_ACTIVE = (132, 66, 39, 30, 22, 17, 15, 15)


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def kv_emulated(k: torch.Tensor, v: torch.Tensor, ranks: int) -> torch.Tensor:
    """kv_dots_tma_kernel's sums for one head-batch, k (N, D) and v (N, E)
    float32 holding bf16 values: each rank's stages summed (zero past N)
    into its fp32 accumulator, then the ranks' accumulators added in rank
    order."""
    stage = _constant("kKvTmaRows")
    n = k.shape[0]
    rows = tla.kv_cluster_rows(n, ranks)
    parts = []
    for r in range(ranks):
        acc = torch.zeros(k.shape[1], v.shape[1])
        for c0 in range(r * rows, min(n, (r + 1) * rows), stage):
            c1 = min(n, c0 + stage)
            acc = acc + k[c0:c1].T @ v[c0:c1]
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def bf16_draws(seed: int, *shape) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).bfloat16().float()


def scaled_err(got, want) -> float:
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    return float((got.double() - want).abs().max() / want.abs().max())


def test_rule_constants_are_the_sources():
    assert tla.KV_STAGE_ROWS == _constant("kKvTmaRows")
    assert tla.KV_CLUSTER_MAX == _constant("kKvTmaCluster")
    assert tla.KV_MIN_ROWS == _constant("kKvTmaMinRows")
    assert tla.KV_CLUSTER_MAX <= 8  # the portable cluster size


@pytest.mark.parametrize("d, e, tma", [(128, 128, True), (40, 40, True), (128, 8, True),
                                       (64, 128, True), (12, 20, False), (7, 128, False),
                                       (128, 1, False), (120, 100, False)])
def test_route_by_shape(d, e, tma):
    """TMA takes rows of whole 16-byte units: bf16 widths that are multiples
    of 8; every other width takes the bf16 mma.sync kernels."""
    assert tla.tma_route(d, e) is tma


# (BH, N) -> the cluster on an H100: 4 at BH 16 (16 clusters of 8 would
# need two waves, the card holding 15), 2 at BH 64 (66 clusters of 2), 1
# above 66 head-batches or below 512 tokens, a smaller cluster where
# KV_MIN_ROWS tokens a block run out
CLUSTER_CASES = [((16, 16384), 4), ((64, 16384), 2), ((16, 8192), 4), ((64, 8192), 2),
                 ((3, 1037), 4), ((20, 4096), 4), ((40, 4096), 2), ((70, 300), 1),
                 ((200, 16384), 1), ((1, 100), 1), ((1, 2048), 8), ((2, 2500), 8),
                 ((15, 4096), 8), ((8, 600), 2)]


@pytest.mark.parametrize("case, want", CLUSTER_CASES, ids=lambda c: str(c))
def test_cluster_rule_on_an_h100(case, want):
    assert tla.kv_cluster(*case, H100_ACTIVE) == want


def test_cluster_rule_is_the_largest_power_of_two_in_one_wave():
    """Over BH 1..300 and N 1..20,000: a power of two up to the portable
    size, every cluster co-resident and KV_MIN_ROWS tokens a block (or 1),
    and twice as many ranks would break one of the two."""
    for bh in range(1, 301):
        for n in (1, 255, 256, 511, 512, 1000, 1037, 2048, 4096, 8192, 16384, 20000):
            c = tla.kv_cluster(bh, n, H100_ACTIVE)
            assert c in (1, 2, 4, 8)
            if c > 1:
                assert bh <= H100_ACTIVE[c - 1] and c * tla.KV_MIN_ROWS <= n
            if 2 * c <= tla.KV_CLUSTER_MAX:
                assert bh > H100_ACTIVE[2 * c - 1] or 2 * c * tla.KV_MIN_ROWS > n


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1037, 2049, 8192, 16384, 16389])
def test_cluster_ranks_cover_every_token_once(n):
    stage = _constant("kKvTmaRows")
    for ranks in range(1, tla.KV_CLUSTER_MAX + 1):
        rows = tla.kv_cluster_rows(n, ranks)
        assert rows % stage == 0 and ranks * rows >= n
        taken = np.zeros(n, int)
        for r in range(ranks):
            taken[r * rows:min(n, (r + 1) * rows)] += 1
        assert (taken == 1).all()


@pytest.mark.parametrize("bh, n, want", [(16, 16384, 8), (64, 16384, 2), (200, 16384, 1),
                                         (4, 300, 3), (1, 100, 1)])
def test_workspace_split_rule(monkeypatch, bh, n, want):
    """The fp32 kv_dots and the bf16 one on mma.sync split N over about one
    block an SM (132 on an H100), at least 128 rows a block."""
    monkeypatch.setattr(tla, "_sm_count", lambda index: 132)
    assert tla._splits(bh, n, torch.device("cpu")) == want


# (N, D, E, ranks): ragged N (a last stage part filled), width 40, an empty
# last rank (2,049 tokens in 8 ranks of 320), the OFormer's width at N
# 16,384 in 4 ranks (BH 16), one rank
ORDER_CASES = [(1037, 40, 40, 4), (2049, 128, 128, 8), (16384, 128, 128, 4),
               (300, 128, 8, 1), (77, 128, 64, 1)]


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulated_order_holds_to_float64(case, record_property):
    n, d, e, ranks = case
    k, v = bf16_draws(n + d, n, d), bf16_draws(n + e + 1, n, e)
    err = scaled_err(kv_emulated(k, v, ranks), k.double().T @ v.double())
    record_property("err_vs_float64", err)
    assert err <= TOL_KERNEL


@pytest.fixture
def pallas_kv(monkeypatch):
    """The Pallas `_kv_pallas` in interpret mode (CPU)."""
    from jax.experimental import pallas as pl

    from m_cedm_tpu.pallas import linear_attention as la

    orig = pl.pallas_call
    monkeypatch.setattr(la.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    return la


@pytest.mark.parametrize("bh, n, ranks", [(2, 2048, 4), (1, 4096, 2)])
def test_emulated_order_holds_to_pallas(pallas_kv, bh, n, ranks, record_property):
    la = pallas_kv
    k, v = bf16_draws(5 + n, bh, n, 128), bf16_draws(6 + n, bh, n, 128)
    want = np.asarray(la._kv_pallas(jnp.asarray(k.numpy()).astype(jnp.bfloat16),
                                    jnp.asarray(v.numpy()).astype(jnp.bfloat16)))
    assert want.dtype == np.float32
    err = max(scaled_err(kv_emulated(k[b], v[b], ranks), want[b]) for b in range(bh))
    record_property("err_vs_pallas", err)
    assert err <= TOL_KERNEL
    # the plain version the CPU runs holds to both as well
    plain = tla.kv_dots_plain(k.bfloat16(), v.bfloat16())
    assert scaled_err(plain, want) <= TOL_KERNEL
    assert jax.default_backend() == "cpu"
