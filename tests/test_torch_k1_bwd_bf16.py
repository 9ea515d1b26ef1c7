"""K1's bf16 backward (csrc/fused_norm.cu::gn_silu_bwd_cluster_kernel) on the
CPU: its launch plan and its order of summation (about 10 s in one process,
most of it JAX's import, the Pallas kernels in interpret mode and the
emulation's loops).

The plan is csrc/k1_bwd_plan.h, plain C++ that fused_norm.cu plans every
bf16 launch with; the host's C++ compiler builds it here alone and the tests
call it through ctypes at an H100's 132 SMs and the clusters of 1, 2, 4 and
8 blocks it holds at once (132, 66, 30, 15). At N from 1 to 100,003, C from
8 to 2048 and B 1 to 80, the blocks of a sample cover its rows once with no
block empty, a block's chunks cover its rows, shared memory stays within one
block's 232,448 bytes, no launch holds more clusters than the card does at
once, and where the batch needs more than one wave each group of blocks
takes its samples in a fixed order.

A numpy emulation of the kernel's arithmetic (fp32 on bf16 inputs): each
thread sums its rows in order (its group's chunks, then its rows of a
chunk), a butterfly over a warp's row slots (or the slots in order), the
partial sets in order, the cluster's ranks in rank order, the sample's
clusters in cluster order; dx from the folded constants with the kernel's
fused multiply-adds. It holds to float64 and to the Pallas _pallas_backward
in interpret mode: dgamma and dbeta within 1e-5 of scale, dx within the
bf16 tolerances of tests/test_torch_bf16_backward.py.
"""
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import m_cedm_tpu.pallas.fused_norm as jfn
from test_torch_bf16_kernels import f32, held, jb
from test_torch_bf16_kernels import interpret  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(__file__).resolve().parents[1] / "m_cedm_tpu_torch" / "csrc"
PLAN_H = (CSRC / "k1_bwd_plan.h").read_text()
H100_SMS, H100_ACTIVE = 132, (132, 66, 30, 15)  # clusters of 1, 2, 4, 8 at once
H100_SMEM = 232448
KEYS = ("cluster", "clusters", "blocks", "inflight", "grid", "waves", "rows", "chunk_rows",
        "chunks", "slots", "lanes", "row_slots", "sets", "slot_bytes", "smem", "xchg_words",
        "consumers")


def constant(name: str) -> int:
    """An integer constexpr of csrc/k1_bwd_plan.h."""
    m = re.search(rf"constexpr int {name} = (\d+);", PLAN_H)
    assert m, name
    return int(m.group(1))


NARROW, WIDE = constant("kNarrowConsumers"), constant("kWideConsumers")
GROUPS, VEC = constant("kGroups"), constant("kVec")


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/k1_bwd_plan.h built alone by the host's C++ compiler"""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    assert cxx, "building csrc/k1_bwd_plan.h needs a host C++ compiler"
    so = tmp_path_factory.mktemp("k1_bwd_plan") / "libk1bwdplan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wall", "-Wextra", "-shared", "-fPIC",
                    "-x", "c++", str(CSRC / "k1_bwd_plan.h"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.mc_gn_silu_bwd_bf16_plan_for.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return lib


def plan(lib, b, n, c, groups, sms=H100_SMS, active=H100_ACTIVE) -> dict:
    act = (ctypes.c_int * 4)(*active)
    out = (ctypes.c_longlong * len(KEYS))()
    rc = lib.mc_gn_silu_bwd_bf16_plan_for(b, n, c, groups, sms, act, out)
    assert rc == 0, (b, n, c, groups)
    return dict(zip(KEYS, out))


def part_begin(i, parts, n):
    return i * n // parts


def test_the_kernel_plans_with_the_header():
    src = (CSRC / "fused_norm.cu").read_text()
    for text in ('#include "k1_bwd_plan.h"', "k1bwd::plan(b, n, c, groups, sms, active, pl)",
                 "gn_silu_bwd_cluster_kernel(const ClusterArgs p)"):
        assert text in src, text


@pytest.mark.parametrize("c", [8, 24, 64, 128, 2048])
@pytest.mark.parametrize("n", [1, 7, 333, 4096, 16384, 100003])
def test_plan_covers_rows_and_fits_the_card(plan_lib, n, c):
    for b in (1, 16, 32, 80):
        p = plan(plan_lib, b, n, c, 8 if c % 8 == 0 else 1)
        assert p["blocks"] == p["cluster"] * p["clusters"] and p["blocks"] <= n
        assert p["grid"] == p["inflight"] * p["blocks"] and p["grid"] <= H100_SMS
        # no more clusters at once than the card holds
        assert p["grid"] // p["cluster"] <= H100_ACTIVE[p["cluster"].bit_length() - 1]
        assert p["smem"] <= H100_SMEM and 1 <= p["slots"] <= p["chunks"]
        # where the ring turns over, a slot's consecutive fills are chunks of
        # one group, and a group holds one slot past its chunk in pass B:
        # the slots a multiple of the groups, two a group at least
        assert p["slots"] == p["chunks"] or (p["slots"] % GROUPS == 0
                                             and p["slots"] >= 2 * GROUPS)
        assert p["slot_bytes"] == 4 * p["chunk_rows"] * c
        # a group's threads hold a whole row, 8 channels a thread: the fewer
        # compute threads where they do
        assert p["consumers"] == (NARROW if c // VEC <= NARROW // GROUPS else WIDE)
        assert p["lanes"] == c // VEC
        assert 1 <= p["row_slots"] == p["consumers"] // GROUPS // p["lanes"]
        # the blocks of a sample: every row once, none empty, each within the
        # plan's rows, its chunks covering it
        begins = [part_begin(j, p["blocks"], n) for j in range(p["blocks"] + 1)]
        assert begins[0] == 0 and begins[-1] == n
        rows = np.diff(begins)
        assert rows.min() >= 1 and rows.max() <= p["rows"]
        assert p["chunks"] * p["chunk_rows"] >= p["rows"] > (p["chunks"] - 1) * p["chunk_rows"]
        # the samples: group i takes i, i + inflight, ... in order, each once
        taken = [s for i in range(p["inflight"]) for s in range(i, b, p["inflight"])]
        assert sorted(taken) == list(range(b))
        assert p["waves"] == -(-b // p["inflight"])
        assert p["xchg_words"] == (b * p["clusters"] * 2 * c if p["clusters"] > 1 else 0)


def test_train_step_plans_fill_the_card_in_one_wave(plan_lib):
    """res 128 and 64 at B 16 (and the CLI's batch 32): eight blocks a
    sample, clusters of 2 (15 clusters of 8 or 30 of 4 would need two
    waves), 128 blocks in one wave."""
    for b, n in ((16, 16384), (16, 4096), (32, 16384)):
        p = plan(plan_lib, b, n, 64, 16)
        assert (p["cluster"], p["grid"], p["waves"]) == (2, 128, 1)
        assert p["blocks"] == (8 if b == 16 else 4)


def test_plan_refuses_what_the_kernel_does_not_take(plan_lib):
    out = (ctypes.c_longlong * len(KEYS))()
    act = (ctypes.c_int * 4)(*H100_ACTIVE)
    for b, n, c, g in ((1, 10, 12, 4), (1, 10, 4096, 32), (1, 10, 64, 7), (0, 10, 64, 4)):
        assert plan_lib.mc_gn_silu_bwd_bf16_plan_for(b, n, c, g, H100_SMS, act, out) == -1


# --- the order of summation --------------------------------------------------

def _fma(a, b, c):
    """fp32 fused multiply-add (the product exact in float64, one rounding)"""
    return (np.float64(a) * b + c).astype(np.float32) if np.isscalar(a) else (
        a.astype(np.float64) * b + c).astype(np.float32)


def _dy(g, y):
    """g silu'(y) as the kernel forms it: e = 2^(-y log2 e), sig = 1 / (1 + e)"""
    e = np.exp2((y * np.float32(-1.4426950408889634)).astype(np.float32)).astype(np.float32)
    sig = (np.float32(1) / (np.float32(1) + e)).astype(np.float32)
    return (g * sig * (np.float32(1) + y * (np.float32(1) - sig))).astype(np.float32)


def emulate(p, x, g, gamma, beta, sums, sumsq, groups, eps):
    """The kernel's dx, dgamma, dbeta for plan p, in its order (fp32)."""
    b, n, c = x.shape
    per, lanes, rs, cr = c // groups, p["lanes"], p["row_slots"], p["chunk_rows"]
    gt = p["consumers"] // GROUPS
    shuffle = lanes <= 32 and 32 % lanes == 0
    inv_cnt = np.float32(1) / np.float32(n * per)
    dx = np.zeros((b, n, c), np.float32)
    dgamma = np.zeros((b, c), np.float32)
    dbeta = np.zeros((b, c), np.float32)
    for s in range(b):
        ms = np.zeros(groups, np.float32)
        rstd_g = np.zeros(groups, np.float32)
        for k in range(groups):
            s1 = ss = np.float32(0)
            for i in range(per):
                s1 = np.float32(s1 + sums[s, k * per + i])
                ss = np.float32(ss + sumsq[s, k * per + i])
            ms[k] = np.float32(s1 * inv_cnt)
            rstd_g[k] = np.float32(1) / np.sqrt(np.float32(max(np.float32(ss * inv_cnt - ms[k] * ms[k]),
                                                                np.float32(0)) + np.float32(eps)))
        ch = np.arange(c)
        rstd = rstd_g[ch // per]
        nmr = (-ms[ch // per] * rstd).astype(np.float32)
        xhat = _fma(x[s], rstd, nmr)
        dy = _dy(g[s], (xhat * gamma[s] + beta[s]).astype(np.float32))
        parts = []
        for j in range(p["blocks"]):
            r0, r1 = part_begin(j, p["blocks"], n), part_begin(j + 1, p["blocks"], n)
            # each thread's sums over its rows in order: (group, slot, lane)
            acc_g = np.zeros((GROUPS, rs, lanes, VEC), np.float32)
            acc_b = np.zeros_like(acc_g)
            for q in range(-(-(r1 - r0) // cr)):
                gi = q % GROUPS
                for r in range(q * cr, min((q + 1) * cr, r1 - r0)):
                    sl = (r - q * cr) % rs
                    t = (dy[r0 + r] * xhat[r0 + r]).astype(np.float32).reshape(lanes, VEC)
                    acc_g[gi, sl] = (acc_g[gi, sl] + t).astype(np.float32)
                    acc_b[gi, sl] = (acc_b[gi, sl] + dy[r0 + r].reshape(lanes, VEC)).astype(
                        np.float32)
            red = []
            for acc in (acc_g, acc_b):
                if shuffle:  # a warp: 32 / lanes slots; butterfly over them, then warps
                    w = acc.reshape(GROUPS, gt // 32, 32 // lanes, lanes, VEC).copy()
                    m = lanes
                    while m < 32:
                        idx = np.arange(32 // lanes) ^ (m // lanes)
                        w = (w + w[:, :, idx]).astype(np.float32)
                        m *= 2
                    sets = w[:, :, 0].reshape(-1, c)
                else:
                    sets = acc.reshape(-1, c)
                tot = sets[0].copy()
                for k in range(1, len(sets)):
                    tot = (tot + sets[k]).astype(np.float32)
                red.append(tot)
            parts.append(np.concatenate(red))
        # the cluster's ranks in rank order, then the clusters in order
        clus = []
        for kc in range(p["clusters"]):
            t = parts[kc * p["cluster"]].copy()
            for q in range(1, p["cluster"]):
                t = (t + parts[kc * p["cluster"] + q]).astype(np.float32)
            clus.append(t)
        tot = clus[0].copy()
        for t in clus[1:]:
            tot = (tot + t).astype(np.float32)
        dgamma[s], dbeta[s] = tot[:c], tot[c:]
        m1, m2 = np.zeros(groups, np.float32), np.zeros(groups, np.float32)
        for k in range(groups):
            s1 = s2 = np.float32(0)
            for i in range(per):
                s1 = np.float32(s1 + gamma[s, k * per + i] * tot[c + k * per + i])
                s2 = np.float32(s2 + gamma[s, k * per + i] * tot[k * per + i])
            m1[k], m2[k] = np.float32(s1 / np.float32(n * per)), np.float32(s2 / np.float32(n * per))
        p1 = (rstd * gamma[s]).astype(np.float32)
        p2 = (-rstd * m2[ch // per]).astype(np.float32)
        p3 = (-rstd * m1[ch // per]).astype(np.float32)
        dx[s] = _fma(dy, p1, _fma(xhat, p2, p3))
    return dx, dgamma, dbeta


def float64_reference(x, g, gamma, beta, sums, sumsq, groups, eps):
    b, n, c = x.shape
    per = c // groups
    cnt = n * per
    s = sums.astype(np.float64).reshape(b, groups, per).sum(-1) / cnt
    v = np.maximum(sumsq.astype(np.float64).reshape(b, groups, per).sum(-1) / cnt - s * s, 0)
    mean, rstd = np.repeat(s, per, -1), np.repeat(1 / np.sqrt(v + eps), per, -1)
    xhat = (x - mean[:, None]) * rstd[:, None]
    y = xhat * gamma[:, None] + beta[:, None]
    sig = 1 / (1 + np.exp(-y))
    dy = g * sig * (1 + y * (1 - sig))
    return (dy * xhat).sum(1), dy.sum(1)


# (B, N, C, groups, eps): a sample over 8 clusters of 8 (one wave at B 1);
# a ragged N over one cluster of 4 with C 24 (three lanes a row: no
# butterfly, the slots in order); the DDPM U-Net's 32 groups at eps 1e-6
CASES = ((1, 4096, 64, 16, 1e-5), (2, 333, 24, 3, 1e-5), (2, 700, 64, 32, 1e-6))


@pytest.mark.parametrize("case", CASES, ids=lambda v: "x".join(map(str, v[:4])))
def test_summation_order_matches_pallas_and_float64(plan_lib, interpret, monkeypatch, case):
    monkeypatch.setenv("MCEDM_PAIR", "0")
    b, n, c, groups, eps = case
    rs = np.random.RandomState(n + c)
    bf = lambda *s, scale=1.0, shift=0.0: f32(jb((rs.randn(*s) * scale + shift).astype(np.float32)))
    x, g = bf(b, n, c, scale=0.8, shift=0.2), bf(b, n, c)
    gamma = (1.0 + 0.3 * rs.randn(b, c)).astype(np.float32)
    beta = (0.3 * rs.randn(b, c)).astype(np.float32)
    sums = x.astype(np.float64).sum(1).astype(np.float32)
    sumsq = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    p = plan(plan_lib, b, n, c, groups)
    if case == CASES[0]:
        assert (p["cluster"], p["clusters"]) == (8, 8)
    dx, dgamma, dbeta = emulate(p, x, g, gamma, beta, sums, sumsq, groups, eps)
    want = jfn._pallas_backward(jb(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(sums),
                                jnp.asarray(sumsq), jb(g), groups, eps, tile=n)
    dg64, db64 = float64_reference(x.astype(np.float64), g.astype(np.float64), gamma, beta,
                                   sums, sumsq, groups, eps)
    for got, pal, ref in ((dgamma, want[1], dg64), (dbeta, want[2], db64)):
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 1e-5 * scale
        assert float(np.abs(got - f32(pal)).max()) <= 1e-5 * scale
    # dx rounded once to bf16, as the kernel stores it
    held(f32(jb(dx)), want[0])
