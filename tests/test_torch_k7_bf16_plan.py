"""The bf16 K7's TMA route (csrc/fused_block.cu::unet_block_bf16_tma_kernel)
on the CPU: its launch plan, route rule, tile walk and swizzled indices.

The plan is csrc/k7_plan.h, plain C++ that fused_block.cu plans every
launch with; the host's C++ compiler builds it here alone, and the tests
call its entries through ctypes at an H100's 132 SMs and one block an SM
(the TMA kernel's launch bounds). The flagship's launch kinds and the
ragged 128 + 128 -> 128 case get the plans one H100 reported
(`mc_unet_block_bf16_plan`), within one block's 232,448 bytes; every
layout puts the TMA destinations on 1024-byte boundaries. The tile walk
(block i: output block i % n_ob, a contiguous run of tiles) covers every
(sample, tile, 64-output block) once. The A stage's 128-byte swizzle (TMA
writes 16-byte chunk j of position p at j ^ (p & 7)) is emulated in numpy:
the activation's items visit each (position, chunk) once with the
un-swizzled channel's scale, the consumers' ldmatrix rows read the
channels they mean, and the epilogue's staging writes land where the TMA
store reads them.

A few seconds, no JAX, no CUDA.
"""
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from m_cedm_tpu_torch.kernels import fused_block as fb
from m_cedm_tpu_torch.kernels.attention_sources import k7_bf16_per_forward
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(fb.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "fused_block.cu").read_text()
H100_SMS = 132
H100_SMEM = 232448  # the dynamic shared memory one block may take on an H100
PLAN_KEYS = ("resident0", "resident1", "smem", "blocks_per_sm", "sms", "blocks", "tile_rows",
             "stages", "wgs", "stage_bytes", "ring_off", "stg_off", "rb_off", "vec_off",
             "red_off", "bar_off")


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/k7_plan.h built alone by the host's C++ compiler"""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    assert cxx, "building csrc/k7_plan.h needs a host C++ compiler"
    so = tmp_path_factory.mktemp("k7_plan") / "libk7plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wall", "-Wextra", "-shared", "-fPIC",
                    "-x", "c++", str(CSRC / "k7_plan.h"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.mc_unet_block_bf16_tma_plan.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.mc_unet_block_bf16_tma_shape.argtypes = [ctypes.c_int] * 4
    return lib


def tma_plan(lib, batch, h, w, c1, c2, o, up, proj, sms=H100_SMS, bps=1) -> dict:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    rc = lib.mc_unet_block_bf16_tma_plan(batch, h, w, c1, c2, o, int(up), int(proj), sms, bps,
                                         ctypes.cast(out, ctypes.c_void_p))
    assert rc == 0, f"no plan for {(batch, h, w, c1, c2, o, up, proj)}: {rc}"
    return dict(zip(PLAN_KEYS, out))


def tma_route(lib, c1, c2, o, proj) -> bool:
    return bool(lib.mc_unet_block_bf16_tma_shape(c1, c2, o, int(proj)))


def test_the_kernel_plans_with_the_header():
    for text in ('#include "k7_plan.h"', "k7plan::choose_t(up, batch, h, wd, c1, c2, o, proj,",
                 "k7plan::grid_t(batch, h, wd, pl)", "k7plan::tma_shape(c1, c2, o, proj) &&"):
        assert text in SOURCE, text


# the plans one H100 80GB HBM3 reported for the flagship's launch kinds (B =
# 16, ch 64) and the ragged case: (tile rows, stages, resident0, resident1,
# shared memory, blocks)
REPORTED = {
    "identity, res 128, chained stats, emit": (16, 2, True, True, 198400, 132),
    "identity, res 64, chained stats, emit": (16, 2, True, True, 198400, 132),
    "identity, res 32, chained stats, emit": (8, 4, True, True, 192256, 128),
    "dual + 1x1 projection (64 + 64 -> 64), res 128, chained stats, emit":
        (8, 2, True, True, 218880, 132),
    "dual + 1x1 projection (64 + 64 -> 64), res 64, chained stats, emit":
        (8, 2, True, True, 218880, 132),
    "dual + 1x1 projection (64 + 64 -> 64), res 32, chained stats, emit":
        (8, 2, True, True, 218880, 128),
    "up, identity (64x64 -> 128x128), chained stats, emit": (16, 2, True, True, 206592, 132),
    "up, identity (32x32 -> 64x64), chained stats, emit": (16, 2, True, True, 206592, 132),
}
SHAPES = {  # name -> (batch, h, w, c1, c2, o, up, proj) of the output
    "identity, res 128, chained stats, emit": (16, 128, 128, 64, 0, 64, False, False),
    "identity, res 64, chained stats, emit": (16, 64, 64, 64, 0, 64, False, False),
    "identity, res 32, chained stats, emit": (16, 32, 32, 64, 0, 64, False, False),
    "dual + 1x1 projection (64 + 64 -> 64), res 128, chained stats, emit":
        (16, 128, 128, 64, 64, 64, False, True),
    "dual + 1x1 projection (64 + 64 -> 64), res 64, chained stats, emit":
        (16, 64, 64, 64, 64, 64, False, True),
    "dual + 1x1 projection (64 + 64 -> 64), res 32, chained stats, emit":
        (16, 32, 32, 64, 64, 64, False, True),
    "up, identity (64x64 -> 128x128), chained stats, emit": (16, 128, 128, 64, 0, 64, True, False),
    "up, identity (32x32 -> 64x64), chained stats, emit": (16, 64, 64, 64, 0, 64, True, False),
}
RAGGED = (1, 7, 19, 128, 128, 128, False, True)


def test_flagship_launch_kinds_are_the_cases():
    per = k7_bf16_per_forward(128, 64)
    assert set(per) == set(SHAPES) and sum(per.values()) == 13


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_of_each_flagship_launch(plan_lib, name):
    shape = SHAPES[name]
    assert tma_route(plan_lib, *shape[3:6], shape[7])
    plan = tma_plan(plan_lib, *shape)
    got = (plan["tile_rows"], plan["stages"], bool(plan["resident0"]),
           bool(plan["resident1"]), plan["smem"], plan["blocks"])
    assert got == REPORTED[name]
    assert plan["smem"] <= H100_SMEM and plan["wgs"] == 2


def test_plan_of_the_ragged_case_streams_its_weights(plan_lib):
    plan = tma_plan(plan_lib, *RAGGED)
    assert (plan["tile_rows"], plan["stages"], plan["resident0"], plan["resident1"],
            plan["smem"], plan["blocks"]) == (8, 2, 0, 0, 218880, 4)
    # a stage: the halo'd 10 x 18 A tile padded to 1024 bytes, and a conv
    # chunk's weights (9 taps x 64 x 64 bf16)
    assert plan["stage_bytes"] == 23552 + 9 * 64 * 128


@pytest.mark.parametrize("shape", list(SHAPES.values()) + [
    RAGGED, (1, 6, 9, 8, 0, 24, True, True), (2, 10, 18, 16, 8, 40, False, True),
    (5, 17, 33, 128, 0, 128, False, True), (16, 64, 64, 128, 0, 128, True, False)])
def test_plan_layout_is_ordered_and_aligned(plan_lib, shape):
    """resident weights, the ring, the staging rows, the up block's
    residual, the vectors, the reduction and the barriers in order, without
    overlap; every TMA destination (the ring's A parts and streamed weights,
    the staging rows, the residual) on a 1024-byte boundary, as the 128-byte
    swizzle needs, after the 1024 bytes the plane is aligned within"""
    batch, h, w, c1, c2, o, up, proj = shape
    p = tma_plan(plan_lib, *shape)
    rows = p["tile_rows"]
    a_part = -(-(rows + 2) * 18 * 128 // 1024) * 1024
    ncx, nch = -(-c1 // 64) + -(-c2 // 64), -(-o // 64)
    w0 = ncx * 9 * 64 * 128
    w1 = nch * 9 * 64 * 128 + (ncx * 64 * 128 if proj else 0)
    resident = max(w0 if p["resident0"] else 0, w1 if p["resident1"] else 0)
    assert p["ring_off"] == resident
    streamed = not (p["resident0"] and p["resident1"])
    assert p["stage_bytes"] == a_part + (9 * 64 * 128 if streamed else 0)
    assert 2 <= p["stages"] <= 4
    assert p["stg_off"] == p["ring_off"] + p["stages"] * p["stage_bytes"]
    assert p["rb_off"] == p["stg_off"] + rows * 16 * 128
    assert p["vec_off"] - p["rb_off"] == (rows // 2 * 8 * 128 if up and not proj else 0)
    assert p["red_off"] == p["vec_off"] + (2 * 64 + 2 * 256) * 4
    assert p["bar_off"] == p["red_off"] + 2 * 4 * p["wgs"] * 64 * 4
    assert p["smem"] == p["bar_off"] + 256 + 1024 <= H100_SMEM
    for off in (p["ring_off"], p["stage_bytes"], a_part, p["stg_off"], p["rb_off"]):
        assert off % 1024 == 0
    assert p["bar_off"] % 8 == 0


@pytest.mark.parametrize("c1,c2,o,proj,want", [
    (64, 0, 64, False, True), (64, 64, 64, True, True), (128, 128, 128, True, True),
    (16, 8, 40, True, True), (8, 0, 8, False, True),
    (36, 0, 36, False, False),      # width 36: the kept cp.async route
    (64, 64, 70, True, False),      # O not a multiple of 8
    (32, 32, 64, False, False),     # an identity skip with two inputs
    (12, 0, 24, True, False)])
def test_route_rule(plan_lib, c1, c2, o, proj, want):
    assert tma_route(plan_lib, c1, c2, o, proj) is want


def test_every_width_the_wrapper_takes_fits(plan_lib):
    """C1, C2 and O multiples of 8 up to MAX_WIDTH (128), any projection and
    up: a plan within one block's shared memory"""
    widths = range(8, fb.MAX_WIDTH + 1, 8)
    for c1 in widths:
        for c2 in (0,) + tuple(widths):
            for o in widths:
                for up in ((False, True) if c2 == 0 else (False,)):
                    for proj in ((False, True) if c1 + c2 == o and c2 == 0 else (True,)):
                        plan = tma_plan(plan_lib, 16, 64, 64, c1, c2, o, up, proj)
                        assert plan["stages"] >= 2
                        assert plan["smem"] <= H100_SMEM


def _walk(plan, batch, h, w, o):
    """unet_block_bf16_tma_kernel's blocks: (block, sample, tile, o0) items"""
    rows, n_ob = plan["tile_rows"], -(-o // 64)
    n_tiles = -(-h // rows) * -(-w // 16)
    ntiles, nb = batch * n_tiles, plan["blocks"] // n_ob
    items = []
    for blk in range(plan["blocks"]):
        rank, o0 = blk // n_ob, (blk % n_ob) * 64
        t0, t1 = rank * ntiles // nb, (rank + 1) * ntiles // nb
        assert t1 > t0, "an empty block"
        items += [(blk, t // n_tiles, t % n_tiles, o0) for t in range(t0, t1)]
    return items, n_tiles, n_ob


@pytest.mark.parametrize("shape", list(SHAPES.values()) + [
    RAGGED, (3, 3, 5, 8, 0, 8, False, False),
    (2, 10, 18, 16, 8, 40, False, True), (80, 32, 32, 64, 64, 64, False, True),
    (1, 6, 9, 8, 0, 24, True, True), (5, 17, 33, 128, 0, 128, False, True)])
def test_tile_walk_covers_every_item_once(plan_lib, shape):
    batch, h, w, c1, c2, o, up, proj = shape
    plan = tma_plan(plan_lib, *shape)
    assert plan["blocks"] <= H100_SMS
    assert plan["blocks"] % -(-o // 64) == 0
    items, n_tiles, n_ob = _walk(plan, batch, h, w, o)
    keys = [(b, t, o0) for _, b, t, o0 in items]
    assert len(keys) == len(set(keys)) == batch * n_tiles * n_ob


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert len(found) == 1, name
    return int(found[0])


def _swizzled(pos: int, chunk: int) -> int:
    """the byte of 16-byte chunk `chunk` of row `pos` in a 1024-byte aligned
    tile of 128-byte rows, as TMA's 128-byte swizzle places it"""
    return pos * 128 + ((chunk ^ (pos & 7)) << 4)


@pytest.mark.parametrize("km,lo", [(1, False), (2, False), (1, True), (2, True)])
def test_activation_items_take_their_channels_scale(km, lo):
    for text in ("for (int p0 = tid >> 3; p0 < kPos; p0 += kActItems * kStride)",
                 "constexpr int kStride = kActThreads / 8;", "const int pos = p0 + k * kStride;",
                 "A + pp * kPixRow + ((c ^ (pp & 7)) << 4)"):
        assert text in SOURCE, text
    threads, items = _constant("kActThreads"), _constant("kActItems")
    assert threads == 128
    stride = threads // 8
    cols = 10 if lo else 18
    npos = (4 * km + 2) * 10 if lo else (8 * km + 2) * 18
    rs = np.random.RandomState(km)
    raw = rs.randn(npos, 64).astype(np.float32)
    # the stage as TMA writes it: 16-byte chunk c of position p at c ^ (p & 7)
    stage = np.zeros(npos * 64, np.float32)
    for p in range(npos):
        for c in range(8):
            b = _swizzled(p, c) // 2
            stage[b:b + 8] = raw[p, 8 * c:8 * c + 8]
    scale, shift = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    y0, x0, sh, sw = -1, 5, 6 * km, 11  # some positions outside the image
    seen = np.zeros((npos, 8), int)
    for tid in range(threads):
        c = tid & 7
        passes = [p0 + k * stride for p0 in range(tid >> 3, npos, items * stride)
                  for k in range(items)]
        for p in (q for q in passes if q < npos):
            y, x = y0 + p // cols, x0 + p % cols
            b = _swizzled(p, c) // 2
            seen[p, (b // 8) % 8] += 1
            v = stage[b:b + 8]
            if y < 0 or y >= sh or x < 0 or x >= sw:
                stage[b:b + 8] = 0.0
            else:
                a = v * scale[8 * c:8 * c + 8] + shift[8 * c:8 * c + 8]
                stage[b:b + 8] = a / (1 + np.exp(-a))
    assert (seen == 1).all()
    want = raw * scale + shift
    want = want / (1 + np.exp(-want))
    inside = [(0 <= y0 + p // cols < sh and 0 <= x0 + p % cols < sw) for p in range(npos)]
    want[~np.array(inside)] = 0.0
    # the consumers' ldmatrix rows: lane pixel px, 8-channel half of k16 step
    # kk at chunk (2 kk + half) ^ (pos & 7)
    for p in range(npos):
        for kk in range(4):
            for half in range(2):
                b = (p * 128 + (((2 * kk + half) ^ (p & 7)) << 4)) // 2
                ch = 16 * kk + 8 * half
                np.testing.assert_allclose(stage[b:b + 8], want[p, ch:ch + 8], rtol=1e-6,
                                           atol=1e-7)


@pytest.mark.parametrize("rw", [4, 8])
def test_epilogue_staging_is_what_the_store_reads(rw):
    """The consumers' staging writes (row sp = (4 m + wi) * 16 + px, chunk j
    at j ^ (sp & 7), 4 bytes at 4 t4) land once each, where TMA's store of
    the (64, 16, rw) box reads channel 8 j + 2 t4 of pixel px of row sp // 16;
    the up block's low-res residual is read at (lr // 2, px // 2)."""
    assert ("*reinterpret_cast<uint32_t*>(S_w + sp * kPixRow + ((j ^ (sp & 7)) << 4) + 4 * t4)"
            in SOURCE)
    assert "const int rp = kUp ? (lr >> 1) * (kTW / 2) + (px >> 1) : sp;" in SOURCE
    staged = {}
    for wi in range(4):
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for m in range(rw // 4):
                lr = 4 * m + wi
                for j in range(8):
                    for h in range(2):
                        px = g + 8 * h
                        sp = lr * 16 + px
                        byte = sp * 128 + ((j ^ (sp & 7)) << 4) + 4 * t4
                        assert byte not in staged
                        staged[byte] = (lr, px, 8 * j + 2 * t4)
    assert len(staged) == rw * 16 * 32
    for byte, (lr, px, ch) in staged.items():
        row = lr * 16 + px
        assert byte == _swizzled(row, ch // 8) + 2 * (ch % 8)
