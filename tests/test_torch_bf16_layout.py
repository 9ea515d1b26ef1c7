"""The shared-memory layout of the bf16 K2/K3 kernel (gnsc_bf16_kernel in
m_cedm_tpu_torch/csrc/fused_norm_conv.cu, its layout and helpers in
csrc/bf16_conv_tiles.cuh), checked on the CPU from the sources' constants,
since no compiler or card is at hand here:

- every ldmatrix phase (8 lanes, one 16-byte row address each) of the A
  operand, at every tap of K2's halo'd tile, K3's low-resolution tile and
  the 1x1 projection's tile, and the kernel's other 16-byte and 4-byte
  passes over A and the staging rows, reach distinct 16-byte bank groups
  (a repeated address is a broadcast, not a conflict);
- the weight rows' XOR swizzle is wgmma's 128-byte swizzle (byte-offset
  bits 4-6 = the 16-byte chunk XOR bits 7-9), so the raw rows copied 16
  bytes at a time are the B operand as they lie, and their copies are
  conflict-free;
- the dynamic shared memory of each of the flagship's calls fits one block
  an SM (the occupancy the source states) within the H100's 227 KB a block
  and 228 KB an SM;
- the kernel library's cache name changes when the header changes.
"""
import re

import pytest

from m_cedm_tpu_torch.kernels import _build

CSRC = _build.CSRC
HEADER = (CSRC / "bf16_conv_tiles.cuh").read_text()
SOURCE = (CSRC / "fused_norm_conv.cu").read_text()
SM_BYTES = 228 * 1024      # shared memory an SM of the H100
BLOCK_RESERVED = 1024      # of it, reserved by the system for each block


def _constants() -> dict:
    """The integer constexprs of the header and the source, expressions
    evaluated in order (the header's names with and without `bf16t::`)."""
    env = {}
    for text in (HEADER, SOURCE):
        for decls in re.findall(r"^constexpr int ([^;(]+);", text, re.MULTILINE):
            for decl in decls.split(","):
                name, expr = (s.strip() for s in decl.split("=", 1))
                expr = expr.replace("bf16t::", "").replace("/", "//")   # C integer division
                env[name] = int(eval(expr, {"__builtins__": {}}, dict(env)))  # noqa: S307
    return env


C = _constants()


def test_constants_are_the_layout_the_kernel_is_written_for():
    assert C["kRowCh"] == C["kCH"] == 64            # one row: 64 channels, 4 k16 steps
    assert C["kARowBytes"] == 144 and C["kARowBytes"] % 16 == 0
    assert (C["kARowBytes"] // 16) % 2 == 1          # odd in 16-byte groups
    assert C["kWRowBytes"] == 128 and C["kWSwizzle"] == 7
    assert C["kTW"] == 16 and C["kConvWRows"] == 9 * 64
    assert C["kSmemCapH"] == 232448                  # 227 KB, the H100's per block
    # the helpers compute what this test computes
    assert "return pos * kARowBytes + (chunk << 4);" in HEADER
    assert "return row * kWRowBytes + ((chunk ^ (row & kWSwizzle)) << 4);" in HEADER
    assert "__host__ __device__ constexpr int warps_bf16(int th) { return th; }" in SOURCE


def a_byte(pos: int, chunk: int) -> int:
    return pos * C["kARowBytes"] + (chunk << 4)


def w_byte(row: int, chunk: int) -> int:
    return row * C["kWRowBytes"] + ((chunk ^ (row & C["kWSwizzle"])) << 4)


def _conflict_free(addrs) -> bool:
    """16-byte accesses of one phase: distinct addresses in distinct bank
    groups (an address repeated is a broadcast)."""
    distinct = set(addrs)
    return len({(a // 16) % 8 for a in distinct}) == len(distinct)


def _a_pos(kind: str, r: int, px: int, tap: int) -> int:
    """mma_chunk_bf16's A row: tile row r, pixel px, tap (dy, dx)."""
    tw = C["kTW"]
    dy, dx = divmod(tap, 3)
    if kind == "proj":
        return r * tw + px
    if kind == "up":
        return (((r + dy - 1) >> 1) + 1) * (tw // 2 + 2) + ((px + dx - 1) >> 1) + 1
    return (r + dy) * (tw + 2) + px + dx


@pytest.mark.parametrize("kind", ["conv", "up", "proj"])
@pytest.mark.parametrize("th", [16, 8])
def test_a_ldmatrix_phases_are_conflict_free(kind, th):
    taps = [4] if kind == "proj" else range(9)
    positions = (th // 2 + 2) * (C["kTW"] // 2 + 2) if kind == "up" else (th + 2) * (C["kTW"] + 2)
    for r in range(th):
        for tap in taps:
            for kk in range(4):
                for phase in range(4):          # the x4's four matrices
                    addrs = []
                    for ri in range(8):
                        lane = 8 * phase + ri
                        px = (lane & 7) + 8 * ((lane >> 3) & 1)
                        pos = _a_pos(kind, r, px, 0 if kind == "proj" else tap)
                        assert 0 <= pos < positions
                        addrs.append(a_byte(pos, 2 * kk + (lane >> 4)))
                    assert _conflict_free(addrs), (kind, th, r, tap, kk, phase)


@pytest.mark.parametrize("th", [16, 8])
def test_a_copy_activation_and_staging_passes_are_conflict_free(th):
    threads = 32 * th
    positions = (th + 2) * (C["kTW"] + 2)
    # the copies and the activation: thread t takes chunk t & 7 of position
    # t >> 3 (+ threads / 8 a round); a quarter warp is one 16-byte phase
    for base in range(0, threads, 8):
        for rnd in range(positions * 8 // threads + 1):
            addrs = [a_byte((t >> 3) + rnd * threads // 8, t & 7) for t in range(base, base + 8)]
            assert _conflict_free(addrs)
    # the epilogue's 4-byte residual reads and output writes into the warp's
    # staging rows: lane (g, t4) at pixel g + 8 h, outputs 8 j + 2 t4 (+ 1)
    for j in range(8):
        for h in range(2):
            banks = [(a_byte(g + 8 * h, 0) + 2 * (8 * j + 2 * t4)) // 4 % 32
                     for g in range(8) for t4 in range(4)]
            assert len(set(banks)) == 32
    # identity_up's low-res residual reads: pixel 8 + (px >> 1), a broadcast in pairs
    for j in range(8):
        addrs = {a_byte(8 + ((g + 8 * h) >> 1), 0) + 2 * (8 * j + 2 * t4)
                 for h in range(2) for g in range(8) for t4 in range(4)}
        assert len({a // 4 % 32 for a in addrs}) == len(addrs)


def test_weight_rows_are_wgmma_128_byte_swizzle_and_copy_conflict_free():
    rows = 2 * C["kConvWRows"] + 2 * 64                  # two conv chunks and two projection chunks
    for row in range(rows):
        offsets = [w_byte(row, k) for k in range(8)]
        assert sorted(offsets) == list(range(row * 128, row * 128 + 128, 16))
        for k, off in enumerate(offsets):
            # Swizzle<3, 4, 3>: bits 4-6 = chunk XOR bits 7-9 of the offset
            assert (off >> 4) & 7 == k ^ ((off >> 7) & 7)
        assert _conflict_free(offsets)                   # a quarter warp's copies of a row
    # a wgmma k16 step's B starts on a 1024-byte boundary (the descriptor's
    # base offset is 0): every tap, k16 step and chunk base
    for q_rows in (0, C["kConvWRows"], 2 * C["kConvWRows"] + 64):
        for tap in range(9):
            for kk in range(4):
                assert (w_byte(q_rows + tap * 64 + 16 * kk, 0)) % 1024 == 0
    # the 8 rows of one 8-channel group at one chunk: 8 bank groups
    for row0 in range(0, 64, 8):
        for k in range(8):
            assert _conflict_free([w_byte(row0 + i, k) for i in range(8)])


def _smem(up: bool, th: int, c: int, cr: int, act: bool, emit: bool, resident: bool) -> int:
    """layout_bf16 of the source: weights, two A stages, the staging rows,
    bias and skip bias and the folded scale and shift, the statistics'
    reduction, and 1024 bytes to start the plane on a 1024-byte boundary."""
    nc, nr = -(-c // 64), -(-cr // 64)
    w = (nc * C["kConvWRows"] + nr * 64 if resident else 2 * C["kConvWRows"]) * 128
    positions = (th // 2 + 2) * (C["kTW"] // 2 + 2) if up else (th + 2) * (C["kTW"] + 2)
    stage = positions * C["kARowBytes"]
    staging = th * C["kTW"] * C["kARowBytes"]
    s = 2 * 64 * 4 + ((2 * c * 4 + 15) // 16 * 16 if act else 0)
    red = 2 * th * 64 * 4 if emit else 0
    return w + 2 * stage + staging + s + red + 1024


def test_layout_formula_is_the_sources():
    for line in ("pl.stage_bytes = a_positions(up, th) * bf16t::kARowBytes;",
                 "pl.r_off = pl.a_off + 2 * pl.stage_bytes;",
                 "pl.s_off = pl.r_off + th * kTW * bf16t::kARowBytes;",
                 "pl.red_off = pl.s_off + 2 * kCH * 4 + (act ? (2 * c * 4 + 15) / 16 * 16 : 0);",
                 "pl.smem = pl.red_off + (emit ? 2 * warps_bf16(th) * kCH * 4 : 0) + 1024;"):
        assert line in SOURCE, line
    assert "__launch_bounds__(32 * warps_bf16(kTHt), 1)" in SOURCE


# the flagship's bf16 calls at B = 16 (chip_smoke.py phase 15.1), with the
# tile rows and residency plan_bf16 gives them: (up, th, C, Cr, act, emit)
FLAGSHIP = {
    "identity tail, res 128": (False, 16, 64, 0, True, True),
    "identity_up, res 128": (False, 16, 64, 0, True, True),
    "proj over the 128-channel concat, res 128": (False, 16, 64, 128, True, True),
    "128-channel decoder conv0, res 128": (False, 8, 128, 0, True, True),
    "linear down conv0, res 64": (False, 16, 64, 0, False, True),
    "identity tail, res 64": (False, 16, 64, 0, True, True),
    "identity tail, res 32": (False, 8, 64, 0, True, True),
    "K3 up conv0 to res 128": (True, 16, 64, 0, True, True),
}


@pytest.mark.parametrize("case", sorted(FLAGSHIP))
def test_flagship_calls_fit_one_block_an_sm(case):
    up, th, c, cr, act, emit = FLAGSHIP[case]
    smem = _smem(up, th, c, cr, act, emit, resident=True)
    assert smem <= C["kSmemCapH"], smem
    assert smem + BLOCK_RESERVED <= SM_BYTES
    # 32 * th threads; registers: one block an SM (launch bounds (.., 1))
    assert 32 * th * 128 <= 65536


def test_streamed_weights_fit_at_the_largest_input():
    # C = 512 (kMaxC) with a projection: the weights stream a chunk a step
    assert _smem(False, 8, 512, 512, True, True, resident=False) <= C["kSmemCapH"]
    assert _smem(False, 8, 512, 512, True, True, resident=True) > C["kSmemCapH"]


def test_library_name_changes_with_the_header(tmp_path, monkeypatch):
    for name in ("fused_norm_conv.cu", "bf16_conv_tiles.cuh", "fused_norm.cu", "tma_ring.cuh",
                 "k1_bwd_plan.h"):
        (tmp_path / name).write_bytes((CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("fused_norm_conv")
    other = _build._lib_path("fused_norm")
    header = tmp_path / "bf16_conv_tiles.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    assert _build._lib_path("fused_norm_conv") != before
    assert _build._lib_path("fused_norm") == other     # it includes tma_ring.cuh, k1_bwd_plan.h
    assert [p.name for p in _build._sources_of(tmp_path / "fused_norm_conv.cu")] == [
        "fused_norm_conv.cu", "bf16_conv_tiles.cuh"]
