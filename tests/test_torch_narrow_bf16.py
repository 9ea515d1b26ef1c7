"""The bf16 narrow convs as csrc/narrow_conv.cu runs them, on the CPU (a few
seconds in one process, most of it JAX's import and the interpret-mode
Pallas kernels).

conv_in (narrow_c_bf16_kernel) and the out conv (narrow_o_bf16_kernel) are
implicit GEMMs on bf16 mma.sync in persistent blocks that walk pixel tiles.
Neither kernel runs here, so this file holds what surrounds them:

- the Python mirror of their launch plan (`kernels/fused_norm_conv.py::
  narrow_bf16_plan`, its constants equal to the source's constexprs) gives
  every (image, tile) item to one block, leaves no block without an item,
  and its tiles cover every output pixel once, at H, W in {1, 13, 37, 128,
  129}, B 1 to 80 and O up to 512;
- the wrapper sizes the statistics scratch from the tile count of the
  kernel it launches (`mc_narrow_conv_tiles`, here its mirror);
- a numpy emulation of the kernels' arithmetic (bf16 operands; K tap-major
  and channel-minor, zero-padded to 16; each k16 step's exact products
  summed and rounded to fp32, the steps in the kernels' order; the fp32
  bias; the statistics from the fp32 values, per tile then over the tiles
  in order; one rounding to bf16) against the Pallas kernels in interpret
  mode: conv_in at C 4 against `fused_block_paired(act=False,
  emit_stats=True)` (which takes H a multiple of 8 and W of 16) and at C 2
  against `_pallas_gnsc(act=False, emit_stats=True)` at a ragged width, the
  out conv at O 1 and 2 against `_pallas_gnsc(act=False)` at ragged widths
  (the Pallas kernels take H a multiple of 8); conv_in's ragged heights and
  the odd-C pitch against `narrow_conv_plain`. Tolerances as tests/test_torch_bf16_kernels.py's:
  1e-2 of scale at most and 1e-4 on average, statistics 1e-5.

On the card, tests/test_torch_cuda.py holds the kernels themselves (and the
mirror against the source's mc_narrow_conv_plan).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(__file__).resolve().parents[1] / "m_cedm_tpu_torch" / "csrc" / "narrow_conv.cu"
TOL_MAX, TOL_MEAN, TOL_STATS = 1e-2, 1e-4, 1e-5
SIDES = (1, 13, 37, 128, 129)


def _constant(name: str) -> int:
    """An integer constexpr of csrc/narrow_conv.cu (alone or in a list)."""
    found = re.findall(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[,;]", SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_plan_constants_are_the_sources():
    assert tfnc.NARROW_O_TILE == (_constant("kBOTH"), _constant("kBOTW"))
    assert tfnc.NARROW_C_TILE == (_constant("kBCTH"), _constant("kBCTW"))
    assert tfnc.NARROW_C_OUT == _constant("kBCN")
    assert (tfnc.NARROW_O_BLOCKS_PER_SM, tfnc.NARROW_C_BLOCKS_PER_SM,
            tfnc.NARROW_C_BLOCKS_PER_SM_WIDE) == (
        _constant("kBOBlocksPerSm"), _constant("kBCBlocksPerSm"),
        _constant("kBCBlocksPerSmWide"))
    # a k16 step of the out conv is one tap's 16 channels; both rings run
    # at least two stages ahead of the products
    assert _constant("kBOKC") == 16
    assert _constant("kBOStages") >= 2 and _constant("kBCStages") >= 2
    # four warps a block: the out conv's 2 x 2 of 8 rows x 16 pixels, conv_in's
    # rows w and w + 4 of its tile, each row one m16 tile
    assert _constant("kBOThreads") == _constant("kBCThreads") == 128
    assert tfnc.NARROW_O_TILE == (16, 32) and tfnc.NARROW_C_TILE[1] == 16


def _assert_walk(b, h, w, c, o, sms):
    which, tiles, gx, gy = tfnc.narrow_bf16_plan(b, h, w, c, o, sms)
    assert which == (0 if o <= tfnc.NARROW else 1)
    th, tw = tfnc.NARROW_O_TILE if which == 0 else tfnc.NARROW_C_TILE
    assert gy == (1 if which == 0 else -(-o // tfnc.NARROW_C_OUT))
    items = b * tiles
    # block x takes items x, x + gx, ...: each item once, no block empty
    count = np.zeros(items, np.int64)
    per_block = np.zeros(gx, np.int64)
    for x in range(gx):
        mine = np.arange(x, items, gx)
        count[mine] += 1
        per_block[x] = mine.size
    assert (count == 1).all() and (per_block >= 1).all()
    # tile t covers rows (t // tiles_w) th .., columns (t % tiles_w) tw ..:
    # every pixel falls in exactly one tile and every tile holds a pixel
    tiles_w = -(-w // tw)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tile_of = (ys // th) * tiles_w + xs // tw
    assert tile_of.max() < tiles
    assert np.bincount(tile_of.ravel(), minlength=tiles).min() >= 1
    t0y, t0x = (tile_of // tiles_w) * th, (tile_of % tiles_w) * tw
    assert ((ys >= t0y) & (ys < t0y + th) & (xs >= t0x) & (xs < t0x + tw)).all()


@pytest.mark.parametrize("c,o", [(4, 64), (2, 64), (3, 70), (8, 320), (7, 512), (64, 2),
                                 (64, 1), (37, 5), (512, 8)])
def test_walk_covers_every_pixel_once(c, o):
    for h in SIDES:
        for w in SIDES:
            for b in (1, 3, 80):
                for sms in (132, 7):
                    _assert_walk(b, h, w, c, o, sms)


def test_statistics_scratch_is_the_kernels_tiles(monkeypatch):
    """The wrapper asks mc_narrow_conv_tiles for the tiles of the kernel it
    launches (0: narrow O; 3: the bf16 narrow C; 1: the fp32 narrow C) and
    sizes the (2, B, tiles, O) scratch from it: here both C entry points are
    stand-ins, the tiles the plan's mirror."""
    from m_cedm_tpu_torch.kernels import _build

    seen = {}

    def tiles_fn(h, w, which):
        th, tw = {0: tfnc.NARROW_O_TILE, 3: tfnc.NARROW_C_TILE, 1: (16, 8)}[which]
        seen["which"] = which
        return -(-h // th) * -(-w // tw)

    def conv_fn(*args):
        seen["args"] = args
        return 0

    def bind(lib, name, argtypes):
        return tiles_fn if name == "mc_narrow_conv_tiles" else conv_fn

    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(tfnc, "stream", lambda: 0)
    parts = []
    monkeypatch.setattr(tfnc, "ptr", lambda t: parts.append(t) or 0)
    for c, o, h, w in [(4, 64, 13, 37), (2, 64, 129, 128), (64, 2, 37, 13), (3, 70, 1, 129)]:
        x = torch.zeros(2, h, w, c, dtype=torch.bfloat16)
        wt = torch.zeros(3, 3, c, o, dtype=torch.bfloat16)
        parts.clear()
        tfnc._narrow_conv_kernel(x, wt, torch.zeros(o), True)
        which, tiles = tfnc.narrow_bf16_plan(2, h, w, c, o, 132)[:2]
        assert seen["which"] == (0 if which == 0 else 3)
        assert tuple(parts[5].shape) == (2, 2, tiles, o)  # x, w, bias, out, ostats, part


# --- the kernels' arithmetic -----------------------------------------------

def _f32(a):
    return np.asarray(a, np.float32)


def _padded(x):
    """x (B, H, W, C) with a zero halo of one pixel."""
    return np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))


def _step_sums(a, b):
    """Each k16 step's exact products summed and rounded to fp32: a (..., K),
    b (K, N) with K a multiple of 16; returns (steps, ..., N)."""
    k = a.shape[-1]
    return np.stack([_f32(a[..., s:s + 16].astype(np.float64) @ b[s:s + 16].astype(np.float64))
                     for s in range(0, k, 16)])


def _stats(out32, th, tw):
    """fp32 sums and sums of squares per tile, then over the tiles in order."""
    b, h, w, o = out32.shape
    s = np.zeros((b, o), np.float32)
    ss = np.zeros((b, o), np.float32)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            tile = out32[:, y0:y0 + th, x0:x0 + tw].reshape(b, -1, o)
            s = _f32(s + tile.sum(1, dtype=np.float32))
            ss = _f32(ss + (tile * tile).sum(1, dtype=np.float32))
    return s, ss


def conv_in_emulated(x, w, bias):
    """narrow_c_bf16_kernel: K = 9 taps x P (P = C rounded up to even),
    tap-major, zero-padded to 16; the k16 steps in order; + bias; statistics
    per 8 x 16 tile; one rounding."""
    b, h, wd, c = x.shape
    p = c + c % 2
    xp = _padded(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, p - c))))
    a = np.concatenate([xp[:, dy:dy + h, dx:dx + wd] for dy in range(3) for dx in range(3)], -1)
    wk = np.pad(w, ((0, 0), (0, 0), (0, p - c), (0, 0))).reshape(9 * p, -1)
    kpad = -(-9 * p // 16) * 16
    a = np.pad(a, ((0, 0),) * 3 + ((0, kpad - 9 * p),))
    wk = np.pad(wk, ((0, kpad - 9 * p), (0, 0)))
    acc = np.zeros((b, h, wd, w.shape[-1]), np.float32)
    for step in _step_sums(a, wk):
        acc = _f32(acc + step)
    out32 = _f32(acc + bias)
    return out32, _stats(out32, *tfnc.NARROW_C_TILE)


def out_conv_emulated(x, w, bias):
    """narrow_o_bf16_kernel at O <= 2: for each 16-channel chunk and column
    tap, one k16 step whose N holds the three row taps' outputs, summed per
    input row; an output row adds its three row taps' sums in order; +
    bias; one rounding."""
    b, h, wd, c = x.shape
    o = w.shape[-1]
    cp = -(-c // 16) * 16
    xp = _padded(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cp - c))))
    wp = np.pad(w, ((0, 0), (0, 0), (0, cp - c), (0, 0)))
    acc = np.zeros((3, b, h, wd, o), np.float32)  # per row tap dy, at the output pixel
    for kc in range(0, cp, 16):
        for dx in range(3):
            for dy in range(3):
                a = xp[:, dy:dy + h, dx:dx + wd, kc:kc + 16]
                acc[dy] = _f32(acc[dy] + _step_sums(a, wp[dy, dx, kc:kc + 16])[0])
    out32 = _f32(_f32(_f32(acc[0] + acc[1]) + acc[2]) + bias)
    return out32, _stats(out32, *tfnc.NARROW_O_TILE)


@pytest.fixture
def interpret(monkeypatch):
    """Force the Pallas kernels on and run them in interpret mode (CPU)."""
    pl = pytest.importorskip("jax.experimental.pallas")
    orig = pl.pallas_call
    wrapped = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(pl, "pallas_call", wrapped)
    monkeypatch.setattr(jfnc.pl, "pallas_call", wrapped, raising=False)
    monkeypatch.setattr(jfnc, "pallas_enabled", lambda: True)


def _bf16(rs, *shape, scale=1.0):
    a = (rs.randn(*shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _round(out32):
    return np.asarray(jnp.asarray(out32, jnp.bfloat16).astype(jnp.float32))


def _held(got, want, stats=False):
    got, want = np.asarray(got, np.float64), np.asarray(jnp.asarray(want).astype(jnp.float32),
                                                        np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want), float(np.abs(want).max())
    if stats:
        assert err.max() <= TOL_STATS * scale, err.max() / scale
    else:
        assert err.max() <= TOL_MAX * scale, err.max() / scale
        assert err.mean() <= TOL_MEAN * scale, err.mean() / scale


@pytest.mark.parametrize("c,h,w", [(4, 8, 16), (2, 8, 19)])
def test_conv_in_emulation_matches_pallas(interpret, c, h, w):
    """C 4 against the paired kernel the JAX U-Net runs (fused_block_paired),
    C 2 against the unpaired linear mode (_pallas_gnsc) at a ragged width."""
    rs = np.random.RandomState(40 + c)
    x = _bf16(rs, 1, h, w, c)
    wt = _bf16(rs, 3, 3, c, 64, scale=1.0 / np.sqrt(9 * c))
    bias = (0.3 * rs.randn(64)).astype(np.float32)
    xj, wj, bj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16), jnp.asarray(bias)
    if c == 4:
        outp, sums, sumsq = jfnc.fused_block_paired(jfnc.pair_array(xj), None, None, wj, bj, 1,
                                                    act=False, emit_stats=True)
        want = jfnc.unpair_array(outp)
    else:
        want, sums, sumsq = jfnc._pallas_gnsc(xj, None, None, wj, bj, 1, 1e-5, act=False,
                                              emit_stats=True)
    out32, (s, ss) = conv_in_emulated(x, wt, bias)
    _held(_round(out32), want)
    _held(s, sums, stats=True)
    _held(ss, sumsq, stats=True)


@pytest.mark.parametrize("o,h,w", [(2, 8, 19), (1, 16, 9)])
def test_out_conv_emulation_matches_pallas_linear_mode(interpret, o, h, w):
    rs = np.random.RandomState(50 + o)
    y = _bf16(rs, 1, h, w, 40)  # two 16-channel chunks and a padded one
    wt = _bf16(rs, 3, 3, 40, o, scale=1.0 / np.sqrt(9 * 40))
    bias = (0.3 * rs.randn(o)).astype(np.float32)
    want = jfnc._pallas_gnsc(jnp.asarray(y, jnp.bfloat16), None, None,
                             jnp.asarray(wt, jnp.bfloat16), jnp.asarray(bias), 1, 1e-5,
                             act=False)
    out32, (s, ss) = out_conv_emulated(y, wt, bias)
    _held(_round(out32), want)
    # the statistics it emits on request, per tile in order, against float64
    o64 = np.asarray(out32, np.float64)
    _held(s, o64.sum((1, 2)), stats=True)
    _held(ss, (o64 * o64).sum((1, 2)), stats=True)


@pytest.mark.parametrize("emulated,c,o,h,w", [(conv_in_emulated, 4, 64, 13, 37),
                                               (conv_in_emulated, 2, 64, 19, 22),
                                               (conv_in_emulated, 3, 8, 9, 17),
                                               (out_conv_emulated, 16, 2, 9, 17)])
def test_emulation_matches_the_plain_version(emulated, c, o, h, w):
    """Ragged shapes, the odd-C pitch and a single chunk: the emulation
    against narrow_conv_plain (fp32 sums of exact products, one rounding)."""
    rs = np.random.RandomState(60 + c)
    x = _bf16(rs, 1, h, w, c)
    wt = _bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c))
    bias = (0.3 * rs.randn(o)).astype(np.float32)
    want, (ws, wss) = tfnc.narrow_conv_plain(
        torch.tensor(x).to(torch.bfloat16), torch.tensor(wt).to(torch.bfloat16),
        torch.from_numpy(bias), emit_stats=True)
    out32, (s, ss) = emulated(x, wt, bias)
    _held(_round(out32), want.float().numpy())
    _held(s, ws.numpy(), stats=True)
    _held(ss, wss.numpy(), stats=True)
