"""conv_in's bf16 weight gradient on wgmma
(csrc/fused_norm_conv_bwd.cu::wgrad_narrow_bf16_kernel) on the CPU: the
im2col tile it builds and the order of its sums (about 9 s in one process,
most of it JAX's import and the Pallas kernel in interpret mode).

The kernel's A operand is the im2col of an 8 x 16 pixel tile, one 128-byte
row of 64 bf16 values a pixel (rows m = tap C + c, the row 9 C ones where
there is a bias, zero past them), its 16-byte chunk j at j ^ (pixel & 7):
wgmma's 128-byte swizzle, read MN-major. A numpy emulation of the index map
as the kernel writes it (32-bit pairs of a position's channels for even C,
16-bit values for odd C) and as wgmma reads it back visits each (tap,
channel, pixel) of an image once, the halo zero outside it. The emulated
tile walk (persistent blocks over contiguous runs of tiles, one fp32
partial a block, summed by colsum_kernel's fixed order) holds dW and dbias
to the Pallas _bwd_phase_a(act=False) in interpret mode and to float64
within 1e-5 of scale (tests/test_torch_narrow_conv.py's gradient
tolerance), at the flagship's C 4 -> 64 and adm_edm_cond_h's C 2 -> 64 and
at ragged tiles.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from test_torch_bf16_kernels import f32, jb
from test_torch_bf16_kernels import interpret  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = (Path(__file__).resolve().parents[1] / "m_cedm_tpu_torch" / "csrc" /
          "fused_norm_conv_bwd.cu").read_text()
H100_SMS = 132


def constant(name: str) -> int:
    """An integer constexpr of csrc/fused_norm_conv_bwd.cu."""
    m = re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[;,]", SOURCE)
    assert m, name
    return int(m.group(1))


TH, TW, SUM_GROUPS = constant("kNbTH"), constant("kNbTW"), constant("kSumGroups")
PIX, HALO_W = TH * TW, TW + 2


def tiles_of(b, h, w):
    """(image, first row, first column) of each tile, in the kernel's order"""
    tx = -(-w // TW)
    per = -(-h // TH) * tx
    return [(t // per, (t % per) // tx * TH, (t % per) % tx * TW) for t in range(b * per)]


def a_tile(xpad, img, y0, x0, c, bias):
    """The A tile as the im2col warpgroup writes it: (panels, 128 rows, 8
    stored chunks, 8 values) in the swizzled layout, from the zero-padded
    image xpad (B, H + 2 + 8, W + 2 + 16, C); values are labels (any
    array)."""
    panels = -(-(9 * c + 1) // 64)
    out = np.zeros((panels, PIX, 8, 8), xpad.dtype)  # panel, row, stored chunk, value
    for r in range(PIX):
        ty, tx = divmod(r, TW)
        halo = xpad[img, y0 + ty:y0 + ty + 3, x0 + tx:x0 + tx + 3]  # (3, 3, C) around the pixel
        v = halo.reshape(9, c)
        for m0 in range(0, 64 * panels, 8):
            vals = []
            for m in range(m0, m0 + 8):
                # even C: pairs (m, m + 1) are word c / 2 of tap m / C (as the
                # kernel's 32-bit gather); odd C: one value each
                vals.append(v[m // c, m % c] if m < 9 * c else (1 if m == 9 * c and bias else 0))
            j = (m0 % 64) // 8
            out[m0 // 64, r, j ^ (r & 7)] = vals
    return out


def read_mn_major(tile):
    """wgmma's view of an MN-major 128-byte-swizzled operand: element (k =
    pixel r, m) at stored chunk (m / 8) ^ (r & 7), value m % 8"""
    r = np.arange(PIX)[:, None]
    m = np.arange(64)[None, :]
    return np.concatenate([t[r, (m // 8) ^ (r & 7), m % 8] for t in tile], axis=1)


@pytest.mark.parametrize("c", [2, 3, 4, 8])
def test_im2col_visits_each_tap_channel_and_pixel_once(c):
    b, h, w, bias = 2, 13, 21, True
    # labels: 1 + index of (image, row, column, channel); 0 is the halo
    xpad = np.zeros((b, h + 2 + TH, w + 2 + TW, c), np.int64)
    xpad[:, 1:h + 1, 1:w + 1] = 1 + np.arange(b * h * w * c).reshape(b, h, w, c)
    seen = np.zeros((b, h, w, 9, c), np.int64)
    for img, y0, x0 in tiles_of(b, h, w):
        a = read_mn_major(a_tile(xpad, img, y0, x0, c, bias))
        for r in range(PIX):
            y, x = y0 + r // TW, x0 + r % TW
            if y >= h or x >= w:
                continue  # the kernel zeroes the row, and TMA zero-fills g's
            for m in range(a.shape[1]):
                tap, ch = divmod(m, c)
                if m < 9 * c:
                    yy, xx = y + tap // 3 - 1, x + tap % 3 - 1
                    inside = 0 <= yy < h and 0 <= xx < w
                    want = 1 + ((img * h + yy) * w + xx) * c + ch if inside else 0
                    assert a[r, m] == want, (img, y, x, tap, ch)
                    seen[img, y, x, tap, ch] += 1
                else:
                    assert a[r, m] == (1 if m == 9 * c and bias else 0)
    assert (seen == 1).all()


def emulate(x, g, bias=True):
    """dW (3, 3, C, O) and dbias as the kernel and its reduce sum them: block
    i of `rows` takes tiles i T / rows ..; per tile D = A^T B in fp32, added
    to its accumulator; colsum_kernel adds the blocks' partials by
    SUM_GROUPS strided groups in order, then the groups in order."""
    b, h, w, c = x.shape
    o = g.shape[-1]
    tiles = tiles_of(b, h, w)
    n_op = -(-o // 64)
    rows = min(len(tiles), max(H100_SMS // n_op, 1))
    xpad = np.zeros((b, h + 2 + TH, w + 2 + TW, c), np.float32)
    xpad[:, 1:h + 1, 1:w + 1] = x
    gpad = np.zeros((b, h + TH, w + TW, o), np.float32)
    gpad[:, :h, :w] = g
    k = 9 * c + (1 if bias else 0)
    part = np.zeros((rows, k, o), np.float32)
    for i in range(rows):
        acc = np.zeros((k, o), np.float32)
        for t in range(i * len(tiles) // rows, (i + 1) * len(tiles) // rows):
            img, y0, x0 = tiles[t]
            a = read_mn_major(a_tile(xpad, img, y0, x0, c, bias))[:, :k]
            inside = np.array([(y0 + r // TW < h) and (x0 + r % TW < w) for r in range(PIX)])
            a[~inside] = 0
            bt = gpad[img, y0:y0 + TH, x0:x0 + TW].reshape(PIX, o)
            acc = (acc + (a.T.astype(np.float64) @ bt).astype(np.float32)).astype(np.float32)
        part[i] = acc
    grp = [np.zeros((k, o), np.float32) for _ in range(SUM_GROUPS)]
    for i in range(rows):
        grp[i % SUM_GROUPS] = (grp[i % SUM_GROUPS] + part[i]).astype(np.float32)
    tot = grp[0]
    for s in grp[1:]:
        tot = (tot + s).astype(np.float32)
    return tot[:9 * c].reshape(3, 3, c, o), tot[9 * c]


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 16, 4), (2, 32, 32, 2), (1, 24, 37, 4)])
def test_tile_walk_and_reduce_match_pallas(interpret, b, h, w, c):
    o = 64
    rs = np.random.RandomState(h * w + c)
    x = f32(jb(rs.randn(b, h, w, c).astype(np.float32)))
    g = f32(jb(rs.randn(b, h, w, o).astype(np.float32)))
    dw, db = emulate(x, g)
    z = jnp.zeros((b, c), jnp.float32)
    dw9, db9, *_ = jfnc._bwd_phase_a(jb(x), z, z, jnp.zeros((3, 3, c, o), jnp.bfloat16), z, z,
                                     jb(g), 1, 1e-5, act=False)
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    dw64 = np.zeros((3, 3, c, o))
    for dy in range(3):
        for dx in range(3):
            dw64[dy, dx] = np.einsum("bhwc,bhwo->co", xp[:, dy:dy + h, dx:dx + w], g)
    for got, pal, ref in ((dw, f32(dw9).reshape(3, 3, c, o), dw64),
                          (db, f32(db9).reshape(-1), g.astype(np.float64).sum((0, 1, 2)))):
        scale = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 1e-5 * scale
        assert float(np.abs(got - pal).max()) <= 1e-5 * scale
