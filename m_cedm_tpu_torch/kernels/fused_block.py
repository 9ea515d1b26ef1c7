"""K7: the whole ADM residual block in one kernel launch.

Port of m_cedm_tpu/pallas/fused_block.py (`_mega_kernel`, via `_pallas_mega`):

    h   = conv3x3(silu(gn0(xin) * g0 + b0)) + bias0
    out = conv3x3(silu(gn1(h) * g1 + b1)) + bias1 + skip(xin)

xin is x, or the channel concat of x and x2 (a decoder block's trunk and
encoder skip, passed separately: the concat is never made on the card). skip
is the identity (xin's channels equal O) or xin @ skip_w + skip_b. With
`up`, conv0 sees the nearest 2x upsample of the activated x and the skip
path the upsampled xin (the up-block; the output is twice the input's size).
g0/b0 are the (B, C) folded norm0 modulation, g1/b1 the (B, O) folded norm1
+ FiLM. `stats` are xin's chained channel sums (of the low-res input with
`up`); without them K1's statistics pass runs first. `emit_stats` also
returns the output's per-(B, O) sums. CUDA source: csrc/fused_block.cu, one
cooperative launch of a persistent grid whose two conv phases run K2's
3xTF32 tensor-core conv core; its header says what bounds it on an H100 and
how its design handles that. K7 is deterministic: its statistics are summed
from per-tile partials in a fixed order, with no atomics. Layouts are NHWC;
conv weights HWIO, skip_w (C, O).

`fused_unet_block` is a torch.autograd.Function: K7 for CUDA tensors, the
plain version (`fused_unet_block_plain`, the two-stage composition of
`fused_unet_block_reference`) for CPU tensors. Its backward mirrors
`_mega_bwd`: it recomputes the block through the port's differentiable fused
operations (K1-K3, whose backwards are kernels on the card) and returns
their gradients; the TPU kernel has no backward kernel either. Emitted
statistics are not differentiable and chained ones take a zero cotangent.
`fused_unet_block.launches` counts the K7 launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, check, on_cpu, ptr,
                                              raise_on_error, stream)
from m_cedm_tpu_torch.kernels.fused_norm import channel_stats
from m_cedm_tpu_torch.kernels.fused_norm_conv import (gn_silu_conv,
                                                      gn_silu_conv_plain,
                                                      gn_silu_up_conv,
                                                      gn_silu_up_conv_plain,
                                                      upsample2x_nearest)

Stats = Tuple[torch.Tensor, torch.Tensor]
Out = Union[torch.Tensor, Tuple[torch.Tensor, Stats]]
MAX_WIDTH = 128  # each of C1, C2 and O
# the kernel's work item: an output tile of 8 x 16 pixels and 64 channels
# (the partials buffer has one slot per pixel tile)
_TH, _TW, _BO = 8, 16, 64


def _check_structure(x, x2, skip_w, w1, up):
    """What the block's definition needs, on any device."""
    if up and x2 is not None:
        raise ValueError("up with x2: the megakernel's up-block takes one input "
                         "(fused_block.py:337)")
    c = x.shape[-1] + (x2.shape[-1] if x2 is not None else 0)
    if skip_w is None and c != w1.shape[-1]:
        raise ValueError(f"an identity skip needs {c} input channels to equal "
                         f"{w1.shape[-1]} output channels; pass skip_w")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path and the kernel's reference on the card)
# ---------------------------------------------------------------------------

def _composition(conv, up_conv, x, g0, b0, w0, bias0, g1, b1, w1, bias1,
                 groups0, groups1, eps, x2, skip_w, skip_b, emit_stats, up):
    """The two-stage block (`fused_unet_block_reference`) from a conv and an
    up-conv of K2 / K3's signatures."""
    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    if up:
        h = up_conv(xin, g0, b0, w0, bias0, groups0, eps)
        # an identity skip rides into the tail at low res (K2's identity_up)
        tail = (dict(residual=xin, res_up=True) if skip_w is None else
                dict(residual=upsample2x_nearest(xin), skip_w=skip_w, skip_b=skip_b))
    else:
        h = conv(xin, g0, b0, w0, bias0, groups0, eps)
        tail = dict(residual=xin, skip_w=skip_w, skip_b=skip_b)
    return conv(h, g1, b1, w1, bias1, groups1, eps, emit_stats=emit_stats, **tail)


def fused_unet_block_plain(x, g0, b0, w0, bias0, g1, b1, w1, bias1,
                           groups0: int, groups1: int, eps: float = 1e-5, *,
                           x2=None, skip_w=None, skip_b=None, stats=None,
                           emit_stats: bool = False, up: bool = False) -> Out:
    """Reference of `fused_unet_block` (fused_unet_block_reference), composed
    of the plain K2 / K3. Chained `stats` are ignored and the emitted ones
    recomputed from the output, as the JAX reference does."""
    del stats
    return _composition(gn_silu_conv_plain, gn_silu_up_conv_plain, x, g0, b0, w0,
                        bias0, g1, b1, w1, bias1, groups0, groups1, eps, x2,
                        skip_w, skip_b, emit_stats, up)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def occupancy(up: bool = False) -> Tuple[int, int]:
    """(blocks per SM, SMs): the co-resident grid K7's cooperative launch
    may use on the current card."""
    fn = _build.bind("fused_block", "mc_unet_block_occupancy", [I, P, P])
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    raise_on_error(fn(int(up), ctypes.addressof(per_sm), ctypes.addressof(sms)),
                   "mc_unet_block_occupancy")
    return per_sm.value, sms.value


def grid(batch: int, h: int, w: int, o: int, up: bool = False) -> Tuple[int, int]:
    """(items, blocks) of K7's launch for an output (batch, h, w, o): the
    work items, and the persistent grid that walks them (at most the
    co-resident blocks)."""
    items = batch * -(-h // _TH) * -(-w // _TW) * -(-o // _BO)
    per_sm, sms = occupancy(up)
    return items, min(items, per_sm * sms)


def _unet_block_kernel(x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0,
                       groups1, eps, x2, skip_w, skip_b, stats, emit_stats, up):
    """The K7 launch; returns out or (out, (osums, osumsq))."""
    b, hin, win, c1 = x.shape
    c2 = x2.shape[-1] if x2 is not None else 0
    c, o = c1 + c2, w1.shape[-1]
    h, wd = (2 * hin, 2 * win) if up else (hin, win)
    dev = x.device
    check(x, "x", (b, hin, win, c1), dev)
    if x2 is not None:
        check(x2, "x2", (b, hin, win, c2), dev)
    if not all(1 <= n <= MAX_WIDTH for n in (c1, o) + ((c2,) if c2 else ())):
        raise ValueError(f"K7 takes widths 1..{MAX_WIDTH}; got x {c1}, x2 {c2}, "
                         f"out {o}")
    if c % groups0 or o % groups1:
        raise ValueError(f"{c} / {o} channels do not split into {groups0} / "
                         f"{groups1} groups")
    for name, t, shape in (("g0", g0, (b, c)), ("b0", b0, (b, c)),
                           ("w0", w0, (3, 3, c, o)), ("g1", g1, (b, o)),
                           ("b1", b1, (b, o)), ("w1", w1, (3, 3, o, o))):
        check(t, name, shape, dev)
    for name, t, shape in (("bias0", bias0, (o,)), ("bias1", bias1, (o,)),
                           ("skip_w", skip_w, (c, o)), ("skip_b", skip_b, (o,))):
        if t is not None:
            check(t, name, shape, dev)
    if stats is None:
        parts = [channel_stats(t.reshape(b, hin * win, -1))
                 for t in ((x,) if x2 is None else (x, x2))]
        stats = tuple(torch.cat(s, dim=-1) for s in zip(*parts))
    sums, sumsq = stats
    check(sums, "sums", (b, c), dev)
    check(sumsq, "sumsq", (b, c), dev)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    tiles = -(-h // _TH) * -(-wd // _TW)
    ws, out = empty(b, h, wd, o), empty(b, h, wd, o)
    part_s, part_ss = empty(b, tiles, o), empty(b, tiles, o)
    sums1, sumsq1 = empty(b, o), empty(b, o)
    osums, osumsq = (empty(b, o), empty(b, o)) if emit_stats else (None, None)
    fn = _build.bind("fused_block", "mc_unet_block",
                     [P] * 22 + [I] * 8 + [F, I, P])
    rc = fn(ptr(x), ptr(x2), ptr(g0), ptr(b0), ptr(sums), ptr(sumsq), ptr(w0),
            ptr(bias0), ptr(g1), ptr(b1), ptr(w1), ptr(bias1), ptr(skip_w),
            ptr(skip_b), ptr(ws), ptr(part_s), ptr(part_ss), ptr(sums1),
            ptr(sumsq1), ptr(out), ptr(osums), ptr(osumsq), b, h, wd, c1, c2, o,
            groups0, groups1, eps, int(up), stream())
    raise_on_error(rc, "mc_unet_block")
    fused_unet_block.launches += 1
    return (out, (osums, osumsq)) if emit_stats else out


class _UnetBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g0, b0, w0, bias0, g1, b1, w1, bias1, x2, skip_w, skip_b,
                sums, sumsq, groups0, groups1, eps, emit_stats, up):
        args = (x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0, groups1, eps)
        kw = dict(x2=x2, skip_w=skip_w, skip_b=skip_b, emit_stats=emit_stats, up=up)
        if on_cpu(x):
            out = fused_unet_block_plain(*args, **kw)
        else:
            stats = None if sums is None else (sums, sumsq)
            out = _unet_block_kernel(*args[:9], groups0, groups1, eps, x2, skip_w,
                                     skip_b, stats, emit_stats, up)
        ctx.save_for_backward(x, g0, b0, w0, bias0, g1, b1, w1, bias1, x2,
                              skip_w, skip_b)
        ctx.cfg = (groups0, groups1, eps, up)
        if not emit_stats:
            return out
        out, (osums, osumsq) = out
        ctx.mark_non_differentiable(osums, osumsq)
        return out, osums, osumsq

    @staticmethod
    def backward(ctx, g, *unused_stats_grads):
        groups0, groups1, eps, up = ctx.cfg
        leaves = [None if t is None else
                  t.detach().requires_grad_(bool(ctx.needs_input_grad[i]))
                  for i, t in enumerate(ctx.saved_tensors)]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(())
        if wrt:
            # the recompute through K1-K3, whose backwards are kernels
            with torch.enable_grad():
                out = _composition(gn_silu_conv, gn_silu_up_conv, *leaves[:9],
                                   groups0, groups1, eps, *leaves[9:], False, up)
            got = iter(torch.autograd.grad(out, wrt, g.contiguous()))
        grads = [next(got) if t is not None and t.requires_grad else None
                 for t in leaves]
        # chained statistics take a zero cotangent, as in _mega_bwd
        return tuple(grads) + (None,) * 7


def fused_unet_block(x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0: int,
                     groups1: int, eps: float = 1e-5, *, x2=None, skip_w=None,
                     skip_b=None, stats: Optional[Stats] = None,
                     emit_stats: bool = False, up: bool = False) -> Out:
    """K7: the whole ADM residual block (module docstring).

    x (B, h, w, C1) [+ x2 (B, h, w, C2)]; g0/b0 (B, C) with C = C1 + C2; w0
    (3, 3, C, O); g1/b1 (B, O); w1 (3, 3, O, O); bias0/bias1 (O,) or None;
    skip_w (C, O) and skip_b (O,) or None for the identity skip (C == O).
    Output (B, h, w, O), or (B, 2h, 2w, O) with `up`; with `emit_stats`,
    (out, (sums, sumsq)) of out's channels (not differentiable). On the card
    C1, C2 and O are at most 128 and every tensor fp32 and contiguous."""
    _check_structure(x, x2, skip_w, w1, up)
    sums, sumsq = stats if stats is not None else (None, None)
    out = _UnetBlock.apply(x, g0, b0, w0, bias0, g1, b1, w1, bias1, x2, skip_w,
                           skip_b, sums, sumsq, groups0, groups1, eps, emit_stats,
                           up)
    return (out[0], (out[1], out[2])) if emit_stats else out


fused_unet_block.launches = 0
