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
`fused_unet_block.launches` counts the K7 launches of both instances.

bf16 (launched for bf16 activations): x, x2, w0, w1, skip_w, the workspace
and the output are bf16; g0, b0, g1, b1, the biases and the statistics
fp32. It rounds where the Pallas `_mega_kernel` rounds on a bf16 network:
norm0 with the chained `stats` it is given, the activation in fp32 rounded
once to bf16, conv0's bf16 products summed in fp32 from the fp32 bias0, h
stored rounded to bf16 and norm1's statistics taken from the fp32 sums
before that rounding, the activation of the rounded h rounded once, the
projection's bf16 products (or the upcast identity) added in fp32, the
output rounded once and the emitted statistics those of the fp32 sums. Its
plain version is therefore the chained composition of the bf16 plain K2 /
K3 (the block's `stats` into conv0, conv0's emitted statistics into
conv1), not the fp32 one, which recomputes the statistics and is exact only
in fp32. Two kernels compute it, the route chosen by shape in C
(csrc/k7_plan.h's tma_shape): unet_block_bf16_tma_kernel (TMA copies and
stores, a warpgroup that activates each stage while others multiply the one
before) where C1, C2 and O are multiples of 8, every base 16-byte aligned
and an identity skip has one input; else unet_block_bf16_kernel
(cp.async). The TMA route's launch plan is csrc/k7_plan.h's, plain C++
that a host compiler builds alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, act_dtype, check,
                                              on_cpu, ptr, raise_on_error,
                                              stream)
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
# (the partials buffer has one slot per pixel tile; the bf16 instance's
# 16 x 16 tiles take half of it)
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
                 groups0, groups1, eps, x2, skip_w, skip_b, emit_stats, up,
                 stats=None, chain=False):
    """The two-stage block (`fused_unet_block_reference`) from a conv and an
    up-conv of K2 / K3's signatures. `chain`: the block's `stats` go into
    conv0, whose emitted statistics go into conv1 (the bf16 kernel's
    rounding points)."""
    xin = torch.cat([x, x2], dim=-1) if x2 is not None else x
    first = conv if not up else up_conv
    if chain:
        h, h_stats = first(xin, g0, b0, w0, bias0, groups0, eps, stats=stats,
                           emit_stats=True)
    else:
        h, h_stats = first(xin, g0, b0, w0, bias0, groups0, eps), None
    if up:
        # an identity skip rides into the tail at low res (K2's identity_up)
        tail = (dict(residual=xin, res_up=True) if skip_w is None else
                dict(residual=upsample2x_nearest(xin), skip_w=skip_w, skip_b=skip_b))
    else:
        tail = dict(residual=xin, skip_w=skip_w, skip_b=skip_b)
    return conv(h, g1, b1, w1, bias1, groups1, eps, stats=h_stats,
                emit_stats=emit_stats, **tail)


def fused_unet_block_plain(x, g0, b0, w0, bias0, g1, b1, w1, bias1,
                           groups0: int, groups1: int, eps: float = 1e-5, *,
                           x2=None, skip_w=None, skip_b=None, stats=None,
                           emit_stats: bool = False, up: bool = False) -> Out:
    """Reference of `fused_unet_block` (fused_unet_block_reference), composed
    of the plain K2 / K3. fp32: chained `stats` are ignored and the emitted
    ones recomputed from the output, as the JAX reference does. bf16: the
    bf16 kernel's function, the chained composition (module docstring);
    without `stats` norm0's statistics are xin's own."""
    chain = x.dtype == torch.bfloat16
    return _composition(gn_silu_conv_plain, gn_silu_up_conv_plain, x, g0, b0, w0,
                        bias0, g1, b1, w1, bias1, groups0, groups1, eps, x2,
                        skip_w, skip_b, emit_stats, up,
                        stats=stats if chain else None, chain=chain)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _bf16_plan(batch: int, h: int, w: int, c1: int, c2: int, o: int, up: bool,
               proj: bool) -> Tuple[int, ...]:
    """The bf16 K7's launch plan for an output (batch, h, w, o), from the
    CUDA source: (phase 0's weights resident, phase 1's, dynamic shared
    memory bytes, co-resident blocks an SM, SMs, blocks, tile rows, route (1
    TMA, 0 the kept unet_block_bf16_kernel), ring stages, consumer
    warpgroups)."""
    fn = _build.bind("fused_block", "mc_unet_block_bf16_plan", [I] * 8 + [P])
    out = (ctypes.c_int * 10)()
    raise_on_error(fn(batch, h, w, c1, c2, o, int(up), int(proj), out),
                   "mc_unet_block_bf16_plan")
    return tuple(out)


def occupancy(up: bool = False, dtype: torch.dtype = torch.float32, *,
              shape: Optional[Tuple[int, ...]] = None) -> Tuple[int, int]:
    """(blocks per SM, SMs): the co-resident grid K7's cooperative launch
    may use on the current card. The bf16 instance's shared memory depends
    on the call's widths: `shape` is (batch, h, w, c1, c2, o, proj), h and w
    the output's."""
    if dtype == torch.bfloat16:
        b, h, w, c1, c2, o, proj = shape
        return _bf16_plan(b, h, w, c1, c2, o, up, proj)[3:5]
    fn = _build.bind("fused_block", "mc_unet_block_occupancy", [I, P, P])
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    raise_on_error(fn(int(up), ctypes.addressof(per_sm), ctypes.addressof(sms)),
                   "mc_unet_block_occupancy")
    return per_sm.value, sms.value


def grid(batch: int, h: int, w: int, o: int, up: bool = False,
         dtype: torch.dtype = torch.float32, *, c1: int = 0, c2: int = 0,
         proj: bool = False) -> Tuple[int, int]:
    """(items, blocks) of K7's launch for an output (batch, h, w, o): the
    work items (8 x 16 pixel tiles x 64 outputs; the bf16 instance's tiles
    16 x 16 where its plan takes them), and the persistent grid that walks
    them (at most the co-resident blocks; the bf16 instance's a multiple of
    the 64-output blocks, each block walking one of them). bf16 needs the
    input widths c1, c2 and whether a projection runs."""
    if dtype == torch.bfloat16:
        plan = _bf16_plan(batch, h, w, c1, c2, o, up, proj)
        return batch * -(-h // plan[6]) * -(-w // _TW) * -(-o // _BO), plan[5]
    items = batch * -(-h // _TH) * -(-w // _TW) * -(-o // _BO)
    per_sm, sms = occupancy(up)
    return items, min(items, per_sm * sms)


def _unet_block_kernel(x, g0, b0, w0, bias0, g1, b1, w1, bias1, groups0,
                       groups1, eps, x2, skip_w, skip_b, stats, emit_stats, up):
    """The K7 launch (the bf16 instance for bf16 x); returns out or (out,
    (osums, osumsq))."""
    b, hin, win, c1 = x.shape
    c2 = x2.shape[-1] if x2 is not None else 0
    c, o = c1 + c2, w1.shape[-1]
    h, wd = (2 * hin, 2 * win) if up else (hin, win)
    dev = x.device
    dt = act_dtype(x)
    check(x, "x", (b, hin, win, c1), dev, dt)
    if x2 is not None:
        check(x2, "x2", (b, hin, win, c2), dev, dt)
    if not all(1 <= n <= MAX_WIDTH for n in (c1, o) + ((c2,) if c2 else ())):
        raise ValueError(f"K7 takes widths 1..{MAX_WIDTH}; got x {c1}, x2 {c2}, "
                         f"out {o}")
    if c % groups0 or o % groups1:
        raise ValueError(f"{c} / {o} channels do not split into {groups0} / "
                         f"{groups1} groups")
    f32 = torch.float32
    for name, t, shape, t_dt in (("g0", g0, (b, c), f32), ("b0", b0, (b, c), f32),
                                 ("w0", w0, (3, 3, c, o), dt), ("g1", g1, (b, o), f32),
                                 ("b1", b1, (b, o), f32), ("w1", w1, (3, 3, o, o), dt)):
        check(t, name, shape, dev, t_dt)
    for name, t, shape, t_dt in (("bias0", bias0, (o,), f32), ("bias1", bias1, (o,), f32),
                                 ("skip_w", skip_w, (c, o), dt), ("skip_b", skip_b, (o,), f32)):
        if t is not None:
            check(t, name, shape, dev, t_dt)
    if stats is None:
        parts = [channel_stats(t.reshape(b, hin * win, -1))
                 for t in ((x,) if x2 is None else (x, x2))]
        stats = tuple(torch.cat(s, dim=-1) for s in zip(*parts))
    sums, sumsq = stats
    check(sums, "sums", (b, c), dev)
    check(sumsq, "sumsq", (b, c), dev)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, device=dev, dtype=dtype)

    tiles = -(-h // _TH) * -(-wd // _TW)
    ws, out = empty(b, h, wd, o, dtype=dt), empty(b, h, wd, o, dtype=dt)
    part_s, part_ss = empty(b, tiles, o), empty(b, tiles, o)
    sums1, sumsq1 = empty(b, o), empty(b, o)
    osums, osumsq = (empty(b, o), empty(b, o)) if emit_stats else (None, None)
    name = "mc_unet_block" + ("_bf16" if dt == torch.bfloat16 else "")
    fn = _build.bind("fused_block", name, [P] * 22 + [I] * 8 + [F, I, P])
    rc = fn(ptr(x), ptr(x2), ptr(g0), ptr(b0), ptr(sums), ptr(sumsq), ptr(w0),
            ptr(bias0), ptr(g1), ptr(b1), ptr(w1), ptr(bias1), ptr(skip_w),
            ptr(skip_b), ptr(ws), ptr(part_s), ptr(part_ss), ptr(sums1),
            ptr(sumsq1), ptr(out), ptr(osums), ptr(osumsq), b, h, wd, c1, c2, o,
            groups0, groups1, eps, int(up), stream())
    raise_on_error(rc, name)
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
    C1, C2 and O are at most 128 and every tensor contiguous: fp32, or bf16
    x, x2, w0, w1 and skip_w with fp32 vectors and statistics (the bf16
    instance, which returns bf16)."""
    _check_structure(x, x2, skip_w, w1, up)
    sums, sumsq = stats if stats is not None else (None, None)
    out = _UnetBlock.apply(x, g0, b0, w0, bias0, g1, b1, w1, bias1, x2, skip_w,
                           skip_b, sums, sumsq, groups0, groups1, eps, emit_stats,
                           up)
    return (out[0], (out[1], out[2])) if emit_stats else out


fused_unet_block.launches = 0
