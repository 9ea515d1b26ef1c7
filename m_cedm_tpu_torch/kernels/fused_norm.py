"""K1: GroupNorm (+ per-sample FiLM) + SiLU, silu(gn(x) * gamma + beta), and
its backward.

Port of m_cedm_tpu/pallas/fused_norm.py (kernels `_stats_kernel`,
`_apply_kernel`, and the backward's `_grad_stats_kernel`,
`_grad_apply_kernel`; the paired twins `_stats4_kernel`/`_apply4_kernel`/
`_grad_stats4_kernel`/`_grad_apply4_kernel` of fused_norm_conv.py compute the
same math). CUDA source: csrc/fused_norm.cu, whose header says what bounds it
on an H100 and how its design handles that.

`gn_silu` is a torch.autograd.Function and `channel_stats` a plain wrapper:
each runs its CUDA kernel for a CUDA tensor and the plain PyTorch version
beside it for a CPU tensor, and counts its kernel launches in `.launches`
(`gn_silu_bwd.launches` for the backward). The statistics are not
differentiable: a consumer's backward computes the full GroupNorm gradient
from x and gives chained statistics a zero cotangent.

The forward passes (csrc/fused_norm.cu, whose plans `stats_plan` and
`apply_plan` mirror): the statistics pass is one cluster launch, a cluster
of up to STATS_CLUSTER blocks a sample, whose partials are summed in a fixed
order (no atomics, no zeroed buffers: the same bits on every call); the
apply runs about APPLY_BLOCKS_PER_SM blocks an SM, each thread on one
16-byte channel chunk for the whole call, its rows coming through a ring of
cp.async copies in shared memory. Both read 16-byte vectors where C takes
whole ones and the tensors are 16-byte aligned, else one element.

bf16: both forward kernels have a bf16 instance, which the wrappers launch
for a bf16 activation (gamma, beta and the statistics stay fp32): the sums
are fp32 sums of the upcast input, the apply runs in fp32 (SiLU by fast
exp and divide) and rounds once at its store, where the Pallas kernels
round. `gn_silu_plain` on a bf16 input is the plain version of that function
(`gn_silu_bf16_plain`). The backward has a bf16 kernel written for Hopper
(csrc/fused_norm.cu::gn_silu_bwd_cluster_kernel, its plan in
csrc/k1_bwd_plan.h; x and g bf16, the statistics the forward used): one
launch on thread-block clusters, each sample reduced by its own blocks,
computing in fp32 as _grad_stats_kernel / _grad_apply_kernel do on bf16
input, emitting dgamma and dbeta in fp32 and rounding dx once to bf16;
`gn_silu_bwd_bf16_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from m_cedm_tpu_torch.kernels import _build
from m_cedm_tpu_torch.kernels._launch import (F, I, P, act_dtype, check,
                                              on_cpu, ptr, raise_on_error,
                                              stream)

Stats = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def channel_stats_plain(x: torch.Tensor) -> Stats:
    """Per-(B, C) sum and sum of squares of a (B, N, C) activation, in fp32
    (a bf16 input is upcast first)."""
    x = x.float()
    return x.sum(dim=1), (x * x).sum(dim=1)


def gn_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  num_groups: int, eps: float = 1e-5,
                  stats: Optional[Stats] = None) -> torch.Tensor:
    """silu(group_norm(x) * gamma + beta); x (B, N, C), gamma/beta (B, C).

    Two-pass variance as in group_norm_silu_reference. Chained `stats` are
    ignored and recomputed, as the JAX reference does. A bf16 x takes the
    bf16 kernels' function instead (`gn_silu_bf16_plain`)."""
    if x.dtype == torch.bfloat16:
        return gn_silu_bf16_plain(x, gamma, beta, num_groups, eps, stats)
    del stats
    b, n, c = x.shape
    xg = x.reshape(b, n, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xhat = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, n, c)
    y = xhat * gamma[:, None, :] + beta[:, None, :]
    return y * torch.sigmoid(y)


def gn_silu_bf16_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       num_groups: int, eps: float = 1e-5,
                       stats: Optional[Stats] = None) -> torch.Tensor:
    """The bf16 kernels' function (the Pallas _stats_kernel / _apply_kernel
    on bf16 input): fp32 channel sums of the upcast x (or the chained
    `stats`), the group mean and E[x^2] - mean^2 from them, the normalize,
    FiLM and SiLU in fp32 as the kernel folds them (x * a + b with a = gamma
    * rstd, b = beta - a * mean), one rounding to bf16 at the end."""
    xf = x.float()
    b, n, c = x.shape
    sums, sumsq = stats if stats is not None else channel_stats_plain(xf)
    mean, rstd = group_mean_rstd_from_sums(sums, sumsq, n, num_groups, eps)
    a = gamma * rstd
    y = xf * a[:, None] + (beta - a * mean)[:, None]
    return (y * torch.sigmoid(y)).to(x.dtype)


def _per_channel(v: torch.Tensor, c: int) -> torch.Tensor:
    """(B, G) group values -> (B, C)."""
    return v.repeat_interleave(c // v.shape[-1], dim=-1)


def group_mean_rstd(x: torch.Tensor, num_groups: int, eps: float):
    """Per-(B, C) mean and rstd of a (B, N, C) tensor's groups, two-pass as
    `gn_silu_plain` computes them."""
    b, n, c = x.shape
    xg = x.reshape(b, n, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return _per_channel(mean, c), _per_channel(torch.rsqrt(var + eps), c)


def group_mean_rstd_from_sums(sums: torch.Tensor, sumsq: torch.Tensor, n: int,
                              num_groups: int, eps: float):
    """Per-(B, C) mean and rstd from channel sums over n pixels, as the
    kernels fold them (E[x^2] - mean^2, clamped at 0)."""
    b, c = sums.shape
    cnt = n * (c // num_groups)
    mean = sums.reshape(b, num_groups, -1).sum(-1) / cnt
    var = torch.clamp(sumsq.reshape(b, num_groups, -1).sum(-1) / cnt
                      - mean * mean, min=0.0)
    return _per_channel(mean, c), _per_channel(torch.rsqrt(var + eps), c)


def dx_from_da(x, da, gamma, dgamma, dbeta, mean, rstd, num_groups: int):
    """The GroupNorm input gradient from the cotangent da of the affine
    output a = xhat * gamma + beta and its channel sums dgamma = sum da * xhat,
    dbeta = sum da (`_dx_from_da`): dx = rstd * (da * gamma - m1 - xhat * m2),
    m1 and m2 the group means of da * gamma and da * gamma * xhat, which the
    identities sum(da * gamma) = gamma * dbeta and sum(da * gamma * xhat) =
    gamma * dgamma give from (B, C) vectors. x, da (B, N, C) or NHWC; bf16 x
    or da promote to fp32 as they are read, and dx is fp32 then."""
    b, c = gamma.shape
    n = x.numel() // (b * c)
    cnt = n * (c // num_groups)

    def gmean(v):
        return _per_channel(v.reshape(b, num_groups, -1).sum(-1) / cnt, c)

    m1, m2 = gmean(gamma * dbeta), gmean(gamma * dgamma)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    r, g = rstd.reshape(shape), gamma.reshape(shape)
    # as (r g) da - r m1 - (r^2 m2)(x - mean), the (B, C) factors formed
    # first: three passes over the full tensors
    t = x - mean.reshape(shape)
    u = torch.addcmul(-r * m1.reshape(shape), t, -(r * r) * m2.reshape(shape))
    return torch.addcmul(u, da, r * g)


def silu_grad(y: torch.Tensor) -> torch.Tensor:
    """d silu(y) / dy."""
    sig = torch.sigmoid(y)
    return sig * (1.0 + y * (1.0 - sig))


def gn_silu_bwd_plain(g, x, gamma, beta, num_groups: int, eps: float = 1e-5,
                      stats: Optional[Stats] = None):
    """The backward kernels' formulas (_grad_stats_kernel, _grad_apply_kernel)
    with the plain forward's statistics: (dx, dgamma, dbeta). A bf16 x takes
    the bf16 kernel's function (`gn_silu_bwd_bf16_plain`, with `stats`)."""
    if x.dtype == torch.bfloat16:
        return gn_silu_bwd_bf16_plain(g, x, gamma, beta, num_groups, eps, stats)
    mean, rstd = group_mean_rstd(x, num_groups, eps)
    xhat = (x - mean[:, None]) * rstd[:, None]
    dy = g * silu_grad(xhat * gamma[:, None] + beta[:, None])
    dgamma, dbeta = (dy * xhat).sum(dim=1), dy.sum(dim=1)
    return dx_from_da(x, dy, gamma, dgamma, dbeta, mean, rstd, num_groups), dgamma, dbeta


def gn_silu_bwd_bf16_plain(g, x, gamma, beta, num_groups: int, eps: float = 1e-5,
                           stats: Optional[Stats] = None):
    """The bf16 backward kernel's function (_grad_stats_kernel and
    _grad_apply_kernel on bf16 x and g): x and g upcast, mean and rstd from
    the forward's fp32 `stats` (the channel sums of x when None), every step
    in fp32, dgamma and dbeta fp32, dx rounded once to bf16."""
    xf, gf = x.float(), g.float()
    sums, sumsq = stats if stats is not None else channel_stats_plain(xf)
    mean, rstd = group_mean_rstd_from_sums(sums, sumsq, x.shape[1], num_groups, eps)
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dy = gf * silu_grad(xhat * gamma[:, None] + beta[:, None])
    dgamma, dbeta = (dy * xhat).sum(dim=1), dy.sum(dim=1)
    dx = dx_from_da(xf, dy, gamma, dgamma, dbeta, mean, rstd, num_groups)
    return dx.to(x.dtype), dgamma, dbeta


# K1's forward launch plans (csrc/fused_norm.cu: kStatsThreads, kStatsCluster,
# kStatsMinRows, kStatsUnroll, kApplyThreads, kApplyBlocksPerSm)
STATS_THREADS, STATS_CLUSTER, STATS_MIN_ROWS, STATS_UNROLL = 256, 8, 256, 8
APPLY_THREADS, APPLY_BLOCKS_PER_SM = 256, 4


def fwd_vec(c: int, itemsize: int, aligned: bool) -> int:
    """Channels a thread loads at once: one 16-byte vector (4 fp32, 8 bf16)
    where C takes whole vectors and the tensors are 16-byte aligned, else 1."""
    v = 16 // itemsize
    return v if aligned and c % v == 0 else 1


def fwd_lanes(c: int, vec: int, threads: int) -> Tuple[int, int]:
    """(lanes, slots): a block's threads as `lanes` consecutive vec-channel
    chunks of a row (wider rows in passes of `lanes`), `slots` rows at a
    time."""
    lanes = min(c // vec, threads)
    return lanes, threads // lanes


def part_begin(i: int, parts: int, n: int) -> int:
    """The first row of part i of n rows cut into `parts` contiguous parts."""
    return i * n // parts


def stats_plan(n: int, c: int, vec: int) -> Tuple[int, int, int]:
    """(blocks a sample, lanes, slots) of the statistics pass: one cluster a
    sample, the largest power of two up to STATS_CLUSTER blocks that leaves
    each block STATS_MIN_ROWS rows, or one block."""
    cl = STATS_CLUSTER
    while cl > 1 and cl * STATS_MIN_ROWS > n:
        cl //= 2
    return (cl, *fwd_lanes(c, vec, STATS_THREADS))


def apply_plan(b: int, n: int, c: int, vec: int, sms: int) -> Tuple[int, int, int]:
    """(blocks a sample, lanes, slots) of the apply on `sms` SMs: about
    APPLY_BLOCKS_PER_SM blocks an SM over the batch, at most one per `slots`
    rows of the sample."""
    lanes, slots = fwd_lanes(c, vec, APPLY_THREADS)
    want = -(-APPLY_BLOCKS_PER_SM * sms // b)
    return max(1, min(want, -(-n // slots))), lanes, slots


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def channel_stats(x: torch.Tensor) -> Stats:
    """K1 pass 1: per-(B, C) sums of a (B, N, C) activation (one launch,
    which writes both outputs whole)."""
    if on_cpu(x):
        return channel_stats_plain(x)
    b, n, c = x.shape
    dt = act_dtype(x)
    check(x, "x", (b, n, c), x.device, dt)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("channel statistics are not differentiable: pass a "
                         "detached tensor (the consumers' backward kernels "
                         "take the full GroupNorm gradient)")
    sums = torch.empty((b, c), device=x.device, dtype=torch.float32)
    sumsq = torch.empty_like(sums)
    name = "mc_channel_stats" + ("_bf16" if dt == torch.bfloat16 else "")
    fn = _build.bind("fused_norm", name, [P, P, P, I, I, I, P])
    raise_on_error(fn(ptr(x), ptr(sums), ptr(sumsq), b, n, c, stream()), name)
    channel_stats.launches += 1
    return sums, sumsq


channel_stats.launches = 0


def _gn_silu_kernel(x, gamma, beta, sums, sumsq, num_groups, eps):
    b, n, c = x.shape
    dev = x.device
    dt = act_dtype(x)
    check(x, "x", (b, n, c), dev, dt)
    check(gamma, "gamma", (b, c), dev)
    check(beta, "beta", (b, c), dev)
    check(sums, "sums", (b, c), dev)
    check(sumsq, "sumsq", (b, c), dev)
    out = torch.empty_like(x)
    name = "mc_gn_silu" + ("_bf16" if dt == torch.bfloat16 else "")
    fn = _build.bind("fused_norm", name, [P, P, P, P, P, P, I, I, I, I, F, P])
    raise_on_error(fn(ptr(x), ptr(gamma), ptr(beta), ptr(sums), ptr(sumsq),
                      ptr(out), b, n, c, num_groups, eps, stream()), name)
    gn_silu.launches += 1
    return out


# K1's fp32 backward: one cooperative launch of two blocks an SM (one above
# BWD_WIDE_CHANNELS channels, whose blocks take twice the shared memory),
# each sample's rows cut into one slab per block (csrc/fused_norm.cu)
BWD_WIDE_CHANNELS = 1024
BWD_MAX_CHANNELS = 2048


def bwd_plan(n: int, c: int, sms: int) -> Tuple[int, int]:
    """(slabs, rows) of the backward's launch: each sample's n rows cut into
    `slabs` runs of `rows` rows (the last ragged, none empty), one per block
    of a grid of at most two blocks (one above BWD_WIDE_CHANNELS channels) on
    each of `sms` SMs."""
    per_sm = 1 if c > BWD_WIDE_CHANNELS else 2
    rows = -(-n // min(per_sm * sms, n))
    return -(-n // rows), rows


_PLANS = {}


def _plan(n: int, c: int, device: torch.device) -> Tuple[int, int]:
    """bwd_plan for the card of `device`, kept per shape."""
    key = (n, c, device.index)
    if key not in _PLANS:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _PLANS[key] = bwd_plan(n, c, sms)
    return _PLANS[key]


def gn_silu_bwd(g, x, gamma, beta, stats: Stats, num_groups: int,
                eps: float = 1e-5):
    """K1's backward kernel on the card: (dx, dgamma, dbeta), with `stats`
    the (sums, sumsq) the forward used. x and g are read once and dx written
    once; dgamma and dbeta are summed in a fixed order (bit for bit on a
    repeat). bf16 x and g take the bf16 kernel (dx bf16; `_gn_silu_bwd_bf16`)."""
    b, n, c = x.shape
    dev = x.device
    dt = act_dtype(x)
    for name, t, shape in (("g", g, (b, n, c)), ("x", x, (b, n, c)),
                           ("gamma", gamma, (b, c)), ("beta", beta, (b, c)),
                           ("sums", stats[0], (b, c)), ("sumsq", stats[1], (b, c))):
        check(t, name, shape, dev, dt if name in ("g", "x") else torch.float32)
    if c % num_groups or c > BWD_MAX_CHANNELS:
        raise ValueError(f"K1's backward takes up to {BWD_MAX_CHANNELS} channels "
                         f"in whole groups; got {c} in {num_groups}")
    if dt == torch.bfloat16:
        return _gn_silu_bwd_bf16(g, x, gamma, beta, stats, num_groups, eps)
    slabs, rows = _plan(n, c, dev)
    # per-slab partials; the arrival counters, then each group's m1 and m2 as
    # tagged words
    scratch = torch.empty(b * slabs * -(-2 * c // 4) * 4, device=dev, dtype=torch.float32)
    sync = torch.zeros(-(-b // 2) * 2 + 4 * b * num_groups, device=dev, dtype=torch.int32)
    dgamma = torch.empty((b, c), device=dev, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    dx = torch.empty_like(x)
    fn = _build.bind("fused_norm", "mc_gn_silu_bwd", [P] * 11 + [I] * 4 + [F, I, I, P])
    raise_on_error(fn(ptr(x), ptr(g), ptr(gamma), ptr(beta), ptr(stats[0]),
                      ptr(stats[1]), ptr(dgamma), ptr(dbeta), ptr(dx), ptr(scratch),
                      ptr(sync), b, n, c, num_groups, eps, slabs, rows, stream()),
                   "mc_gn_silu_bwd")
    gn_silu_bwd.launches += 1
    return dx, dgamma, dbeta


# the bf16 backward's plan fields (csrc/k1_bwd_plan.h, mc_gn_silu_bwd_bf16_plan),
# then the clusters of 1, 2, 4, 8 blocks the card holds at once and its SMs
BWD_BF16_PLAN_KEYS = ("cluster", "clusters", "blocks", "inflight", "grid", "waves", "rows",
                      "chunk_rows", "chunks", "slots", "lanes", "row_slots", "sets",
                      "slot_bytes", "smem", "xchg_words", "consumers", "active_1", "active_2",
                      "active_4", "active_8", "sms")
_BF16_PLANS = {}


def bwd_bf16_plan(b: int, n: int, c: int, num_groups: int, device) -> dict:
    """The bf16 backward's launch plan on the card of `device` (the C
    entry's, csrc/k1_bwd_plan.h), kept per shape."""
    key = (b, n, c, num_groups, torch.device(device).index)
    if key not in _BF16_PLANS:
        out = (ctypes.c_longlong * len(BWD_BF16_PLAN_KEYS))()
        name = "mc_gn_silu_bwd_bf16_plan"
        raise_on_error(_build.bind("fused_norm", name, [I] * 4 + [P])(b, n, c, num_groups, out),
                       name)
        _BF16_PLANS[key] = dict(zip(BWD_BF16_PLAN_KEYS, out))
    return _BF16_PLANS[key]


# Where a sample spans several clusters, each cluster's sums go through
# device memory as 64-bit words tagged with the call's epoch: one zeroed
# buffer a device, kept from call to call (grown where a plan needs more),
# and an epoch no earlier call on it used, so no call zeroes anything.
# Calls on one device share it in stream order.
_XCHG = {}
_EPOCH_LIMIT = 2 ** 32 - 1


def _exchange(words: int, device):
    """(buffer, epoch) for a call whose plan needs `words` tagged words."""
    slot = _XCHG.get(device.index)
    if slot is None or slot[0].numel() < words or slot[1] + 1 >= _EPOCH_LIMIT:
        slot = _XCHG[device.index] = [torch.zeros(words, device=device, dtype=torch.int64), 0]
    slot[1] += 1
    return slot[0], slot[1]


def _gn_silu_bwd_bf16(g, x, gamma, beta, stats, num_groups, eps):
    """The bf16 kernel: one launch, dgamma and dbeta as views of one (2, B,
    C) output."""
    b, n, c = x.shape
    dev = x.device
    if c % 8 or any(t.data_ptr() % 16 for t in (x, g)):
        raise ValueError("K1's bf16 backward takes a multiple of 8 channels and "
                         "16-byte aligned x and g")
    words = bwd_bf16_plan(b, n, c, num_groups, dev)["xchg_words"]
    xchg, epoch = _exchange(words, dev) if words else (None, 0)
    dgb = torch.empty((2, b, c), device=dev, dtype=torch.float32)
    dx = torch.empty_like(x)
    fn = _build.bind("fused_norm", "mc_gn_silu_bwd_bf16", [P] * 10 + [ctypes.c_uint]
                     + [I] * 4 + [F, P])
    raise_on_error(fn(ptr(x), ptr(g), ptr(gamma), ptr(beta), ptr(stats[0]), ptr(stats[1]),
                      ptr(dgb[0]), ptr(dgb[1]), ptr(dx), ptr(xchg), epoch, b, n, c,
                      num_groups, eps, stream()), "mc_gn_silu_bwd_bf16")
    gn_silu_bwd.launches += 1
    return dx, dgb[0], dgb[1]


gn_silu_bwd.launches = 0


class _GnSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, sums, sumsq, num_groups, eps):
        ctx.cfg = (num_groups, eps)
        if on_cpu(x):
            stats = None if sums is None else (sums, sumsq)
            # the bf16 backward uses the statistics its forward used
            ctx.save_for_backward(x, gamma, beta, *(stats or ()))
            return gn_silu_plain(x, gamma, beta, num_groups, eps, stats)
        if x.shape[-1] % num_groups:
            raise ValueError(f"{x.shape[-1]} channels do not split into "
                             f"{num_groups} groups")
        if sums is None:
            sums, sumsq = channel_stats(x)
        ctx.save_for_backward(x, gamma, beta, sums, sumsq)
        return _gn_silu_kernel(x, gamma, beta, sums, sumsq, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps = ctx.cfg
        x, gamma, beta, *stats = ctx.saved_tensors
        g = g.contiguous()
        if on_cpu(g):
            grads = gn_silu_bwd_plain(g, x, gamma, beta, num_groups, eps,
                                      tuple(stats) or None)
        else:
            grads = gn_silu_bwd(g, x, gamma, beta, tuple(stats), num_groups, eps)
        # the statistics take a zero cotangent: dx above is the full gradient
        return grads + (None, None, None, None)


def gn_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            num_groups: int, eps: float = 1e-5,
            stats: Optional[Stats] = None) -> torch.Tensor:
    """K1: silu(group_norm(x) * gamma + beta). x (B, N, C); gamma/beta (B, C)
    per-sample folded modulation; `stats` optional chained (sums, sumsq) of
    x, which skip the stats pass (on the card; the plain version recomputes
    them, as the JAX reference does)."""
    sums, sumsq = stats if stats is not None else (None, None)
    return _GnSilu.apply(x, gamma, beta, sums, sumsq, num_groups, eps)


gn_silu.launches = 0
