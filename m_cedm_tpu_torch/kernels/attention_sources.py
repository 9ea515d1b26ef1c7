"""Time K4, K6, K2/K3 or K5 built from other CUDA sources beside the package's own, on one card.

    python -m m_cedm_tpu_torch.kernels.attention_sources [OTHER.cu ...]
        [--kernel k4|k6|k2|k5] [--variant NAME ...] [--sass DIR]
    python -m m_cedm_tpu_torch.kernels.attention_sources --kernel mma

Every source exports the C entry points of the kernel's package source with
the same signatures: the package's own source, the files given (say, a
parent commit's csrc file unpacked with `git archive`), and each
`--variant`, the package's source with one named change (VARIANTS).

  k4 (the default)  `mc_attention_fwd` and `mc_attention_bwd`
      (csrc/fused_attention.cu), checked at the flagship's attention shape
      (N = 16, L = 1024, D = 64; forward output and the three gradients).
  k6  `mc_apply_dots` (csrc/linear_attention.cu), at the OFormer's two
      shapes (BH = 16 and 64, N = 16,384, D = E = 128).
  k2  `mc_gn_silu_conv` and `mc_gn_silu_up_conv` (csrc/fused_norm_conv.cu),
      at the flagship's shapes (B = 16, ch 64): every K2 mode of
      chip_smoke.py's phase 2 (the identity tail at res 128 with chained
      statistics, with emitted statistics, identity_up, the projection from
      the 128-channel concat, the 128-channel decoder conv0, the linear down
      conv0 at res 64), the identity tail at res 64 and 32, and K3 to res 128.
  k5  `mc_kv_dots` (csrc/linear_attention.cu), at BH = 16 and 64 (N =
      16,384, D = E = 128), with the wrapper's split rule (about one block
      per SM) and with two blocks per SM (the rule of the CUDA-core kernel
      it replaced).

  mma  no source: the rate of TF32 mma.sync.m16n8k8 with fp32 accumulation
      on this card, from a kernel that issues nothing else (eight
      independent accumulators a warp, 4 to 32 warps an SM), as the
      ceiling of the 3xTF32 kernels built on it; and the rate of the
      3xTF32 split itself (two cvt.rn.tf32.f32 and a subtraction), in
      warp-wide splits per ns per SM.

Each output is checked against float64 (the plain versions, or einsum, in
float64 on the card): errors are max |err| / max(1, max |float64|), the
largest over a call's outputs. All sources are built at once with the
package's nvcc flags and timed with CUDA events: the kernels called directly
(no autograd; K2's emitted-statistics buffers are zeroed inside the timed
call, as the wrapper allocates them zeroed), the median of 10 runs of 10
back-to-back calls, every source in turn, in two rounds of opposite order.
One JSON line per source and round, after the card's nvidia-smi name and
power limit. `--sass DIR` writes each library's SASS (cuobjdump) to DIR.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from m_cedm_tpu_torch.kernels import _build

# name -> (kernel, text in its package source, the replacement)
VARIANTS = {
    # the split rounded with cvt.rna (ties away), which ptxas expands on sm_90
    "cvt_rna": ("k4", 'asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;',
                'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                '  return r & 0xffffe000u;'),
    # lo left as the exact fp32 difference x - hi, which the tensor core reads
    # as TF32 (truncating it): one conversion a split instead of two
    "lo_unrounded": ("k4", "  lo = to_tf32(x - __uint_as_float(hi));",
                     "  lo = __float_as_uint(x - __uint_as_float(hi));"),
    # one TF32 product (hi * hi) instead of three; the lo halves go unused
    "one_product": ("k4", "  mma_tf32(c, a.lo, bh0, bh1);\n  mma_tf32(c, a.hi, bl0, bl1);\n",
                    ""),
    # K6's tensor-core partial sums added into the fp32 accumulator after four
    # k-steps, or once (the products accumulated on the tensor cores alone)
    "temp_steps_4": ("k6", "constexpr int kTempSteps = 1;", "constexpr int kTempSteps = 4;"),
    "temp_steps_16": ("k6", "constexpr int kTempSteps = 1;", "constexpr int kTempSteps = 16;"),
    # K6 with one m16 tile a warp: 16 warps a block instead of 8
    "m_tiles_1": ("k6", "constexpr int kMTiles = 2;", "constexpr int kMTiles = 1;"),
    # K2/K3's partial sums added into the fp32 accumulator after each tap
    # instead of after a chunk's nine
    "k2_temp_steps_1": ("k2", "constexpr int kTempSteps = 9;", "constexpr int kTempSteps = 1;"),
    # diagnostics, not kernels: K2 with its products left out, or its
    # staging pass (results wrong; the time of the rest)
    "diag_k2_no_mma": ("k2", "      mma_chunk<9>(sa, sb, acc, rg, cq, lane);", "      ;"),
    "diag_k2_no_split": ("k2", "      split_x<kUp>(p, rx + st * kRawX, sa, q * kCK, ty0, tx0, s_a, s_b, tid);\n      split_w<9>(rw + st * kRawW, sb, tid);", "      ;"),
    # K5's partial sums added after each k-step instead of after a 64-row stage
    "k5_temp_steps_1": ("k5", "constexpr int kKvTempSteps = 8;",
                        "constexpr int kKvTempSteps = 1;"),
}
N, L, D = 16, 1024, 64
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the kernel -> its package source and the argument types of its entry points
KERNELS = {
    "k4": ("fused_attention.cu", {"mc_attention_fwd": [P] * 5 + [I, I, I, F, P],
                                  "mc_attention_bwd": [P] * 10 + [I, I, I, F, P]}),
    "k6": ("linear_attention.cu", {"mc_apply_dots": [P] * 3 + [I] * 4 + [P]}),
    "k2": ("fused_norm_conv.cu", {"mc_gn_silu_conv": [P] * 13 + [I] * 7 + [F, I, I, P],
                                  "mc_gn_silu_up_conv": [P] * 10 + [I] * 6 + [F, P]}),
    "k5": ("linear_attention.cu", {"mc_kv_dots": [P] * 4 + [I] * 6 + [P]}),
    "mma": (None, {}),
}
K6_BH, K6_N, K6_W = (16, 64), 16384, 128
K2_B, K2_RES, K2_CH = 16, 128, 64


def _cuda_ms(fn, runs: int = 10, per_run: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return float(np.median(times))


def _sources(kernel, files, variants, out_dir: Path):
    own = _build.CSRC / KERNELS[kernel][0]
    srcs = {"package": own}
    for i, f in enumerate(files):
        srcs[f"file{i}:{f}"] = Path(f)
    text = own.read_text()
    for name in variants:
        _, old, new = VARIANTS[name]
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: its text is not in {own}")
        path = out_dir / f"variant_{name}.cu"
        path.write_text(text.replace(old, new))
        srcs[f"variant:{name}"] = path
    return srcs


def _build_libs(kernel, srcs, out_dir: Path):
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        so = out_dir / f"{kernel}_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in KERNELS[kernel][1].items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, so)
    return libs, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--kernel", default="k4", choices=sorted(KERNELS))
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    if any(VARIANTS[v][0] != args.kernel for v in args.variant):
        ap.error(f"a --variant of another kernel than {args.kernel}")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.kernel == "mma":
        return _time_mma()
    out_dir = _build.BUILD_DIR / "attention_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, ptxas = _build_libs(args.kernel, _sources(args.kernel, args.files, args.variant,
                                                    out_dir), out_dir)
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for i, (name, (_, so)) in enumerate(libs.items()):
            with open(Path(args.sass) / f"{args.kernel}_{i}.sass", "w") as f:
                subprocess.run(["cuobjdump", "-sass", str(so)], stdout=f,
                               stderr=subprocess.STDOUT, check=False)
    if args.kernel != "k4":
        return {"k6": _time_k6, "k2": _time_k2, "k5": _time_k5}[args.kernel](libs, ptxas)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rs.randn(N, L, D).astype(np.float32)).to(dev)
                  for _ in range(4))
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    o64 = torch.softmax(q64 @ k64.transpose(1, 2) / 8, dim=-1) @ v64
    want = torch.autograd.grad(o64, (q64, k64, v64), g.double())
    stream = torch.cuda.current_stream().cuda_stream

    def rel(a, w):
        return float((a.double() - w).abs().max()) / max(1.0, float(w.abs().max()))

    def calls(lib):
        o, lse, delta = torch.empty_like(q), q.new_empty(N, L), q.new_empty(N, L)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ptrs = [t.data_ptr() for t in (q, k, v)]

        def fwd():
            return lib.mc_attention_fwd(*ptrs, o.data_ptr(), lse.data_ptr(), N, L, D,
                                        0.125, stream)

        def bwd():
            return lib.mc_attention_bwd(*ptrs, o.data_ptr(), g.data_ptr(),
                                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), N, L, D, 0.125,
                                        stream)
        return fwd, bwd, (o, dq, dk, dv)

    errs = {}
    for name, (lib, _) in libs.items():
        fwd, bwd, (o, dq, dk, dv) = calls(lib)
        if fwd() or bwd():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        errs[name] = {"fwd_err": rel(o, o64.detach()),
                      "bwd_err": [rel(a, w) for a, w in zip((dq, dk, dv), want)]}
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            fwd, bwd, _ = calls(libs[name][0])
            print(json.dumps({"source": name, "round": rnd, "fwd_ms": _cuda_ms(fwd),
                              "bwd_ms": _cuda_ms(bwd), **errs[name],
                              "ptxas": ptxas[name]}), flush=True)
    return 0


MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// iters rounds of eight independent m16n8k8 TF32 products per warp
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 7u);
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mc_mma_rate(float* out, int blocks, int threads, int iters, void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
// iters rounds of eight independent 3xTF32 splits (two cvt.rn.tf32.f32 and
// one subtraction each) per thread
__global__ void split_rate(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * (j + 1.37f);
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, lo;
      asm volatile("cvt.rn.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x[j]));
      asm volatile("cvt.rn.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x[j] - __uint_as_float(hi)));
      acc ^= hi ^ lo;
      x[j] = __uint_as_float(lo) + 1.0001f * x[j];
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)acc;
}
extern "C" int mc_split_rate(float* out, int blocks, int threads, int iters, void* stream) {
  split_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _time_mma() -> int:
    """TF32 mma.sync.m16n8k8 products per second on the card, with blocks of
    4 warps filling 4 to 32 warps an SM; then the 3xTF32 split's rate."""
    out_dir = _build.BUILD_DIR / "attention_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_rate.cu", out_dir / "mma_rate.so"
    src.write_text(MMA_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mc_mma_rate.argtypes = [P, I, I, I, P]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for warps in (4, 8, 16, 32):
        blocks = sms * warps // 4
        out = torch.empty(blocks * 128, device=dev)
        ms = _cuda_ms(lambda: lib.mc_mma_rate(out.data_ptr(), blocks, 128, iters, stream))
        flops = 2.0 * 16 * 8 * 8 * 8 * iters * blocks * 4
        print(json.dumps({"warps_per_sm": warps, "ms": ms,
                          "tf32_tflops": flops / ms / 1e9,
                          "ns_per_mma_per_sm": ms * 1e6 / (flops / 2048 / sms)}),
              flush=True)
    lib.mc_split_rate.argtypes = [P, I, I, I, P]
    iters = 1024
    for warps in (16, 32):
        blocks = sms * warps // 4
        out = torch.empty(blocks * 128, device=dev)
        ms = _cuda_ms(lambda: lib.mc_split_rate(out.data_ptr(), blocks, 128, iters, stream))
        splits = 8.0 * iters * blocks * 128
        print(json.dumps({"warps_per_sm": warps, "ms": ms,
                          "split_warp_instr_per_ns_per_sm": splits / 32 / ms / 1e6 / sms}),
              flush=True)
    return 0


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))


def _report(libs, ptxas, calls, errs) -> None:
    """Time calls[name][case]() for every source, in two rounds of opposite
    order, and print one line per source and round."""
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            print(json.dumps({"source": name, "round": rnd,
                              **{f"ms {case}": _cuda_ms(fn)
                                 for case, fn in calls[name].items()},
                              **errs[name], "ptxas": ptxas[name]}), flush=True)


def _time_k6(libs, ptxas) -> int:
    """mc_apply_dots of every source at BH 16 and 64, checked, then timed."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for bh in K6_BH:
        q = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        dots = torch.from_numpy((rs.randn(bh, K6_W, K6_W) / 8).astype(np.float32)).to(dev)
        cases[bh] = (q, dots, torch.empty_like(q), q.double() @ dots.double())

    def call(lib, bh):
        q, dots, out, _ = cases[bh]
        return lambda: lib.mc_apply_dots(q.data_ptr(), dots.data_ptr(), out.data_ptr(),
                                         bh, K6_N, K6_W, K6_W, stream)

    errs = {}
    for name, (lib, _) in libs.items():
        errs[name] = {}
        for bh in K6_BH:
            if call(lib, bh)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            out, want = cases[bh][2], cases[bh][3]
            errs[name][f"err_bh_{bh}"] = (float((out.double() - want).abs().max())
                                          / max(1.0, float(want.abs().max())))
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = libs[name][0]
            print(json.dumps({"source": name, "round": rnd,
                              **{f"ms_bh_{bh}": _cuda_ms(call(lib, bh)) for bh in K6_BH},
                              **errs[name], "ptxas": ptxas[name]}), flush=True)
    return 0


def _time_k2(libs, ptxas) -> int:
    """mc_gn_silu_conv / mc_gn_silu_up_conv of every source at the flagship's
    K2 and K3 shapes, checked against float64, then timed."""
    from m_cedm_tpu_torch.kernels import fused_norm_conv as fnc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    b, res, ch = K2_B, K2_RES, K2_CH

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def conv_w(ci, co):
        return rnd(3, 3, ci, co, scale=1.0 / ci ** 0.5 / 3)

    w, bias = conv_w(ch, ch), rnd(ch, scale=0.3)
    w2 = conv_w(2 * ch, ch)
    skw, skb = rnd(2 * ch, ch, scale=(2 * ch) ** -0.5), rnd(ch, scale=0.3)
    cases = {}

    def k2(name, x, act, *, res=None, res_mode=0, skip_w=None, skip_b=None,
           emit=False, wt=w, up=False):
        c = x.shape[-1]
        gamma, beta = (rnd(b, c, scale=0.3, shift=1.0), rnd(b, c, scale=0.3)) if act \
            else (None, None)
        sums = fnc._out_stats_plain(x) if act else (None, None)
        h_out, w_out = (2 * x.shape[1], 2 * x.shape[2]) if up else x.shape[1:3]
        kw = {}
        if res_mode == 1:
            kw = dict(residual=res)
        elif res_mode == 2:
            kw = dict(residual=res, res_up=True)
        elif res_mode == 3:
            kw = dict(residual=res, skip_w=skip_w, skip_b=skip_b)
        args64 = [None if t is None else t.double()
                  for t in (x, gamma, beta, wt, bias)]
        kw64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()}
        groups = 32 if act else 0
        if up:
            want = fnc.gn_silu_up_conv_plain(*args64, groups, emit_stats=emit)
        else:
            want = fnc.gn_silu_conv_plain(*args64, groups, emit_stats=emit, **kw64)
        want = want if emit else (want, (None, None))
        out = torch.empty(b, h_out, w_out, ch, device=dev)
        osums = torch.zeros(b, ch, device=dev) if emit else None
        osumsq = torch.zeros(b, ch, device=dev) if emit else None
        cases[name] = dict(x=x, gamma=gamma, beta=beta, w=wt, sums=sums, res=res,
                           res_mode=res_mode, skip_w=skip_w, skip_b=skip_b, out=out,
                           osums=osums, osumsq=osumsq, act=int(act), up=up,
                           want=want, cr=skip_w.shape[0] if skip_w is not None else 0)

    h = rnd(b, res, res, ch, scale=0.8, shift=0.2)
    xc = rnd(b, res, res, 2 * ch, scale=0.8, shift=0.2)
    k2("identity, chained stats, res 128", h, True, res=rnd(b, res, res, ch), res_mode=1)
    k2("identity, emit_stats, res 128", h, True, res=rnd(b, res, res, ch), res_mode=1,
       emit=True)
    k2("identity_up, emit_stats, res 128", h, True,
       res=rnd(b, res // 2, res // 2, ch), res_mode=2, emit=True)
    k2("proj from the 128-channel concat, emit_stats, res 128", h, True, res=xc,
       res_mode=3, skip_w=skw, skip_b=skb, emit=True)
    k2("128-channel input, emit_stats, res 128", xc, True, emit=True, wt=w2)
    k2("act=False (down conv0), res 64",
       rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), False)
    for r in (res // 2, res // 4):
        k2(f"identity, chained stats, res {r}",
           rnd(b, r, r, ch, scale=0.8, shift=0.2), True, res=rnd(b, r, r, ch), res_mode=1)
    k2("K3 up conv0, chained stats, emit_stats, to res 128",
       rnd(b, res // 2, res // 2, ch, scale=0.8, shift=0.2), True, emit=True, up=True)

    def call(lib, c):
        p = [None if t is None else t.data_ptr() for t in (
            c["x"], c["w"], bias, c["gamma"], c["beta"], *c["sums"], c["res"],
            c["skip_w"], c["skip_b"], c["out"], c["osums"], c["osumsq"])]
        bb, hh, ww, o = c["out"].shape
        cin = c["x"].shape[-1]

        def fn():
            if c["osums"] is not None:
                c["osums"].zero_()
                c["osumsq"].zero_()
            if c["up"]:
                rc = lib.mc_gn_silu_up_conv(*p[:7], *p[10:], bb, hh, ww, cin, o, 32,
                                            1e-5, stream)
            else:
                rc = lib.mc_gn_silu_conv(*p, bb, hh, ww, cin, o, c["cr"],
                                         32 if c["act"] else 1, 1e-5, c["act"],
                                         c["res_mode"], stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return fn

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            calls[name][case]()
            torch.cuda.synchronize()
            out, (ws, wss) = c["want"]
            errs[name][f"err {case}"] = max(
                [_rel(c["out"], out)] + ([_rel(c["osums"], ws), _rel(c["osumsq"], wss)]
                                         if ws is not None else []))
    _report(libs, ptxas, calls, errs)
    return 0


def _time_k5(libs, ptxas) -> int:
    """mc_kv_dots of every source at BH 16 and 64, with the wrapper's split
    rule and with two blocks per SM, checked against float64, then timed."""
    import math

    from m_cedm_tpu_torch.kernels import linear_attention as la

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {}
    for bh in K6_BH:
        k = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        v = torch.from_numpy(rs.randn(bh, K6_N, K6_W).astype(np.float32)).to(dev)
        want = k.double().transpose(1, 2) @ v.double()
        for rule, splits in (("one per SM", la._splits(bh, K6_N, dev)),
                             ("two per SM", max(1, min(2 * sms // bh, K6_N // 128)))):
            rows = math.ceil(math.ceil(K6_N / splits) / la._CHUNK) * la._CHUNK
            cases[f"bh {bh}, {splits} splits ({rule})"] = (
                k, v, torch.empty(bh, K6_W, K6_W, device=dev),
                torch.empty(bh, splits, K6_W, K6_W, device=dev), bh, splits, rows, want)

    def call(lib, c):
        k, v, out, part, bh, splits, rows, _ = c
        return lambda: lib.mc_kv_dots(k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      part.data_ptr(), bh, K6_N, K6_W, K6_W, splits,
                                      rows, stream)

    calls, errs = {}, {}
    for name, (lib, _) in libs.items():
        calls[name] = {case: call(lib, c) for case, c in cases.items()}
        errs[name] = {}
        for case, c in cases.items():
            if calls[name][case]():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs[name][f"err {case}"] = _rel(c[2], c[7])
    _report(libs, ptxas, calls, errs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
