"""Time K4 or K6 built from other CUDA sources beside the package's own, on one card.

    python -m m_cedm_tpu_torch.kernels.attention_sources [OTHER.cu ...]
        [--kernel k4|k6] [--variant NAME ...] [--sass DIR]

K4 (the default): every source exports K4's C entry points
`mc_attention_fwd` and `mc_attention_bwd` with the signatures of
csrc/fused_attention.cu: the package's own source, the files given (say, a
parent commit's csrc/fused_attention.cu unpacked with `git archive`), and
each `--variant`, the package's source with one named change (VARIANTS,
K4's and K6's).
They are checked against float64 at the flagship's attention shape (N = 16,
L = 1024, D = 64; forward output and the three gradients). K6: every source
exports `mc_apply_dots` with the signature of csrc/linear_attention.cu (the
package's, and say a parent commit's), checked against float64 at the
OFormer's two shapes (BH = 16 and 64, N = 16,384, D = E = 128) and timed at
both. Errors are max |err| / max(1, max |float64|). All sources are built at
once with the package's nvcc flags and timed with CUDA events: the kernels
called directly (no autograd), the median of 10 runs of 10 back-to-back
calls, every source in turn, in two rounds of opposite order. One JSON line
per source and round, after the card's nvidia-smi name and power limit.
`--sass DIR` writes each library's SASS (cuobjdump) to DIR.
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
}
N, L, D = 16, 1024, 64
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the kernel -> its package source and the argument types of its entry points
KERNELS = {
    "k4": ("fused_attention.cu", {"mc_attention_fwd": [P] * 5 + [I, I, I, F, P],
                                  "mc_attention_bwd": [P] * 10 + [I, I, I, F, P]}),
    "k6": ("linear_attention.cu", {"mc_apply_dots": [P] * 3 + [I] * 4 + [P]}),
}
K6_BH, K6_N, K6_W = (16, 64), 16384, 128


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
    if args.kernel == "k6":
        return _time_k6(libs, ptxas)

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


if __name__ == "__main__":
    sys.exit(main())
