"""Time K4 built from other CUDA sources beside the package's own, on one card.

    python -m m_cedm_tpu_torch.kernels.attention_sources [OTHER.cu ...]
        [--variant NAME ...] [--sass DIR]

Every source exports K4's C entry points `mc_attention_fwd` and
`mc_attention_bwd` with the signatures of csrc/fused_attention.cu: the
package's own source, the files given (say, a parent commit's
csrc/fused_attention.cu unpacked with `git archive`), and each `--variant`,
the package's source with one named change (VARIANTS). All are built at
once with the package's nvcc flags, checked against float64 at the
flagship's attention shape (N = 16, L = 1024, D = 64; forward output and the
three gradients, as max |err| / max(1, max |float64|)), and timed there with
CUDA events: the kernels called directly (no autograd), the median of 10
runs of 10 back-to-back calls, every source in turn, in two rounds of
opposite order. One JSON line per source and round, after the card's
nvidia-smi name and power limit. `--sass DIR` writes each library's SASS
(cuobjdump) to DIR.
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

# name -> (text in csrc/fused_attention.cu, its replacement)
VARIANTS = {
    # the split rounded with cvt.rna (ties away), which ptxas expands on sm_90
    "cvt_rna": ('asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;',
                'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                '  return r & 0xffffe000u;'),
    # lo left as the exact fp32 difference x - hi, which the tensor core reads
    # as TF32 (truncating it): one conversion a split instead of two
    "lo_unrounded": ("  lo = to_tf32(x - __uint_as_float(hi));",
                     "  lo = __float_as_uint(x - __uint_as_float(hi));"),
    # one TF32 product (hi * hi) instead of three; the lo halves go unused
    "one_product": ("  mma_tf32(c, a.lo, bh0, bh1);\n  mma_tf32(c, a.hi, bl0, bl1);\n",
                    ""),
}
N, L, D = 16, 1024, 64
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def _sources(files, variants, out_dir: Path):
    own = _build.CSRC / "fused_attention.cu"
    srcs = {"package": own}
    for i, f in enumerate(files):
        srcs[f"file{i}:{f}"] = Path(f)
    text = own.read_text()
    for name in variants:
        old, new = VARIANTS[name]
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: its text is not in {own}")
        path = out_dir / f"variant_{name}.cu"
        path.write_text(text.replace(old, new))
        srcs[f"variant:{name}"] = path
    return srcs


def _build_libs(srcs, out_dir: Path):
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        so = out_dir / f"k4_{i}.so"
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
        lib.mc_attention_fwd.argtypes = [P] * 5 + [I, I, I, F, P]
        lib.mc_attention_bwd.argtypes = [P] * 10 + [I, I, I, F, P]
        libs[name] = (lib, so)
    return libs, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "attention_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, ptxas = _build_libs(_sources(args.files, args.variant, out_dir), out_dir)
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for i, (name, (_, so)) in enumerate(libs.items()):
            with open(Path(args.sass) / f"k4_{i}.sass", "w") as f:
                subprocess.run(["cuobjdump", "-sass", str(so)], stdout=f,
                               stderr=subprocess.STDOUT, check=False)

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


if __name__ == "__main__":
    sys.exit(main())
