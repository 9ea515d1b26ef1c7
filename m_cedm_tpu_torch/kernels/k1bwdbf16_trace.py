"""The phases of K1's bf16 backward (gn_silu_bwd_cluster_kernel), block by
block, on the card.

    python3 -m m_cedm_tpu_torch.kernels.k1bwdbf16_trace

Copies csrc/ into build/k1bwdbf16_trace/csrc, adds %globaltimer stamps to
thread 0 of every block (a __device__ table and a C entry that reads it
back) and builds that copy alone; then runs the train step's two shapes
(B 16, C 64, 16 groups, N 128^2 and 64^2) five times each and prints, for
the last run, the median and the largest over the blocks of each stamp in
microseconds from the block's start: `pass_a` (its compute warps' group 0
past pass A), `reduced` (the block's partials summed), `handoff` (the
sample's sums in, from the cluster's ranks and the sample's other
clusters), `m1m2` (m1 and m2 formed), `pass_b` (pass B's stores issued and
read), and `start_spread`, the latest block start after the earliest.
Needs a CUDA device; the package's own library is not touched.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

COLUMNS = ("pass_a", "reduced", "handoff", "m1m2", "pass_b")
# the text of csrc/fused_norm.cu before which each stamp goes, in COLUMNS'
# order after the start's
ANCHORS = ("    // the block's partials: a butterfly",
           "    // the hand-off: each rank's partial",
           "    // dgamma and dbeta by one block",
           "    // pass B: dx, rounded once",
           "    // every rank has read this block's partial")
START = "  int f0 = 0;\n  for (int b = grp, it = 0; b < p.batch; b += pl.inflight, ++it) {\n"
BLOCKS = 1024


def traced_source(text: str) -> str:
    """fused_norm.cu with the stamps and the C entry mc_k1bwd_trace_read"""
    table = (f"__device__ unsigned long long g_k1_trace[{BLOCKS}][{len(COLUMNS) + 1}];\n"
             "__device__ __forceinline__ unsigned long long k1_now() {\n"
             "  unsigned long long t;\n"
             "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n")
    text = text.replace("struct ClusterArgs {", table + "struct ClusterArgs {", 1)

    def stamp(col: int) -> str:
        return (f"    if (tid == 0 && blockIdx.x < {BLOCKS}) "
                f"g_k1_trace[blockIdx.x][{col}] = k1_now();\n")
    assert text.count(START) == 1
    text = text.replace(START, START + stamp(0), 1)
    for col, anchor in enumerate(ANCHORS, 1):
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, stamp(col) + anchor, 1)
    return text + (
        "\nextern \"C\" int mc_k1bwd_trace_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_k1_trace, sizeof(g_k1_trace));\n}\n")


def main() -> int:
    import torch

    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels import fused_norm as fn

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = _build.BUILD_DIR.parent / "k1bwdbf16_trace"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    src = out / "csrc" / "fused_norm.cu"
    src.write_text(traced_source(src.read_text()))
    so = out / "libk1trace.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mc_gn_silu_bwd_bf16.argtypes = [P] * 10 + [ctypes.c_uint] + [I] * 4 + [ctypes.c_float, P]
    lib.mc_k1bwd_trace_read.argtypes = [P]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, n, c, groups in ((16, 16384, 64, 16), (16, 4096, 64, 16)):
        x = (torch.randn((b, n, c), generator=gen, device=dev) * 0.8 + 0.2).bfloat16()
        gy = torch.randn((b, n, c), generator=gen, device=dev).bfloat16()
        gamma = torch.randn((b, c), generator=gen, device=dev) * 0.3 + 1.0
        beta = torch.randn((b, c), generator=gen, device=dev) * 0.3
        sums, sumsq = fn.channel_stats_plain(x)
        plan = fn.bwd_bf16_plan(b, n, c, groups, dev)
        xchg = torch.zeros(max(plan["xchg_words"], 1), device=dev, dtype=torch.int64)
        dgb = torch.empty((2, b, c), device=dev)
        dx = torch.empty_like(x)
        for epoch in range(1, 6):
            rc = lib.mc_gn_silu_bwd_bf16(
                x.data_ptr(), gy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(),
                sumsq.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(), dx.data_ptr(),
                xchg.data_ptr(), epoch, b, n, c, groups, 1e-5, stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        torch.cuda.synchronize()
        table = (ctypes.c_ulonglong * (BLOCKS * (len(COLUMNS) + 1)))()
        if lib.mc_k1bwd_trace_read(table):
            raise RuntimeError("reading the trace failed")
        t = torch.tensor(list(table), dtype=torch.float64).view(BLOCKS, -1)[:plan["grid"]]
        rel = (t[:, 1:] - t[:, :1]) * 1e-3
        print(json.dumps({
            "shape": [b, n, c], "plan": plan,
            "median_us": dict(zip(COLUMNS, (round(float(v), 2) for v in rel.median(0).values))),
            "max_us": dict(zip(COLUMNS, (round(float(v), 2) for v in rel.max(0).values))),
            "start_spread_us": round(float((t[:, 0].max() - t[:, 0].min()) * 1e-3), 2)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
