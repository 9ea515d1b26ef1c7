"""A per-step timeline of one block of the bf16 K7's TMA kernel on the card.

    python3 -m m_cedm_tpu_torch.kernels.k7bf16_trace [--tiles-8]

Copies csrc/ into build/k7bf16_trace/csrc, adds clock64 stamps to block 0 of
unet_block_bf16_tma_kernel (a __device__ table and a C entry that reads it
back) and builds that copy alone; then runs the flagship's identity block
at res 128 (attention_sources.py's k7_bf16_cases, B = 16, ch 64) three
times and prints, for each step of block 0 (phase 0's, then phase 1's), in
microseconds from the first stamp at the SM clock nvidia-smi reads just
after the runs:
`full` (warpgroup 0 past the stage's TMA copy), `act` (its activation
handed on), `c0_act` / `c1_act` (consumer warpgroup 0 / 1 past the
activation), `c0_mma` / `c1_mma` (their products done), `c0_sfree`
(warpgroup 0's staging free), `c0_epi` (its epilogue's store issued),
`iss_wait` / `iss_done` (a leader's copy of that step: its stage empty, its
TMA issued). --tiles-8 takes 8 x 16 tiles (as the variant k7bf16_tiles_8).
Needs a CUDA device; the package's own library is not touched.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys

COLUMNS = ("full", "act", "c0_act", "c0_mma", "c0_epi", "c1_act", "c1_mma", "c0_sfree",
           "iss_wait", "iss_done")
# (text of the source after which a stamp goes, the step's variable, the
# thread that stamps, the column)
STAMPS = (
    ("    wait_t(bar.full + slot, (g / S) & 1);\n", "g", "tid == 0", "full"),
    ("    if (lane == 0) tma::mbar_arrive(bar.act + slot);\n", "g", "tid == 0", "act"),
    ("    wait_t(bar.act + slot, (gs / S) & 1);\n    __syncwarp();\n", "gs", "ctid == 0",
     "c0_act"),
    ("    wait_t(bar.act + slot, (gs / S) & 1);\n    __syncwarp();\n", "gs", "ctid == 128",
     "c1_act"),
    ("    if (lane == 0) tma::mbar_arrive(bar.empty + slot);\n", "gs", "ctid == 0", "c0_mma"),
    ("    if (lane == 0) tma::mbar_arrive(bar.empty + slot);\n", "gs", "ctid == 128", "c1_mma"),
    ("      tma::store_commit();\n    }\n    if (!stats) continue;\n", "gs", "ctid == 0",
     "c0_epi"),
    ("    wait_t(bar.sfree + w, k & 1);\n", "gs", "ctid == 0", "c0_sfree"),
    ("    if (g >= S) wait_t(bar.empty + slot, (g / S - 1) & 1);\n", "g", "(ctid & 127) == 0",
     "iss_wait"),
    ("    if (!resident) weights(ch, st + stage_t(kM), bar.full + slot);\n", "g",
     "(ctid & 127) == 0", "iss_done"),
)
STEPS = 256


def traced_source(text: str) -> str:
    """fused_block.cu with the stamps and the C entry mc_k7bf16_trace_read"""
    text = text.replace("struct alignas(64) MapsT {",
                        f"__device__ long long g_k7_trace[{len(COLUMNS)}][{STEPS}];\n"
                        "struct alignas(64) MapsT {", 1)
    for anchor in dict.fromkeys(a for a, *_ in STAMPS):
        code = "".join(
            f"if (blockIdx.x == 0 && {who} && {step} < {STEPS}) "
            f"g_k7_trace[{COLUMNS.index(col)}][{step}] = clock64();\n"
            for a, step, who, col in STAMPS if a == anchor)
        if text.count(anchor) != 1:
            raise ValueError(f"the source has no single {anchor!r}")
        text = text.replace(anchor, anchor + code)
    return text + ('\nextern "C" int mc_k7bf16_trace_read(long long* dst) {\n'
                   "  return (int)cudaMemcpyFromSymbol(dst, g_k7_trace, sizeof(g_k7_trace));\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles-8", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from m_cedm_tpu_torch.kernels import _build
    from m_cedm_tpu_torch.kernels.attention_sources import K7_TILES_8

    root = _build.BUILD_DIR.parent / "k7bf16_trace"
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for f in _build.CSRC.iterdir():
        if f.is_file():
            shutil.copy(f, root / "csrc" / f.name)
    src = root / "csrc" / "fused_block.cu"
    src.write_text(traced_source(src.read_text()))
    if args.tiles_8:  # the plan in the copy's k7_plan.h, as the variant does
        plan = root / "csrc" / "k7_plan.h"
        text = plan.read_text()
        if text.count(K7_TILES_8[0]) != 1:
            raise ValueError(f"k7_plan.h has no single {K7_TILES_8[0]!r}")
        plan.write_text(text.replace(*K7_TILES_8))
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "kernels"
    _build.build_all(["fused_block"])
    from m_cedm_tpu_torch.kernels import fused_block as fb
    from m_cedm_tpu_torch.kernels.attention_sources import k7_bf16_cases

    dev = torch.device("cuda")
    args_, kw = k7_bf16_cases(dev, 16, 128, 64, 0)["identity, res 128, chained stats, emit"]
    for _ in range(3):
        fb.fused_unet_block(*args_, **kw)
    torch.cuda.synchronize()
    # the SM clock right after the runs: the stamps' unit
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    mhz = float(smi.stdout.strip().split(",")[-1])
    buf = (ctypes.c_longlong * (len(COLUMNS) * STEPS))()
    rc = _build.bind("fused_block", "mc_k7bf16_trace_read", [ctypes.c_void_p])(
        ctypes.addressof(buf))
    if rc:
        raise RuntimeError(f"mc_k7bf16_trace_read: cudaError {rc}")
    t = np.array(buf, dtype=np.int64).reshape(len(COLUMNS), STEPS)
    t0 = t[0, 0]
    print("step " + " ".join(COLUMNS))
    for i in range(int((t[0] > 0).sum())):
        print(i, " ".join(f"{(t[k, i] - t0) / mhz:.2f}" if t[k, i] else "-"
                          for k in range(len(COLUMNS))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
