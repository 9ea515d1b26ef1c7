"""Build the CUDA sources under m_cedm_tpu_torch/csrc/ and bind them.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
nvcc for sm_90a into `build/kernels/<name>-<hash>.so` at the repository root
(listed in .gitignore); the hash covers the source, the csrc headers it
includes with quotes (`#include "bf16_conv_tiles.cuh"`) and the flags, so an
edit to any of them rebuilds. The library is loaded with ctypes. Nothing here runs at import:
the first launch of a kernel builds its library, and `build_all` builds every
library at once, one nvcc process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("fused_norm", "fused_norm_conv", "fused_norm_conv_bwd", "narrow_conv",
           "fused_attention", "linear_attention", "fused_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG")
# beside them: fp32 FMAs, and atomics or reductions on a floating type
_FFMA = re.compile(r"\sFFMA[.\s]")
_FATOM = re.compile(r"\s(?:RED|ATOM|ATOMG|ATOMS)\.\S*\b(?:F16|BF16|F16x2|F32|F64)\b")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "m_cedm_tpu_torch are compiled at first use")


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _sources_of(path: Path, seen=None) -> list:
    """The file and, depth first, every file it includes with quotes (looked
    up beside it, as nvcc does), each once."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for inc in _QUOTED_INCLUDE.findall(path.read_bytes()):
            _sources_of(path.parent / inc.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    src = b"".join(f.read_bytes() for f in _sources_of(CSRC / f"{name}.cu"))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    (0.0 for one already built). Raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (including ptxas register and spill counts) of the
    library's last build, or '' when it was built by another process."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def sass_counts(lib, contains: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a built library (a source's name, or the path of a
    .so) whose mangled name holds `contains`: its HGMMA (wgmma), HMMA
    (mma.sync), UTMALDG (TMA load) and UTMASTG (TMA store) instructions in
    cuobjdump's SASS, its fp32 FMAs (FFMA) and its atomics and reductions
    on a floating type (FATOM)."""
    so = _lib_path(lib) if isinstance(lib, str) else lib
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if contains in name:
                counts[name] = {op: 0 for op in SASS_OPS + ("FFMA", "FATOM")}
            else:
                name = None
        elif name is not None:
            for op in SASS_OPS:
                if f" {op}." in line:
                    counts[name][op] += 1
            counts[name]["FFMA"] += bool(_FFMA.search(line))
            counts[name]["FATOM"] += bool(_FATOM.search(line))
    return counts


def bind(lib_name: str, fn_name: str, argtypes):
    """A C entry point with its argument types declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    return fn
