"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in `recbox_tpu_torch/csrc/` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` at the repository root (listed in `.gitignore`). A
library's file name carries a hash of its source and flags, so an edited
source builds anew and a stale library is never loaded. Nothing here runs
at import: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

SOURCES = {"mips_fused_topk": "mips_fused_topk.cu",
           "packed_delta": "packed_delta.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (register / shared memory use from -Xptxas -v) by kernel
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path("/usr/local/cuda/bin/nvcc")
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc
    process per source, all started together. Returns the seconds each
    build took (0.0 for a library already built); raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started, seconds = {}, {}
    for name in names:
        lib = _library(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    failures = []
    for name, (proc, tmp, lib, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        lib = _library(name)
        if not lib.exists():
            build([name])
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
