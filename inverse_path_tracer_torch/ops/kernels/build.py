"""Build the CUDA sources of this package with nvcc and bind them via ctypes.

Each source is compiled on first use into a shared library with a plain C
interface, under ``build/kernels/`` at the repository root (listed in
.gitignore).  The library's file name carries a hash of the source, of
every header (``*.cuh``) of this directory and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  All sources
that are missing are compiled at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")

# -fmad=false: no contraction of a*b+c into one rounding, so that kernels
# round like their plain PyTorch versions (see render_fwd.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

SOURCES = {"render_fwd": "render_fwd.cu", "render_bwd": "render_bwd.cu",
           "inverse": "inverse.cu", "reorder": "reorder.cu"}

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # kernel name -> nvcc output of this process's build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(HERE) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(HERE, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named source whose library is missing, in parallel.
    Returns {name: seconds} for what was compiled; raises on any failure."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(HERE, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    times, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} (rc={proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
