"""Build and load the port's CUDA kernels on first use.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded through `ctypes`. Sources
include no PyTorch header, so a build takes seconds, not minutes. The
library lands in `build/kernels/<hash of the sources>/` at the root of the
checkout (git-ignored), so an edited source rebuilds and an unchanged one
loads from the cache. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
last_build_log = ""


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "librdf_kernels.so"


def build() -> Path:
    """Compile the kernels unless the cached library matches the sources."""
    global last_build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{last_build_log}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rdf_hash_dense.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.rdf_hash_dense.restype = i
            lib.rdf_coarse_block_scores.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            lib.rdf_coarse_block_scores.restype = i
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
