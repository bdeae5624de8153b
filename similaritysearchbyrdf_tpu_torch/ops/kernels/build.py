"""Build and load the port's CUDA kernels on first use.

Every `csrc/*.cu` file is compiled by its own `nvcc` process for Hopper
(`sm_90a`), all started together, and the objects are linked into one shared
library with a plain C interface, loaded through `ctypes`. Sources include no
PyTorch header, so a build takes seconds, not minutes. The library lands in
`build/kernels/<hash of the sources>/` at the root of the checkout
(git-ignored), so an edited source rebuilds and an unchanged one loads from
the cache. A failed build raises; nothing falls back.
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

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = tmp / f"{src.stem}.o", tmp / f"{src.stem}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                        stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, obj, log, proc))
        codes = [proc.wait() for *_, proc in jobs]
        last_build_log = "".join(f"== {src.name}\n{log.read_text()}" for src, _, log, _ in jobs)
        if any(codes):
            failed = [src.name for (src, *_), c in zip(jobs, codes) if c]
            raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
        so = tmp / "librdf_kernels.so"
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
                               *(str(obj) for _, obj, _, _ in jobs)],
                              capture_output=True, text=True)
        last_build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{last_build_log}")
        os.replace(so, out)   # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:      # loaded: no lock on the launch path
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rdf_hash_dense.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
            lib.rdf_hash_dense.restype = i
            lib.rdf_hash_dense_splits.argtypes = [i, i, i]
            lib.rdf_hash_dense_splits.restype = i
            lib.rdf_coarse_block_scores.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.rdf_coarse_block_scores.restype = i
            lib.rdf_coarse_block_form.argtypes = [i] * 5
            lib.rdf_coarse_block_form.restype = i
            lib.rdf_coarse_window_scores.argtypes = [p] * 8 + [i] * 7 + [p, ll, p]
            lib.rdf_coarse_window_scores.restype = i
            lib.rdf_coarse_window_form.argtypes = [i] * 5
            lib.rdf_coarse_window_form.restype = i
            lib.rdf_coarse_window_scratch.argtypes = [i] * 5
            lib.rdf_coarse_window_scratch.restype = ll
            lib.rdf_coarse_rowmax.argtypes = [p] * 6 + [i] * 9 + [p]
            lib.rdf_coarse_rowmax.restype = i
            lib.rdf_flat_groupmax.argtypes = [p] * 4 + [i] * 7 + [p]
            lib.rdf_flat_groupmax.restype = i
            lib.rdf_topk_select.argtypes = [p] * 3 + [i] * 9 + [p]
            lib.rdf_topk_select.restype = i
            lib.rdf_topk_select_form.argtypes = [i] * 3
            lib.rdf_topk_select_form.restype = i
            lib.rdf_topk_select_f32.argtypes = [p] * 4 + [i] * 4 + [p]
            lib.rdf_topk_select_f32.restype = i
            lib.rdf_topk_select_f32_form.argtypes = [i] * 2
            lib.rdf_topk_select_f32_form.restype = i
            _lib = lib
    return _lib


def check_operands(kernel: str, device: torch.device, aligned=(), **operands) -> None:
    """Raise ValueError unless every operand (a tensor) lies contiguous on
    the CUDA `device`, and those named in `aligned` start 16-byte aligned,
    as the kernels' vector loads need."""
    index = device.index
    for name, a in operands.items():
        if not (a.is_cuda and a.get_device() == index and a.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be contiguous on {device}")
        if name in aligned and a.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def stream(device: torch.device) -> int:
    """The raw handle of the CUDA `device`'s current stream, for a launch:
    what `torch.cuda.current_stream(device).cuda_stream` gives, without
    making a `Stream` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
