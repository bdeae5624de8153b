"""ctypes bridge to the native host parser and batch codecs (librdf_loader.so).

A copy of `similaritysearchbyrdf_tpu/native/loader.py` with its own build:
`rdf_loader.cc` and `rdf_codec.cc` (copies of the JAX package's sources,
shipped as package data) are compiled by one `g++` call on first use, never
at import, into `build/native/<hash of the sources>/librdf_loader.so` at the
root of the checkout (git-ignored); nothing is written into the package.
An unchanged source loads from that cache. It is a host parser with no
device behind it: its output equals the Python parsers', and every caller
falls back to those parsers when the library cannot be built (no compiler),
so the native tier is an accelerator, never a requirement.

`library()` builds and loads it; `built`, `build_s` and `last_build_log` say
whether and how the build went, and `CALLS` counts the calls that took the
native path (a parse or a codec that returned a result).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("rdf_loader.cc", "rdf_codec.cc"))
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
built = False              # the library was built (or found built) and loaded
build_s: Optional[float] = None   # seconds of the last build (None: from the cache)
last_build_log = ""
CALLS = 0                  # calls that took the native path


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "librdf_loader.so"


def _build() -> Optional[Path]:
    """Compile the library unless the cached one matches the sources; None
    when no compiler is found or the build fails (the log says why)."""
    global build_s, last_build_log
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        last_build_log = "no C++ compiler (g++) found"
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = Path(tmp) / out.name
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(so), *map(str, SOURCES)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as err:
            last_build_log = f"{cxx} did not run: {err}"
            return None
        last_build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return None
        os.replace(so, out)   # atomic: concurrent builders never see half a file
    build_s = time.perf_counter() - t0
    return out


def library() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first call; None when it cannot
    be built or loaded (callers then take the Python parsers)."""
    global _lib, _build_failed, built, last_build_log
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError as err:
            last_build_log += f"\nloading {path} failed: {err}"
            lib = None
        if lib is None:
            _build_failed = True
            return None
        lib.rdf_parse_dense_file.restype = ctypes.c_void_p
        lib.rdf_parse_dense_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_copy_dense.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.rdf_free_dense.argtypes = [ctypes.c_void_p]
        lib.rdf_parse_sparse_file.restype = ctypes.c_void_p
        lib.rdf_parse_sparse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_copy_sparse.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.rdf_free_sparse.argtypes = [ctypes.c_void_p]
        # batch wire-format codecs (rdf_codec.cc)
        lib.rdf_encode_dense_batch.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rdf_encode_dense_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.rdf_decode_dense_batch.restype = ctypes.c_void_p
        lib.rdf_decode_dense_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_copy_dense_batch.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.rdf_free_dense_batch.argtypes = [ctypes.c_void_p]
        lib.rdf_encode_sparse_batch.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rdf_encode_sparse_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_decode_sparse_batch.restype = ctypes.c_void_p
        lib.rdf_decode_sparse_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rdf_copy_sparse_batch.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.rdf_free_sparse_batch.argtypes = [ctypes.c_void_p]
        _lib = lib
        built = True
        return _lib


def _counted(result):
    """Count a call that took the native path, and pass its result on."""
    global CALLS
    CALLS += 1
    return result


# ---------------------------------------------------------------------------
# batch wire-format codecs (native; None when unavailable)
# ---------------------------------------------------------------------------


def encode_dense_batch(ids: np.ndarray, values: np.ndarray) -> Optional[bytes]:
    lib = library()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    n, dim = values.shape
    out_len = ctypes.c_int64()
    p = lib.rdf_encode_dense_batch(ids, values, n, dim,
                                   ctypes.byref(out_len))
    if not p:
        return None
    try:
        return _counted(ctypes.string_at(p, out_len.value))
    finally:
        lib.rdf_free_buf(p)


def decode_dense_batch(buf: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = library()
    if lib is None:
        return None
    n = ctypes.c_int64()
    dim = ctypes.c_int64()
    h = lib.rdf_decode_dense_batch(buf, len(buf), ctypes.byref(n),
                                   ctypes.byref(dim))
    if not h:
        return None
    try:
        ids = np.empty(n.value, dtype=np.int32)
        values = np.empty((n.value, dim.value), dtype=np.float64)
        lib.rdf_copy_dense_batch(h, ids, values)
        return _counted((ids, values))
    finally:
        lib.rdf_free_dense_batch(h)


def encode_sparse_batch(
    ids: np.ndarray, size: int, idx: np.ndarray, val: np.ndarray,
    nnz: np.ndarray,
) -> Optional[bytes]:
    lib = library()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float64)
    nnz = np.ascontiguousarray(nnz, dtype=np.int32)
    n, max_nnz = idx.shape
    out_len = ctypes.c_int64()
    p = lib.rdf_encode_sparse_batch(ids, size, idx, val, nnz, n, max_nnz,
                                    ctypes.byref(out_len))
    if not p:
        return None
    try:
        return _counted(ctypes.string_at(p, out_len.value))
    finally:
        lib.rdf_free_buf(p)


def decode_sparse_batch(
    buf: bytes,
) -> Optional[Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]]:
    lib = library()
    if lib is None:
        return None
    n = ctypes.c_int64()
    size = ctypes.c_int64()
    max_nnz = ctypes.c_int64()
    h = lib.rdf_decode_sparse_batch(buf, len(buf), ctypes.byref(n),
                                    ctypes.byref(size), ctypes.byref(max_nnz))
    if not h:
        return None
    try:
        ids = np.empty(n.value, dtype=np.int32)
        idx = np.empty((n.value, max_nnz.value), dtype=np.int32)
        val = np.empty((n.value, max_nnz.value), dtype=np.float64)
        nnz = np.empty(n.value, dtype=np.int32)
        lib.rdf_copy_sparse_batch(h, ids, idx.reshape(-1), val.reshape(-1),
                                  nnz)
        return _counted((ids, int(size.value), idx, val, nnz))
    finally:
        lib.rdf_free_sparse_batch(h)


def load_dense_file(
    path: str, limit: Optional[int] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Returns (ids, values) or None when the native path is unavailable."""
    lib = library()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    dim = ctypes.c_int64()
    h = lib.rdf_parse_dense_file(
        path.encode(), ctypes.c_int64(limit or -1),
        ctypes.byref(rows), ctypes.byref(dim),
    )
    if not h:
        return None
    try:
        n, d = rows.value, dim.value
        if n == 0 or d == 0:
            return None
        ids = np.empty(n, dtype=np.int32)
        values = np.empty((n, d), dtype=np.float32)
        lib.rdf_copy_dense(h, ids, values.reshape(-1))
        return _counted((ids, values))
    finally:
        lib.rdf_free_dense(h)


def load_sparse_file(
    path: str, limit: Optional[int] = None, nnz_pad: Optional[int] = None
) -> Optional[Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Returns (ids, size, indices, values, lengths) or None."""
    lib = library()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    max_nnz = ctypes.c_int64()
    size = ctypes.c_int64()
    h = lib.rdf_parse_sparse_file(
        path.encode(), ctypes.c_int64(limit or -1),
        ctypes.byref(rows), ctypes.byref(max_nnz), ctypes.byref(size),
    )
    if not h:
        return None
    try:
        n = rows.value
        if n == 0:
            return None
        pad = int(nnz_pad or max(1, max_nnz.value))
        if max_nnz.value > pad:
            return None  # caller's pad too small: let python path error out
        ids = np.empty(n, dtype=np.int32)
        idx = np.zeros((n, pad), dtype=np.int32)
        val = np.zeros((n, pad), dtype=np.float32)
        lengths = np.empty(n, dtype=np.int32)
        lib.rdf_copy_sparse(h, ids, idx.reshape(-1), val.reshape(-1), lengths,
                            ctypes.c_int64(pad))
        return _counted((ids, int(size.value), idx, val, lengths))
    finally:
        lib.rdf_free_sparse(h)
