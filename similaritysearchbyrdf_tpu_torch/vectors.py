"""Vector types and dataset text parsers.

A copy of `similaritysearchbyrdf_tpu/vectors.py` (the replacement for the
reference's vector layer, `src/main/scala/mclab/lsh/vector/Vector.scala`),
which is framework-free: vectors live in batches, a dense batch one `[N, D]`
array, a sparse batch padded `[N, nnz_pad]` index/value arrays plus per-row
lengths. One change: a `DenseBatch` keeps torch tensors (values and ids) as
they are, and a `SparseBatch` its indices and values, so a corpus already on
the GPU is not copied through the host. The
native C++ parser (`native/`, built with g++ on first use) reads dense files
when it is built; the pure-Python parsers run otherwise.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .native import loader as native_loader


# ---------------------------------------------------------------------------
# Batch types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenseBatch:
    """A batch of dense vectors: ids `[N]` int32, values `[N, D]` float32.

    Replaces the reference's per-object `DenseVector(vectorId, values)`
    (`Vector.scala:353-364`).
    """

    ids: np.ndarray
    values: np.ndarray

    def __post_init__(self) -> None:
        # a torch tensor (e.g. a corpus already on the GPU) passes through
        # without a host round trip, cast to i32 / f32 where it lives
        if isinstance(self.ids, torch.Tensor):
            self.ids = self.ids.to(torch.int32)
        else:
            self.ids = np.asarray(self.ids, dtype=np.int32)
        if isinstance(self.values, torch.Tensor):
            self.values = self.values.to(torch.float32)
        else:
            self.values = np.asarray(self.values, dtype=np.float32)
        assert self.values.ndim == 2 and self.ids.shape[0] == self.values.shape[0]

    @property
    def n(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[1])

    def __len__(self) -> int:
        return self.n

    def slice(self, start: int, stop: int) -> "DenseBatch":
        return DenseBatch(self.ids[start:stop], self.values[start:stop])


@dataclasses.dataclass
class SparseBatch:
    """A batch of sparse vectors in padded COO-row layout.

    Replaces the reference's `SparseVector(id, size, indices, values)`
    (`Vector.scala:374-417`). Rows are padded to `nnz_pad` with index 0 /
    value 0.0; `lengths[i]` is the true nnz of row i (padding values are 0 so
    dot products are unaffected even unmasked).
    """

    ids: np.ndarray        # [N] int32
    size: int              # dimensionality (the reference's `size`)
    indices: np.ndarray    # [N, nnz_pad] int32
    values: np.ndarray     # [N, nnz_pad] float32
    lengths: np.ndarray    # [N] int32

    def __post_init__(self) -> None:
        self.ids = _host(self.ids, np.int32)
        # torch tensors (rows already on the GPU) pass through without a
        # host round trip, cast to i32 / f32 where they live; indices and
        # values are taken independently, so a mixed host/device pair keeps
        # each half where it is
        if isinstance(self.indices, torch.Tensor):
            self.indices = self.indices.to(torch.int32)
        else:
            self.indices = np.asarray(self.indices, dtype=np.int32)
        if isinstance(self.values, torch.Tensor):
            self.values = self.values.to(torch.float32)
        else:
            self.values = np.asarray(self.values, dtype=np.float32)
        self.lengths = _host(self.lengths, np.int32)

    @property
    def n(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz_pad(self) -> int:
        return int(self.indices.shape[1])

    def __len__(self) -> int:
        return self.n

    def slice(self, start: int, stop: int) -> "SparseBatch":
        return SparseBatch(
            self.ids[start:stop], self.size, self.indices[start:stop],
            self.values[start:stop], self.lengths[start:stop],
        )

    def take(self, rows: np.ndarray) -> "SparseBatch":
        """The batch of the given rows, in their order (tensor rows stay on
        their device)."""
        def pick(a):
            if isinstance(a, torch.Tensor):
                return a[torch.as_tensor(rows, device=a.device)]
            return a[rows]

        return SparseBatch(self.ids[rows], self.size, pick(self.indices), pick(self.values),
                           self.lengths[rows])

    def densify(self) -> DenseBatch:
        out = np.zeros((self.n, self.size), dtype=np.float32)
        rows = np.repeat(np.arange(self.n), self.nnz_pad)
        mask = (np.arange(self.nnz_pad)[None, :] < self.lengths[:, None]).ravel()
        out[rows[mask], self.indices.ravel()[mask]] = self.values.ravel()[mask]
        return DenseBatch(self.ids, out)


def _host(a, dtype) -> np.ndarray:
    """A numpy array of `a` (a tensor comes to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def sparse_batch_from_rows(
    ids: Sequence[int],
    size: int,
    rows: Sequence[Tuple[Sequence[int], Sequence[float]]],
    nnz_pad: Optional[int] = None,
) -> SparseBatch:
    """Pack per-row (indices, values) into a padded :class:`SparseBatch`."""
    n = len(rows)
    lengths = np.array([len(r[0]) for r in rows], dtype=np.int32)
    pad = int(nnz_pad) if nnz_pad is not None else int(max(1, lengths.max(initial=1)))
    if lengths.max(initial=0) > pad:
        raise ValueError(f"nnz_pad={pad} smaller than max row nnz {lengths.max()}")
    idx = np.zeros((n, pad), dtype=np.int32)
    val = np.zeros((n, pad), dtype=np.float32)
    for i, (ri, rv) in enumerate(rows):
        k = len(ri)
        idx[i, :k] = ri
        val[i, :k] = rv
    return SparseBatch(np.asarray(ids, np.int32), size, idx, val, lengths)


# ---------------------------------------------------------------------------
# Text parsers (one per reference format, `Vector.scala:162-321`)
# ---------------------------------------------------------------------------


def from_string(line: str) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Parse `(id,size,[i0,i1,...],[v0,v1,...])` — ref `Vectors.fromString`
    (`Vector.scala:162-175`)."""
    parts = line.split(",[")
    if len(parts) != 3:
        raise ValueError(f"cannot parse {line!r}")
    vid_s, size_s = parts[0].replace("(", "").split(",")
    idx_s = parts[1].replace("]", "").split(",")
    val_s = parts[2].replace("])", "").split(",")
    indices = np.array([int(x) for x in idx_s if x != ""], dtype=np.int32)
    values = np.array([float(x) for x in val_s if x != ""], dtype=np.float64)
    return int(vid_s), int(size_s), indices, values


def from_string_dense(line: str) -> np.ndarray:
    """Parse `v0,v1,v2,...` — ref `Vectors.fromStringDense`
    (`Vector.scala:179-187`)."""
    return np.array([float(x) for x in line.split(",")], dtype=np.float64)


def from_python_string(line: str) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Parse `[id, size, [i...], [v...]]` — ref `Vectors.fromPythonString`
    (`Vector.scala:194-208`)."""
    s = line.replace(" ", "")
    parts = s.split(",[")
    if len(parts) != 3:
        raise ValueError(f"cannot parse {line!r}")
    vid_s, size_s = parts[0].replace("[", "").split(",")
    idx_s = parts[1].replace("]", "").split(",")
    val_s = parts[2].replace("]]", "").split(",")
    indices = np.array([int(x) for x in idx_s if x != ""], dtype=np.int32)
    values = np.array([float(x) for x in val_s if x != ""], dtype=np.float64)
    return int(vid_s), int(size_s), indices, values


def parse_dense(line: str) -> Tuple[int, np.ndarray]:
    """Parse `[id,[v0,v1,...]]` — ref `Vectors.parseDense`
    (`Vector.scala:215-219`)."""
    s = line.replace(" ", "").replace("[", "").replace("]", "")
    arr = s.split(",")
    return int(arr[0]), np.array([float(x) for x in arr[1:]], dtype=np.float64)


def whole_new_gt_from_python(line: str) -> Tuple[int, str]:
    """Parse `index videoName E` — ref `Vectors.wholeNewGTFromPython`
    (`Vector.scala:228-236`)."""
    parts = line.split(" ")
    if len(parts) != 3:
        raise ValueError(f"cannot parse {line!r}")
    return int(parts[0]), parts[1]


def es_from_python(line: str) -> Tuple[int, int, int, np.ndarray, np.ndarray]:
    """Parse `total#E#S#[e...]#[s...]` — ref `Vectors.ESfromPython`
    (`Vector.scala:244-257`)."""
    parts = line.split("#")
    if len(parts) != 5:
        raise ValueError(f"cannot parse {line!r}")
    total, e_num, s_num = int(parts[0]), int(parts[1]), int(parts[2])

    def _ints(s: str) -> np.ndarray:
        s = s.replace(" ", "").replace("[", "").replace("]", "")
        return np.array([int(x) for x in s.split(",") if x], dtype=np.int32)

    e_part, s_part = _ints(parts[3]), _ints(parts[4])
    if len(e_part) != e_num or len(s_part) != s_num:
        raise ValueError(f"{line!r} has errors")
    return total, e_num, s_num, e_part, s_part


def knn_from_python(k: int, line: str) -> np.ndarray:
    """Parse top-K NN distances `[d0,d1,...]` — ref `Vectors.KNNFromPython`
    (`Vector.scala:266-275`)."""
    toks = line.replace(" ", "").split(",")
    if k > len(toks):
        raise ValueError(f"cannot parse {line!r}")
    return np.array(
        [float(t.replace("[", "").replace("]", "")) for t in toks[:k]],
        dtype=np.float64,
    )


def analysis_knn(line: str, k: int) -> np.ndarray:
    """Parse top-K NN ids `[i0,i1,...]` — ref `Vectors.analysisKNN`
    (`Vector.scala:284-293`)."""
    toks = line.replace(" ", "").split(",")
    if k > len(toks):
        raise ValueError(f"cannot parse {line!r}")
    return np.array(
        [int(t.replace("[", "").replace("]", "")) for t in toks[:k]], dtype=np.int32
    )


def parse_numeric(value) -> Tuple[str, tuple]:
    """Polymorphic parse — ref `Vectors.parseNumeric` (`Vector.scala:300-321`).
    Returns ("dense", (values,)) or ("sparse", (id, size, indices, values))."""
    if isinstance(value, np.ndarray) or (
        isinstance(value, (list, tuple)) and value and isinstance(value[0], float)
    ):
        return "dense", (np.asarray(value, dtype=np.float64),)
    if isinstance(value, str):
        try:
            return "sparse", from_string(value)
        except Exception:
            return "dense", (from_string_dense(value),)
    raise ValueError(f"Cannot parse {value!r}.")


# ---------------------------------------------------------------------------
# File loaders
# ---------------------------------------------------------------------------


def load_dense_file(
    path: str, limit: Optional[int] = None, use_native: bool = True
) -> DenseBatch:
    """Load a file of `[id,[v...]]` lines (the reference's dense fit input,
    `DensevectorRDFInit.newFastFit` → `Vectors.parseDense`)."""
    if use_native:
        out = native_loader.load_dense_file(path, limit)
        if out is not None:
            return DenseBatch(*out)
    ids: List[int] = []
    rows: List[np.ndarray] = []
    with open(path, "r") as f:
        for line in itertools.islice(f, limit):
            line = line.strip()
            if not line:
                continue
            vid, vals = parse_dense(line)
            ids.append(vid)
            rows.append(vals)
    return DenseBatch(np.array(ids, np.int32), np.stack(rows).astype(np.float32))


def load_sparse_file(
    path: str,
    limit: Optional[int] = None,
    nnz_pad: Optional[int] = None,
    fmt: str = "auto",
) -> SparseBatch:
    """Load `(id,size,[i...],[v...])` or python-style sparse lines
    (the reference's sparse fit input, `SparsevectorRDFInit.scala:124-160`)."""
    ids: List[int] = []
    rows: List[Tuple[np.ndarray, np.ndarray]] = []
    size = 0
    with open(path, "r") as f:
        for line in itertools.islice(f, limit):
            line = line.strip()
            if not line:
                continue
            if fmt == "python" or (fmt == "auto" and line.startswith("[")):
                vid, sz, idx, val = from_python_string(line)
            else:
                vid, sz, idx, val = from_string(line)
            ids.append(vid)
            size = max(size, sz)
            rows.append((idx, val))
    return sparse_batch_from_rows(ids, size, rows, nnz_pad)


def load_ground_truth(path: str, k: int) -> np.ndarray:
    """Load a ground-truth file (one `[i0,i1,...]` line per query) into an
    `[Q, k]` int32 array — ref `DensevectorRDFInit.getTopKGroundTruth`
    (`DensevectorRDFInit.scala:440-447`)."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(analysis_knn(line, k))
    return np.stack(rows)


def read_fvecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Read the standard .fvecs binary format (SIFT/GloVe distributions).
    Not in the reference; added because BASELINE.json configs use SIFT-1M."""
    if limit is None:
        data = np.fromfile(path, dtype=np.int32)
    else:
        # peek dim from the first record, then read exactly `limit` records
        with open(path, "rb") as f:
            dim = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
        data = np.fromfile(path, dtype=np.int32, count=limit * (dim + 1))
    dim = int(data[0])
    data = data.reshape(-1, dim + 1)
    return data[:, 1:].view(np.float32).copy()


def read_ivecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    data = np.fromfile(path, dtype=np.int32)
    dim = int(data[0])
    data = data.reshape(-1, dim + 1)
    out = data[:, 1:].copy()
    return out[:limit] if limit is not None else out
