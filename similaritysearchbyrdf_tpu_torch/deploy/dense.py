"""Dense front end: the `DensevectorRDFInit` method surface.

Counterpart of `similaritysearchbyrdf_tpu/deploy/dense.py`, method for
method (`deploy/DensevectorRDFInit.scala:50-557`): init, fit from a file or
a batch (the reference's single- and multi-threaded fits are one batched
fit), query by key or by vector, ground truth, precision scoring,
distributions and teardown, with camelCase aliases. An object holds the
state the reference keeps in a singleton.

Key lookups go through an id index built once at fit time (the fitted ids
sorted on the device, found by `torch.searchsorted`), so a batch of keys
costs a binary search, not a pass over every fitted id.

One fault of the JAX package is not copied, as in `deploy/sparse.py`: it
takes the -1 that pads a result or a row as "no id", so a negative user id
drops out of key-query lists, precision and the dataTable distribution.
Here a result is present where its score is finite, and the live rows are
those the index holds.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..index.forest import RDFForest
from ..index.partitioner import hash_partition
from ..models.families import Device, resolve_device
from ..ops.flat import FlatIndex
from ..vectors import DenseBatch, load_dense_file, load_ground_truth


class _FlatEngineAdapter:
    """RDFForest-shaped facade over `FlatIndex`, so the front end runs on
    the quantized flat engine (`conf.engine = "flat"`). The forest's pruning
    knobs (`steps`, probe modes, candidate caps) are accepted and ignored:
    the flat engine scores every row."""

    def __init__(self, conf: RDFConfig, device: Device = None) -> None:
        self.conf = conf
        self.index = FlatIndex(device=device)
        self.device = self.index.device
        self.state: Optional[FlatIndex] = None        # the front end's "fitted" check

    def fit(self, batch: DenseBatch) -> "_FlatEngineAdapter":
        self.index.fit(batch)
        self.state = self.index
        return self

    def query(self, queries, steps: int = 0, query_ids=None, k=None, **_):
        return self.index.query(queries, k=k or self.conf.top_k, query_ids=query_ids,
                                exclude_self=query_ids is not None)

    def live_ids(self) -> torch.Tensor:
        """The fitted user ids, every row live whatever its id's sign."""
        if self.index.row_ids is None:
            raise RuntimeError("need to fit the data first")
        return self.index.row_ids

    def size(self) -> int:
        return 0 if self.index.row_ids is None else int(self.index.row_ids.shape[0])

    def sub_index_distribution(self):
        raise RuntimeError("sub-index distribution is a forest concept; use engine='forest'")


def _present(ids: np.ndarray, scores: np.ndarray) -> List[int]:
    """A result row's ids, padding (score -inf) left out."""
    return [int(i) for i, s in zip(ids, scores) if np.isfinite(s)]


class DenseRDFInit:
    """Stateful front end over `RDFForest` (or the flat engine) with the
    reference's method names, on `device` (default: the first CUDA card).
    The reference's `vectorIdToVector` dataTable is the fitted batch; its
    `vectorDatabase` is the forest's bucket tables."""

    def __init__(self, device: Device = None) -> None:
        self.device = resolve_device(device)
        self.forest = None
        self.conf: Optional[RDFConfig] = None
        self._all_vectors: Optional[DenseBatch] = None
        self._sorted_ids: Optional[torch.Tensor] = None    # int64, ascending
        self._id_rows: Optional[torch.Tensor] = None       # their rows in the batch

    # -- init (`initializeRDFHashMap`, DensevectorRDFInit.scala:50-118) ----
    def initialize_rdf_hash_map(self, conf: RDFConfig) -> None:
        self.conf = conf
        if conf.engine == "flat":
            self.forest = _FlatEngineAdapter(conf, self.device)
        else:
            self.forest = RDFForest(conf, device=self.device)

    initializeRDFHashMap = initialize_rdf_hash_map

    def _require(self):
        if self.forest is None:
            raise RuntimeError("initializeRDFHashMap must be called first")
        return self.forest

    # -- fit (`newFastFit` :127-151 / `newMultiThreadFit` :161-206) --------
    def new_fast_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                     limit: Optional[int] = None) -> DenseBatch:
        """Parse a `[id,[v...]]` file and build the index; returns the
        parsed batch (the reference returns Array[DenseVector])."""
        if conf is not None and self.forest is None:
            self.initialize_rdf_hash_map(conf)
        batch = load_dense_file(file_name, limit=limit)
        self.fit_batch(batch)
        return batch

    newFastFit = new_fast_fit

    def new_multi_thread_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                             limit: Optional[int] = None) -> DenseBatch:
        """`new_fast_fit`: every table is hashed in one batched pass, so the
        reference's thread-per-table-range fit (`:161-206`) has no separate
        path."""
        return self.new_fast_fit(file_name, conf, limit)

    newMultiThreadFit = new_multi_thread_fit

    def fit_batch(self, batch: DenseBatch) -> None:
        """Fit on a batch (numpy values or a tensor) and index its ids."""
        forest = self._require()
        forest.fit(batch)
        self._all_vectors = batch
        ids = torch.as_tensor(batch.ids).to(forest.device, torch.int64)
        self._sorted_ids, self._id_rows = torch.sort(ids, stable=True)

    # -- query (`querySingleKey` :284-302 / `queryBatch` :311-317 /
    #           `NewMultiThreadQueryBatch` :335-399 / `query` :533-557) ----
    def _top_k(self) -> int:
        return self.conf.top_k if self.conf else 10

    def _rows_of(self, keys: np.ndarray) -> torch.Tensor:
        """Row of each key in the fitted batch, -1 when absent (a repeated id
        resolves to its last row), on the forest's device."""
        k = torch.as_tensor(keys, dtype=torch.int64).to(self._sorted_ids.device)
        pos = (torch.searchsorted(self._sorted_ids, k, right=True) - 1).clamp(min=0)
        hit = self._sorted_ids[pos] == k
        return torch.where(hit, self._id_rows[pos], -1)

    def _vectors(self, rows: torch.Tensor):
        values = self._all_vectors.values
        if isinstance(values, torch.Tensor):
            return values[rows.to(values.device)]
        return values[rows.cpu().numpy()]

    def query_single_key(self, key: int, steps: int = 0) -> Optional[List[int]]:
        """Candidate ids of one fitted vector id, itself excluded; None for an
        unknown key."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return None
        rows = self._rows_of(np.asarray([key]))
        if int(rows[0]) < 0:
            return None
        ids, scores = forest.query(self._vectors(rows), steps=steps,
                                   query_ids=np.asarray([key], dtype=np.int32), k=self._top_k())
        return _present(ids[0], scores[0])

    querySingleKey = query_single_key

    def query_batch(self, keys: Sequence[int], steps: int = 0) -> List[List[int]]:
        """Batch query by key (`queryBatch`, `:311-317`): the known keys go
        through one batched query, in the caller's order; an unknown key
        gives []."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return [[] for _ in keys]
        keys_arr = np.asarray(list(keys), dtype=np.int64)
        rows = self._rows_of(keys_arr)
        found = (rows >= 0).cpu().numpy()
        if not found.any():
            return [[] for _ in keys_arr]
        ids, scores = forest.query(self._vectors(rows[rows >= 0]), steps=steps,
                                   query_ids=keys_arr[found].astype(np.int32), k=self._top_k())
        hits = iter(zip(ids, scores))
        return [_present(*next(hits)) if ok else [] for ok in found]

    queryBatch = query_batch

    def new_multi_thread_query_batch(self, query_ids, query_vectors, steps: int = 0,
                                     k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Batched query by raw vectors (`NewMultiThreadQueryBatch` /
        `threadQueryNew`, `:335-399`) → (ids [Q, k], scores [Q, k])."""
        return self._require().query(query_vectors, steps=steps, query_ids=query_ids, k=k)

    NewMultiThreadQueryBatch = new_multi_thread_query_batch

    def query(self, query_ids, query_vectors, steps: int = 0, k: Optional[int] = None):
        return self.new_multi_thread_query_batch(query_ids, query_vectors, steps, k)

    # -- evaluation (`topKAndPrecisionScore` :472-507, GT loader :440-447) --
    def get_top_k_ground_truth(self, filename: str, k: int) -> List[Set[int]]:
        return [set(int(x) for x in row) for row in load_ground_truth(filename, k)]

    getTopKGroundTruth = get_top_k_ground_truth

    def top_k_and_precision_score(self, all_dense_vectors: DenseBatch,
                                  ground_truth: Sequence[Set[int]],
                                  conf: Optional[RDFConfig] = None, steps: int = 0
                                  ) -> Tuple[np.ndarray, float, float]:
        """Query the first len(ground_truth) vectors and score precision@topK
        against the ground truth → (ids [Q, k], precision, elapsed ms), as
        the sparse front end of the reference returns
        (`SparsevectorRDFInit.scala:458-501`)."""
        conf = conf or self.conf or RDFConfig()
        q = len(ground_truth)
        t0 = time.perf_counter()
        ids, scores = self.new_multi_thread_query_batch(
            all_dense_vectors.ids[:q], all_dense_vectors.values[:q], steps=steps,
            k=conf.top_k)
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        score = sum(len(set(_present(ids[i], scores[i])) & ground_truth[i]) / conf.top_k
                    for i in range(q))
        return ids, score / q, elapsed_ms

    topKAndPrecisionScore = top_k_and_precision_score

    # -- introspection (`getDtAndHtNumDistribution` :515-530) ---------------
    def get_dt_and_ht_num_distribution(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dataTable, hashTable) objects per sub-index: the dataTable by the
        HashPartitioner's modulo (`utils/Partitioner.scala:14-18`), the hash
        tables by the mean over tables of the partition distribution."""
        forest = self._require()
        if forest.state is None or self.conf is None:
            raise RuntimeError("need to fit the data first")
        ndp = self.conf.num_data_partitions
        dt = torch.bincount(hash_partition(forest.live_ids(), ndp).long(), minlength=ndp)
        ht = forest.sub_index_distribution().mean(axis=0)
        return dt.cpu().numpy().astype(np.float64), ht.astype(np.float64)

    getDtAndHtNumDistribution = get_dt_and_ht_num_distribution

    # -- teardown (`clearAndClose` :453-458) --------------------------------
    def clear_and_close(self) -> None:
        self.forest = None
        self._all_vectors = None
        self._sorted_ids = self._id_rows = None

    clearAndClose = clear_and_close
