"""Sparse front end: the `SparsevectorRDFInit` method surface.

Counterpart of `similaritysearchbyrdf_tpu/deploy/sparse.py`
(`deploy/SparsevectorRDFInit.scala:51-553`, the mirror of the dense front
end for SparseVector data): init, fit from a file or a batch, query by key
or by vectors, ground truth, precision scoring, distributions and teardown,
with camelCase aliases. It keeps the reference's two ways of resolving a
repeated id: a single-key query takes the first matching row, a batch query
the last (through its dict).

One fault of the JAX package is not copied: it takes the -1 that pads a
result or a row as "no id", so a negative user id (the reference's ids are
any Long) drops out of key-query lists, precision and the dataTable
distribution. Here a result is present where its score is finite, and the
live rows are those the tables hold.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..index.partitioner import hash_partition
from ..index.sparse_forest import SparseRDFForest
from ..models.families import Device, resolve_device
from ..vectors import SparseBatch, load_ground_truth, load_sparse_file


def _present(ids: np.ndarray, scores: np.ndarray) -> List[int]:
    """A result row's ids, padding (score -inf) left out."""
    return [int(i) for i, s in zip(ids, scores) if np.isfinite(s)]


class SparseRDFInit:
    """Stateful front end over `SparseRDFForest` with the reference's method
    names, on `device` (default: the first CUDA card)."""

    def __init__(self, device: Device = None) -> None:
        self.device = resolve_device(device)
        self.forest: Optional[SparseRDFForest] = None
        self.conf: Optional[RDFConfig] = None
        self._all_vectors: Optional[SparseBatch] = None

    # -- init (`initializeRDFHashMap`, SparsevectorRDFInit.scala:51-115) ---
    def initialize_rdf_hash_map(self, conf: RDFConfig) -> None:
        self.conf = conf
        self.forest = SparseRDFForest(conf, device=self.device)

    initializeRDFHashMap = initialize_rdf_hash_map

    def _require(self) -> SparseRDFForest:
        if self.forest is None:
            raise RuntimeError("initializeRDFHashMap must be called first")
        return self.forest

    def _top_k(self) -> int:
        return self.conf.top_k if self.conf else 10

    # -- fit (`newFastFit` :124-160 / `newMultiThreadFit` :164-200) --------
    def new_fast_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                     limit: Optional[int] = None, nnz_pad: Optional[int] = None) -> SparseBatch:
        """Parse a sparse vector file and build the index; returns the parsed
        batch. Rows pad to `nnz_pad`, else the config's `sparse_nnz_pad`."""
        if conf is not None and self.forest is None:
            self.initialize_rdf_hash_map(conf)
        forest = self._require()
        batch = load_sparse_file(file_name, limit=limit,
                                 nnz_pad=nnz_pad or (self.conf.sparse_nnz_pad
                                                     if self.conf else None))
        forest.fit(batch)
        self._all_vectors = batch
        return batch

    newFastFit = new_fast_fit

    def new_multi_thread_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                             limit: Optional[int] = None) -> SparseBatch:
        """`new_fast_fit`: one batched fit serves the reference's threaded one."""
        return self.new_fast_fit(file_name, conf, limit)

    newMultiThreadFit = new_multi_thread_fit

    def fit_batch(self, batch: SparseBatch) -> None:
        self._require().fit(batch)
        self._all_vectors = batch

    # -- query --------------------------------------------------------------
    def query_single_key(self, key: int, steps: int = 0) -> Optional[List[int]]:
        """Candidate ids of one fitted vector id (its first row), itself
        excluded; None for an unknown key."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return None
        row = np.flatnonzero(self._all_vectors.ids == key)
        if len(row) == 0:
            return None
        sub = self._all_vectors.slice(int(row[0]), int(row[0]) + 1)
        ids, scores = forest.query(sub, steps=steps, query_ids=np.array([key], dtype=np.int32),
                                   k=self._top_k())
        return _present(ids[0], scores[0])

    querySingleKey = query_single_key

    def query_batch(self, keys: Sequence[int], steps: int = 0) -> List[List[int]]:
        """Batch query by key in one batched query, in the caller's order (a
        repeated id resolves to its last row); an unknown key gives []."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return [[] for _ in keys]
        av = self._all_vectors
        keys_arr = np.asarray(list(keys), dtype=np.int64)
        id_to_row = {int(v): i for i, v in enumerate(av.ids)}
        rows = np.asarray([id_to_row.get(int(k), -1) for k in keys_arr])
        found = rows >= 0
        if not found.any():
            return [[] for _ in keys_arr]
        ids, scores = forest.query(av.take(rows[found]), steps=steps,
                                   query_ids=keys_arr[found].astype(np.int32), k=self._top_k())
        hits = iter(zip(ids, scores))
        return [_present(*next(hits)) if ok else [] for ok in found]

    queryBatch = query_batch

    def new_multi_thread_query_batch(self, query_ids, queries: SparseBatch, steps: int = 0,
                                     k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Batched query by sparse vectors → (ids [Q, k], scores [Q, k])."""
        return self._require().query(queries, steps=steps,
                                     query_ids=np.asarray(query_ids, dtype=np.int32), k=k)

    NewMultiThreadQueryBatch = new_multi_thread_query_batch

    # -- evaluation (`topKAndPrecisionScore` :458-501) ----------------------
    def get_top_k_ground_truth(self, filename: str, k: int) -> List[Set[int]]:
        return [set(int(x) for x in row) for row in load_ground_truth(filename, k)]

    getTopKGroundTruth = get_top_k_ground_truth

    def top_k_and_precision_score(self, all_vectors: SparseBatch,
                                  ground_truth: Sequence[Set[int]],
                                  conf: Optional[RDFConfig] = None, steps: int = 0
                                  ) -> Tuple[np.ndarray, float, float]:
        """Query the first len(ground_truth) vectors and score precision@topK
        against the ground truth → (ids [Q, k], precision, elapsed ms)."""
        conf = conf or self.conf or RDFConfig()
        q = len(ground_truth)
        t0 = time.perf_counter()
        ids, scores = self.new_multi_thread_query_batch(all_vectors.ids[:q],
                                                        all_vectors.slice(0, q), steps=steps,
                                                        k=conf.top_k)
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        score = sum(len(set(_present(ids[i], scores[i])) & ground_truth[i]) / conf.top_k
                    for i in range(q))
        return ids, score / q, elapsed_ms

    topKAndPrecisionScore = top_k_and_precision_score

    # -- introspection (`getDtAndHtNumDistribution` :505-530) ---------------
    def get_dt_and_ht_num_distribution(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dataTable, hashTable) objects per sub-index: the dataTable by the
        HashPartitioner's modulo, abs(id) % numPartitions
        (`utils/Partitioner.scala:14-18`), the hash tables by the mean over
        tables of the partition distribution."""
        forest = self._require()
        if forest.state is None or self.conf is None:
            raise RuntimeError("need to fit the data first")
        ndp = self.conf.num_data_partitions
        dt = torch.bincount(hash_partition(forest.live_ids(), ndp).long(), minlength=ndp)
        ht = forest.sub_index_distribution().mean(axis=0)
        return dt.cpu().numpy().astype(np.float64), ht.astype(np.float64)

    getDtAndHtNumDistribution = get_dt_and_ht_num_distribution

    def clear_and_close(self) -> None:
        self.forest = None
        self._all_vectors = None

    clearAndClose = clear_and_close
