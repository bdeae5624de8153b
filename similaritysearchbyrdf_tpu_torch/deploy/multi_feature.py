"""Multi-feature front end: the reference's `HashTableInit` capability.

Counterpart of `similaritysearchbyrdf_tpu/deploy/multi_feature.py`, dense
only. The reference's multi-feature layer (`deploy/HashTableInit.scala:
173-462`) keeps parallel table families (blue / green / red, e.g. HSV
channels) and unions candidates across them (`multiFeatureSingleQuery`,
`:321-345`). Here each family is one forest over its own feature space, and
a query merges the families' top-k by the weighted sum of their scores.
The merge runs on the host, as in the JAX package, over the families'
small top-k lists, so both return the same ids.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import RDFConfig
from ..index.forest import RDFForest
from ..models.families import Device, resolve_device
from ..vectors import DenseBatch


class MultiFeatureRDFInit:
    """N named feature families, each with its own forest on `device`
    (default: the first CUDA card)."""

    def __init__(self, feature_names: Sequence[str] = ("blue", "green", "red"),
                 device: Device = None):
        self.feature_names = list(feature_names)
        self.device = resolve_device(device)
        self.forests: Dict[str, RDFForest] = {}
        self.confs: Dict[str, RDFConfig] = {}

    # -- init (`initializeMapDBHashMultiple`, HashTableInit.scala:173-254) --
    def initialize_multiple(self, confs: Dict[str, RDFConfig]) -> None:
        for name in self.feature_names:
            self.confs[name] = confs[name]
            self.forests[name] = RDFForest(confs[name], device=self.device)

    initializeMapDBHashMultiple = initialize_multiple

    # -- fit (`newMultiFastFit`, HashTableInit.scala:414-462) ---------------
    def new_multi_fast_fit(self, batches: Dict[str, DenseBatch]) -> None:
        """Fit every family; the ids agree across families (the reference
        inserts each key into every table set)."""
        for name in self.feature_names:
            self.forests[name].fit(batches[name])

    newMultiFastFit = new_multi_fast_fit

    # -- query (`multiFeatureSingleQuery`, HashTableInit.scala:321-345) -----
    def multi_feature_query(self, queries: Dict[str, np.ndarray], steps: int = 0, k: int = 10,
                            query_ids: Optional[np.ndarray] = None,
                            weights: Optional[Dict[str, float]] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Query every family for max(4k, 32) results and merge: the union of
        their ids ranked by the weighted sum of per-family scores → (ids
        [Q, k], scores [Q, k])."""
        weights = weights or {n: 1.0 for n in self.feature_names}
        per_family: List[Tuple[np.ndarray, np.ndarray]] = []
        for name in self.feature_names:
            ids, scores = self.forests[name].query(queries[name], steps=steps,
                                                   query_ids=query_ids, k=max(k * 4, 32))
            per_family.append((ids, scores * weights.get(name, 1.0)))
        return merge_families(per_family, k)

    multiFeatureSingleQuery = multi_feature_query

    def multi_feature_batch_query(self, queries, steps=0, k=10, query_ids=None):
        return self.multi_feature_query(queries, steps, k, query_ids)

    def clear_and_close(self) -> None:
        self.forests.clear()

    clearAndClose = clear_and_close


def merge_families(per_family: List[Tuple[np.ndarray, np.ndarray]], k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per row: sort the concatenated (id, score) pairs by id, sum the
    scores of equal ids (cumsum differences at run boundaries), keep the
    top k sums. The JAX package's merge, step for step."""
    ids = np.concatenate([i for i, _ in per_family], axis=1)      # [Q, M]
    scores = np.concatenate([s for _, s in per_family], axis=1)
    q, m = ids.shape
    valid = (ids >= 0) & np.isfinite(scores)
    big = np.iinfo(np.int32).max
    key = np.where(valid, ids, big)
    sc = np.where(valid, scores, 0.0).astype(np.float64)
    order = np.argsort(key, axis=1, kind="stable")
    ids_s = np.take_along_axis(key, order, axis=1)
    sc_s = np.take_along_axis(sc, order, axis=1)
    csum = np.cumsum(sc_s, axis=1)
    is_first = np.concatenate([np.ones((q, 1), bool), ids_s[:, 1:] != ids_s[:, :-1]], axis=1)
    is_last = np.concatenate([ids_s[:, 1:] != ids_s[:, :-1], np.ones((q, 1), bool)], axis=1)
    col = np.broadcast_to(np.arange(m), (q, m))
    first_idx = np.maximum.accumulate(np.where(is_first, col, 0), axis=1)
    base = np.take_along_axis(csum - sc_s, first_idx, axis=1)
    gsum = np.where(is_last & (ids_s != big), csum - base, -np.inf)
    kk = min(k, m)
    top = np.argpartition(-gsum, kth=kk - 1, axis=1)[:, :kk]
    top_scores = np.take_along_axis(gsum, top, axis=1)
    ord2 = np.argsort(-top_scores, axis=1, kind="stable")
    top = np.take_along_axis(top, ord2, axis=1)
    top_scores = np.take_along_axis(top_scores, ord2, axis=1)
    top_ids = np.take_along_axis(ids_s, top, axis=1)
    out_ids = np.full((q, k), -1, dtype=np.int32)
    out_scores = np.full((q, k), -np.inf, dtype=np.float32)
    keep = np.isfinite(top_scores)
    out_ids[:, :kk] = np.where(keep, top_ids, -1)
    out_scores[:, :kk] = np.where(keep, top_scores, -np.inf)
    return out_ids, out_scores
