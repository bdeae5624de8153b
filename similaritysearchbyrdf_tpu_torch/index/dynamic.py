"""DynamicForest: incremental inserts with a delta tier.

Counterpart of `similaritysearchbyrdf_tpu/index/dynamic.py`. A large MAIN
forest plus a small DELTA forest that absorbs inserts; both share one hash
model and one set of partition chains, so they bucket alike. The delta is
rebuilt lazily at the next query (one rebuild per burst of inserts), and
the tiers compact into one main build when the delta outgrows
`merge_threshold` x main (the array analogue of the trie's growth,
`RandomDrawTreeMap.java:1662-1790`).

Removals are tombstones (the reference's `remove:1817` deletes trie nodes):
removed ids are filtered from results and dropped at the next compaction,
which runs as soon as more than `TOMBSTONE_LIMIT` are pending. The main
tier's live rows are those its tables hold, so a negative user id is a
live row (the JAX package reads it as the -1 padding and drops it).

The staged delta rows live on the forest's device (their ids also on the
host, for removals), and queries merge the tiers there.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..models.families import Device, resolve_device
from ..vectors import DenseBatch
from .forest import NEG_INF_F32, ForestState, RDFForest, live_rows


class DynamicForest:
    # each tier's query fetches k + the first of these that covers the
    # pending tombstones, so filtering cannot starve the merge (the JAX
    # package buckets it to bound its compiled shapes; the port keeps the
    # same k per tier so that both merges see the same lists)
    OVERFETCH_BUCKETS = (0, 16, 64)
    TOMBSTONE_LIMIT = OVERFETCH_BUCKETS[-1]

    def __init__(self, conf: RDFConfig, merge_threshold: float = 0.25, device: Device = None):
        self.conf = conf
        self.merge_threshold = merge_threshold
        self.device = resolve_device(device)
        self.main = RDFForest(conf, device=self.device)
        self.delta: Optional[RDFForest] = None
        self._delta_ids: List[np.ndarray] = []         # i32 chunks, host
        self._delta_vecs: List[torch.Tensor] = []      # f32 chunks [n, D]
        self._tombstones: Set[int] = set()
        self._delta_dirty = False

    @classmethod
    def from_states(cls, conf: RDFConfig, main: ForestState,
                    delta: Optional[ForestState] = None, tombstones=(),
                    delta_ids: Optional[np.ndarray] = None, delta_values=None,
                    merge_threshold: float = 0.25, device: Device = None) -> "DynamicForest":
        """A DynamicForest in a given state: the main tier's fitted state,
        the delta tier's (None for no delta tier) with its staged rows
        (`delta_ids` i32[n], `delta_values` [n, D]), and the pending
        tombstones. Both tiers take the main state's model and partition
        chains."""
        dyn = cls(conf, merge_threshold=merge_threshold, device=device)
        dyn.main.state = main.to(dyn.device)
        dyn.main.model, dyn.main.part_proj = dyn.main.state.model, dyn.main.state.part_proj
        if delta is not None:
            dyn.delta = RDFForest(conf, model=dyn.main.model, device=dyn.device)
            dyn.delta.part_proj = dyn.main.part_proj
            dyn.delta.state = delta.to(dyn.device)
        if delta_ids is not None and len(delta_ids):
            dyn._delta_ids = [np.asarray(delta_ids, dtype=np.int32)]
            dyn._delta_vecs = [torch.as_tensor(delta_values, dtype=torch.float32).to(dyn.device)]
        dyn._tombstones = {int(t) for t in tombstones}
        return dyn

    # -- mutation ------------------------------------------------------------
    def _clear_delta(self) -> None:
        self.delta = None
        self._delta_ids, self._delta_vecs = [], []
        self._delta_dirty = False

    def fit(self, batch: DenseBatch) -> "DynamicForest":
        self.main.fit(batch)
        self._clear_delta()
        self._tombstones.clear()
        return self

    def add(self, batch: DenseBatch) -> None:
        """Stage the rows; the delta forest is rebuilt at the next query.
        Re-adding a removed id revives it."""
        ids = batch.ids.cpu().numpy() if isinstance(batch.ids, torch.Tensor) else batch.ids
        self._delta_ids.append(ids)
        self._delta_vecs.append(
            torch.as_tensor(batch.values, dtype=torch.float32).to(self.device))
        self._tombstones.difference_update(ids.tolist())
        self._delta_dirty = True
        if self._delta_count() > self.merge_threshold * max(1, self.main.size()):
            self.compact()

    def remove(self, key: int) -> None:
        """Drop `key` from the staged delta and tombstone it; past
        TOMBSTONE_LIMIT pending tombstones, compact."""
        key = int(key)
        ids, vecs = self._delta_rows()
        if ids is not None and (ids == key).any():
            keep = ids != key
            self._delta_ids = [ids[keep]]
            self._delta_vecs = [vecs[torch.from_numpy(keep).to(self.device)]]
            self._delta_dirty = True
        self._tombstones.add(key)
        if len(self._tombstones) > self.TOMBSTONE_LIMIT:
            self.compact()

    def _delta_count(self) -> int:
        return sum(len(c) for c in self._delta_ids)

    def _delta_rows(self) -> Tuple[Optional[np.ndarray], Optional[torch.Tensor]]:
        """The staged delta as one (ids, values) pair, or (None, None)."""
        if not self._delta_ids:
            return None, None
        if len(self._delta_ids) > 1:
            self._delta_ids = [np.concatenate(self._delta_ids)]
            self._delta_vecs = [torch.cat(self._delta_vecs)]
        return self._delta_ids[0], self._delta_vecs[0]

    def _tombstone_tensor(self) -> torch.Tensor:
        return torch.as_tensor(sorted(self._tombstones), dtype=torch.int32, device=self.device)

    def _rebuild_delta(self) -> None:
        self._delta_dirty = False
        ids, vecs = self._delta_rows()
        if ids is None or len(ids) == 0:
            self.delta = None
            return
        # one model and one set of partition chains for both tiers
        delta = RDFForest(self.conf, model=self.main.model, device=self.device)
        delta.part_proj = self.main.part_proj
        self.delta = delta.fit(DenseBatch(ids, vecs))

    def compact(self) -> None:
        """Fold the delta and the tombstones into one main build: the main
        tier's live rows, then the delta's, minus the tombstoned ids."""
        id_parts, vec_parts = [], []
        st = self.main.state
        if st is not None and self.main.size() > 0:
            live = live_rows(st.tables)
            id_parts.append(st.row_ids[live])
            vec_parts.append(st.corpus[live][:, :self.conf.vector_dim])
        ids, vecs = self._delta_rows()
        if ids is not None:
            id_parts.append(torch.as_tensor(ids, device=self.device))
            vec_parts.append(vecs)
        if not id_parts:
            return
        ids = torch.cat(id_parts)
        vecs = torch.cat(vec_parts)
        keep = ~torch.isin(ids, self._tombstone_tensor())
        self.main.fit(DenseBatch(ids[keep], vecs[keep]))
        self._clear_delta()
        self._tombstones.clear()

    def size(self) -> int:
        """Live rows: both tiers' rows less the tombstoned ids among them."""
        n = self.main.size() + self._delta_count()
        if not self._tombstones:
            return n
        tombs = self._tombstone_tensor()
        dead = torch.zeros_like(tombs, dtype=torch.bool)
        if self.main.state is not None:
            dead |= torch.isin(tombs, self.main.live_ids())
        ids, _ = self._delta_rows()
        if ids is not None:
            dead |= torch.isin(tombs, torch.as_tensor(ids, device=self.device))
        return n - int(dead.sum())

    # -- query -----------------------------------------------------------------
    def query(self, queries, steps: int = 0, query_ids: Optional[np.ndarray] = None,
              k: Optional[int] = None, **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Both tiers' top (k + over-fetch), tombstones dropped, merged by
        score with a stable descending sort (ties keep main before delta,
        then rank order, as the JAX package's stable argsort does). Takes
        `RDFForest.query_device`'s keywords. → (ids [Q, k], scores [Q, k])
        as numpy arrays."""
        ids, scores = self.query_device(queries, steps=steps, query_ids=query_ids, k=k, **kw)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, queries, steps: int = 0, query_ids: Optional[np.ndarray] = None,
                     k: Optional[int] = None, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer."""
        k = k or self.conf.top_k
        if self._delta_dirty:
            self._rebuild_delta()
        tiers = [t for t in (self.main if self.main.state is not None else None, self.delta)
                 if t is not None]
        if not tiers:
            q = len(queries)
            return (torch.full((q, k), -1, dtype=torch.int32, device=self.device),
                    torch.full((q, k), NEG_INF_F32, dtype=torch.float32, device=self.device))
        extra = self.overfetch()
        outs = [t.query_device(queries, steps=steps, query_ids=query_ids, k=k + extra, **kw)
                for t in tiers]
        return merge_tiers(outs, self._tombstone_tensor(), k)

    def overfetch(self) -> int:
        """Extra results each tier returns: the first bucket that covers the
        pending tombstones."""
        live_tombs = min(len(self._tombstones), self.TOMBSTONE_LIMIT)
        return next(b for b in self.OVERFETCH_BUCKETS if b >= live_tombs)


def merge_tiers(outs, tombstones: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge tiers' (ids, scores) lists, in tier order: tombstoned ids become
    (-1, -inf), then a stable descending sort by score keeps the top k."""
    ids = torch.cat([o[0] for o in outs], dim=1)
    scores = torch.cat([o[1] for o in outs], dim=1)
    if tombstones.numel():
        dead = torch.isin(ids, tombstones)
        scores = torch.where(dead, NEG_INF_F32, scores)
        ids = torch.where(dead, -1, ids)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(ids, 1, order[:, :k]), scores[:, :k]
