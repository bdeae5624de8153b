"""RDFMap: the reference's ConcurrentMap surface over a forest.

Counterpart of `similaritysearchbyrdf_tpu/deploy/map_api.py`.
`RandomDrawTreeMap` implements `ConcurrentMap<K, V>` (put / get / remove /
putIfAbsent / replace / clear / size, iteration, `getSimilar*`); a forest is
an immutable snapshot, so this keeps a host staging dict and rebuilds the
forest lazily at the next similarity read (`put:1557`, `remove:1817`,
`putIfAbsent:2499`, `replace:2534`, iterators `:2254-2453`). Point reads
and writes never touch the device. The hash functions stay fixed across
rebuilds, as the reference's trie mutates under fixed chains.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import RDFConfig
from ..index.forest import RDFForest
from ..models.families import Device, resolve_device
from ..vectors import DenseBatch


class RDFMap:
    def __init__(self, conf: RDFConfig, device: Device = None):
        self.conf = conf
        self.device = resolve_device(device)
        self._data: Dict[int, np.ndarray] = {}
        self._forest: Optional[RDFForest] = None
        self._dirty = True

    # -- ConcurrentMap surface ---------------------------------------------
    def put(self, key: int, vector: np.ndarray) -> Optional[np.ndarray]:
        """Insert or replace; returns the previous vector."""
        prev = self._data.get(int(key))
        self._data[int(key)] = np.asarray(vector, dtype=np.float32)
        self._dirty = True
        return prev

    def get(self, key: int, value_creator=None) -> Optional[np.ndarray]:
        """Point lookup; with `value_creator`, an absent key gets the
        creator's value inserted and returned (`RandomDrawTreeMap.java:
        911-923`)."""
        v = self._data.get(int(key))
        if v is None and value_creator is not None:
            v = np.asarray(value_creator(key), dtype=np.float32)
            self._data[int(key)] = v
            self._dirty = True
        return v

    def put_if_absent(self, key: int, vector: np.ndarray) -> Optional[np.ndarray]:
        if int(key) in self._data:
            return self._data[int(key)]
        self.put(key, vector)
        return None

    putIfAbsent = put_if_absent

    def replace(self, key: int, vector: np.ndarray) -> Optional[np.ndarray]:
        """Replace only if present (`replace:2534`)."""
        if int(key) not in self._data:
            return None
        return self.put(key, vector)

    def remove(self, key: int) -> Optional[np.ndarray]:
        prev = self._data.pop(int(key), None)
        if prev is not None:
            self._dirty = True
        return prev

    def clear(self) -> None:
        self._data.clear()
        self._forest = None
        self._dirty = True

    def size(self) -> int:
        return len(self._data)

    __len__ = size

    def __contains__(self, key: int) -> bool:
        return int(key) in self._data

    def keys(self) -> List[int]:
        return list(self._data.keys())

    def values(self) -> List[np.ndarray]:
        return list(self._data.values())

    def items(self) -> Iterator[Tuple[int, np.ndarray]]:
        return iter(self._data.items())

    # -- similarity reads ---------------------------------------------------
    def _ensure_built(self) -> RDFForest:
        """The forest over the current entries, in insertion order, refitted
        only after a change; the hash functions of the first build are kept."""
        if self._dirty or self._forest is None:
            if not self._data:
                raise RuntimeError("need to fit the data first")
            ids = np.fromiter(self._data.keys(), dtype=np.int32, count=len(self._data))
            values = np.stack(list(self._data.values()))
            prev = self._forest
            forest = RDFForest(self.conf, model=prev.model if prev is not None else None,
                               device=self.device)
            if prev is not None:
                forest.part_proj = prev.part_proj
            self._forest = forest.fit(DenseBatch(ids, values))
            self._dirty = False
        return self._forest

    def get_similar(self, key: int, steps: int = 0) -> List[int]:
        """Candidate ids of a stored key (`getSimilarWithStepWise`), itself
        excluded."""
        forest = self._ensure_built()
        v = self._data.get(int(key))
        if v is None:
            return []
        ids, _ = forest.query(v[None, :], steps=steps,
                              query_ids=np.asarray([key], dtype=np.int32), k=self.conf.top_k)
        return [int(i) for i in ids[0] if i >= 0]

    getSimilar = get_similar
    getSimilarWithStepWise = get_similar

    def get_similar_by_vector(self, vector: np.ndarray, steps: int = 0) -> List[int]:
        """`getSimilarWithStepWiseFaster` for a raw vector."""
        forest = self._ensure_built()
        ids, _ = forest.query(np.asarray(vector, np.float32)[None, :], steps=steps,
                              k=self.conf.top_k)
        return [int(i) for i in ids[0] if i >= 0]

    getSimilarWithStepWiseFaster = get_similar_by_vector
