"""Vectorized Bloom filter — the persisted-generation data summary.

The reference builds a Bloom filter over the keys of every spilled partition
(`generateDataSummary`, `RandomDrawTreeMap.java:2764-2773`;
`StoreAppend.initDataSummary/searchInDataSummary`, `StoreAppend.java:202-366`)
so reads can skip persisted stores that cannot contain a key. Same role here:
gate which persisted index generations a point read needs to open — but
membership tests run vectorized over whole batches. A copy of
`similaritysearchbyrdf_tpu/storage/bloom.py` (numpy on the host), so either
package reads the other's summaries.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _mix(x: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic 32-bit avalanche mix (splitmix-style) per hash seed."""
    x = (x.astype(np.uint64) + np.uint64(seed * 0x9E3779B9)) & np.uint64(0xFFFFFFFF)
    x = (x ^ (x >> np.uint64(16))) * np.uint64(0x45D9F3B) & np.uint64(0xFFFFFFFF)
    x = (x ^ (x >> np.uint64(16))) * np.uint64(0x45D9F3B) & np.uint64(0xFFFFFFFF)
    return (x ^ (x >> np.uint64(16))).astype(np.uint32)


@dataclasses.dataclass
class BloomFilter:
    bits: np.ndarray      # uint32 words
    num_hashes: int

    @staticmethod
    def build(expected: int, fpr: float = 0.001) -> "BloomFilter":
        """Sizing identical in spirit to the reference's
        `initDataSummary(count, fpr=0.001)`."""
        expected = max(1, expected)
        m = max(64, int(-expected * math.log(fpr) / (math.log(2) ** 2)))
        m = ((m + 31) // 32) * 32
        k = max(1, round(m / expected * math.log(2)))
        return BloomFilter(np.zeros(m // 32, dtype=np.uint32), int(min(k, 16)))

    @property
    def num_bits(self) -> int:
        return len(self.bits) * 32

    def add(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys)
        for s in range(self.num_hashes):
            h = _mix(keys, s) % np.uint32(self.num_bits)
            np.bitwise_or.at(self.bits, h >> 5, np.uint32(1) << (h & np.uint32(31)))

    def might_contain(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        out = np.ones(keys.shape, dtype=bool)
        for s in range(self.num_hashes):
            h = _mix(keys, s) % np.uint32(self.num_bits)
            got = (self.bits[h >> 5] >> (h & np.uint32(31))) & np.uint32(1)
            out &= got.astype(bool)
        return out
