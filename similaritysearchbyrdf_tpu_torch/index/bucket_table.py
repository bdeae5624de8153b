"""Array-encoded bucket tables: the Dynamic Partition Forest without pointers.

Counterpart of `similaritysearchbyrdf_tpu/index/bucket_table.py`, which
derives the encoding from the reference's `RandomDrawTreeMap`. Per table:

  key[i] = partition ‖ seg ‖ trie-bits (32 bits, right-aligned), sorted
  ascending, so every (prefix, depth) bucket is a contiguous range. Leaf
  buckets follow the overflow rule (the smallest depth whose prefix holds
  <= BUCKET_OVERFLOW points, capped at the deepest level) and are stored
  as boundary key, start offset and prefix shift.

Keys are stored as int32 with the sign bit flipped (`ops/bitops.to_key`),
which keeps the unsigned order; arithmetic on them runs in int64. Each
array holds the same values as the JAX package's uint32 array under that
mapping, and has its byte size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig, TableConfig
from ..ops.bitops import as_u32, from_key, to_key

# trailing -1 columns of sorted_ids, so fixed-width block reads near the end
# of a table stay in bounds (must cover the widest block a query reads)
ID_PAD = 64
KEY_PAD = to_key(torch.tensor(0xFFFFFFFF)).item()   # key of padding rows


@dataclasses.dataclass(frozen=True)
class KeyLayout:
    """Static description of the composite sort key."""

    partition_bits: int
    seg_bits: int           # 32 - BUCKET_LENGTH
    bits_per_level: int     # log2(dirNodeSize)
    num_levels: int         # MAX_TREE_LEVEL + 1 chain depths
    bucket_bits: int        # BUCKET_LENGTH

    @property
    def consumed_bits(self) -> int:
        return self.bits_per_level * self.num_levels

    @property
    def total_bits(self) -> int:
        return self.partition_bits + self.seg_bits + self.consumed_bits

    def depth_shift(self, depth: int) -> int:
        """Right-shift that turns a key into its depth-`depth` prefix."""
        return self.consumed_bits - self.bits_per_level * (depth + 1)

    @staticmethod
    def from_config(conf: RDFConfig, table: TableConfig) -> "KeyLayout":
        layout = KeyLayout(
            partition_bits=conf.partition_bits,
            seg_bits=table.seg_bits,
            bits_per_level=table.bits_per_level,
            num_levels=table.max_tree_level + 1,
            bucket_bits=table.bucket_bits,
        )
        # a key over 32 bits drops its deepest trie levels until it fits
        # (max-depth buckets then merge neighbours: candidate supersets)
        while layout.total_bits > 32 and layout.num_levels > 1:
            layout = dataclasses.replace(layout, num_levels=layout.num_levels - 1)
        if layout.total_bits > 32:
            raise NotImplementedError(
                f"composite key needs {layout.total_bits} bits > 32 even at "
                f"one trie level (partitionBits={layout.partition_bits})")
        return layout


def composite_keys(hashes: torch.Tensor, partitions: torch.Tensor,
                   layout: KeyLayout) -> torch.Tensor:
    """key = partition ‖ seg ‖ trie-bits as unsigned values in int64.
    seg = h >>> BUCKET_LENGTH (`RandomDrawTreeMap.java:1663`); trie bits are
    the low `consumed_bits` of the hash (`:1671`)."""
    h = as_u32(hashes)
    seg = h >> layout.bucket_bits
    trie = h & ((1 << layout.consumed_bits) - 1)
    return ((partitions.to(torch.int64) << (layout.seg_bits + layout.consumed_bits))
            | (seg << layout.consumed_bits) | trie) & 0xFFFFFFFF


@dataclasses.dataclass
class BucketTables:
    """The forest's bucket state.

    sorted_keys   i32[L, Npad]         composite keys (flipped), ascending
                                       per table (padding = KEY_PAD)
    sorted_ids    i32[L, Npad+ID_PAD]  row positions in key order (pad -1)
    bucket_keys   i32[L, NB]           prefix-aligned lower boundary of each
                                       leaf bucket (flipped; padding KEY_PAD)
    bucket_starts i32[L, NB+1]         start of each leaf bucket in
                                       sorted_ids (padding = Npad)
    bucket_shifts i32[L, NB]           prefix right-shift of each bucket
    records       i32[L, NB, 4]        (key, shift, start, end) per bucket,
                                       so one 16-byte gather fetches it
    """

    sorted_keys: torch.Tensor
    sorted_ids: torch.Tensor
    bucket_keys: torch.Tensor
    bucket_starts: torch.Tensor
    bucket_shifts: torch.Tensor
    records: torch.Tensor

    @property
    def num_tables(self) -> int:
        return self.sorted_keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.sorted_keys.shape[1]

    def index_bytes(self) -> int:
        """Device bytes held by the index structure (the numerator of
        index bytes per vector)."""
        arrays = [self.sorted_keys, self.sorted_ids, self.bucket_keys,
                  self.bucket_starts, self.bucket_shifts, self.records]
        return sum(a.numel() * a.element_size() for a in arrays)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _depths_progressive(sorted_keys: torch.Tensor, layout: KeyLayout,
                        overflow: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each element's leaf-bucket (start, prefix shift) by the overflow rule:
    the smallest depth whose prefix population <= overflow wins, the deepest
    level takes the rest (`putInner:1719`). Prefix-group bounds come from
    run boundaries of the sorted keys: prefix scans, no binary searches."""
    l, n = sorted_keys.shape
    keys = from_key(sorted_keys)
    dev = sorted_keys.device
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(l, n)
    done = torch.zeros((l, n), dtype=torch.bool, device=dev)
    elem_start = torch.zeros((l, n), dtype=torch.int64, device=dev)
    elem_shift = torch.zeros((l, n), dtype=torch.int64, device=dev)
    first = torch.ones((l, 1), dtype=torch.bool, device=dev)
    for d in range(layout.num_levels):
        s = layout.depth_shift(d)
        pref = keys >> s
        bm = torch.cat([first, pref[:, 1:] != pref[:, :-1]], dim=1)
        lo = torch.cummax(torch.where(bm, idx, 0), dim=1).values
        nxt = torch.where(bm, idx, n)
        suffix_min = torch.flip(torch.cummin(torch.flip(nxt, (1,)), dim=1).values, (1,))
        hi = torch.cat([suffix_min[:, 1:], torch.full_like(first, n, dtype=torch.int64)], 1)
        fit = ((hi - lo) <= overflow) & ~done
        if d == layout.num_levels - 1:
            fit |= ~done
        elem_start = torch.where(fit, lo, elem_start)
        elem_shift = torch.where(fit, s, elem_shift)
        done |= fit
    return elem_start, elem_shift


def _sort_and_depths(keys: torch.Tensor, ids: torch.Tensor, layout: KeyLayout,
                     overflow: int):
    """Stable sort of each table by key (ties keep input order, as the
    reference's CPU sort does), then the leaf bucket of every element.
    Returns (sorted_keys, sorted_ids, elem_start, elem_shift)."""
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    sorted_ids = torch.gather(ids, 1, order)
    elem_start, elem_shift = _depths_progressive(sorted_keys, layout, overflow)
    return sorted_keys, sorted_ids, elem_start, elem_shift


def _compact_buckets(sorted_keys: torch.Tensor, elem_start: torch.Tensor,
                     elem_shift: torch.Tensor, nb_pad: int):
    """Scatter leaf-bucket descriptors into fixed-width arrays. Padding rows
    may form a bucket of their own; their ids are -1 and mask at query time."""
    l, n = sorted_keys.shape
    dev = sorted_keys.device
    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(l, n)
    is_start = elem_start == pos
    slot = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    # slot nb_pad is a discard slot (non-starts, and buckets past nb_pad)
    slot = torch.where(is_start, slot, nb_pad).clamp(max=nb_pad)
    keys = from_key(sorted_keys)
    # the prefix-aligned lower boundary of the bucket's key range, not its
    # minimal member: a probe below every member but sharing the prefix
    # must still land in the bucket (`search:1005-1050`)
    boundary = (keys >> elem_shift) << elem_shift
    bkeys = torch.full((l, nb_pad + 1), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    bstarts = torch.full((l, nb_pad + 1), n, dtype=torch.int64, device=dev)
    bshifts = torch.zeros((l, nb_pad + 1), dtype=torch.int64, device=dev)
    bkeys.scatter_(1, slot, boundary)
    bstarts.scatter_(1, slot, pos)
    bshifts.scatter_(1, slot, elem_shift)
    bstarts[:, nb_pad] = n                    # the discard slot becomes the end
    return (to_key(bkeys[:, :nb_pad]).contiguous(),
            bstarts.to(torch.int32),
            bshifts[:, :nb_pad].to(torch.int32).contiguous())


def build_records(bucket_keys, bucket_starts, bucket_shifts) -> torch.Tensor:
    """(key, shift, start, end) per bucket: one 16-byte gather per probe."""
    return torch.stack([bucket_keys, bucket_shifts, bucket_starts[:, :-1],
                        bucket_starts[:, 1:]], dim=-1).contiguous()


def build_tables(keys: torch.Tensor, ids: torch.Tensor, layout: KeyLayout,
                 overflow: int, nb_pad: Optional[int] = None) -> BucketTables:
    """Build the forest's bucket state from keys i32[L, Npad] (flipped;
    padding KEY_PAD) and ids i32[L, Npad] (padding -1). Sizing the bucket
    arrays (`nb_pad`) costs one host sync unless it is given."""
    sorted_keys, sorted_ids, elem_start, elem_shift = _sort_and_depths(
        keys, ids, layout, overflow)
    l, n = sorted_keys.shape
    sorted_ids = torch.cat(
        [sorted_ids, torch.full((l, ID_PAD), -1, dtype=sorted_ids.dtype,
                                device=sorted_ids.device)], dim=1)
    if nb_pad is None:
        pos = torch.arange(n, device=keys.device)
        nb = int((elem_start == pos).sum(dim=1).max())                # host sync
        nb_pad = max(8, int(np.ceil(nb / 128.0)) * 128)
    bkeys, bstarts, bshifts = _compact_buckets(sorted_keys, elem_start, elem_shift, nb_pad)
    return BucketTables(
        sorted_keys=sorted_keys.contiguous(),
        sorted_ids=sorted_ids.to(torch.int32).contiguous(),
        bucket_keys=bkeys, bucket_starts=bstarts, bucket_shifts=bshifts,
        records=build_records(bkeys, bstarts, bshifts),
    )


# ---------------------------------------------------------------------------
# probe lookup
# ---------------------------------------------------------------------------

_DEC = 64   # decimation of the two-level rank


def _rank(bk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per table, the index of the last bucket boundary <= q (-1 if none):
    bk i32[L, NB] ascending, q i32[L, Q] → int64[L, Q].

    Wide bucket arrays (NB > max(4096, 2*Q), NB a multiple of 64) rank in
    two levels as the reference does (`bucket_table.py:424-452`): against
    every 64th boundary first, then by counting within the one contiguous
    64-wide span. Both routes give the exact rank."""
    l, nb = bk.shape
    if nb <= max(4096, 2 * q.shape[1]) or nb % _DEC:
        return torch.searchsorted(bk, q, right=True) - 1
    c = torch.searchsorted(bk[:, ::_DEC].contiguous(), q, right=True) - 1
    cc = c.clamp(min=0)
    span = torch.gather(bk.view(l, nb // _DEC, _DEC), 1,
                        cc[..., None].expand(-1, -1, _DEC))         # [L, Q, 64]
    within = (span <= q[..., None]).sum(dim=-1)
    return torch.where(c >= 0, cc * _DEC + within - 1, -1)


def lookup_ranges(tables: BucketTables, probe_keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve each probe key to its bucket's (start, length) in that table's
    sorted_ids; a probe whose prefix does not exist gets length 0
    (`searchWithSimilarity:940-994`). probe_keys int64[B, R] (unsigned
    values) are table-major: R = L * per_table. → (start, length) int64."""
    l = tables.num_tables
    b, r = probe_keys.shape
    pt = r // l
    q = to_key(probe_keys).view(b, l, pt).transpose(0, 1).reshape(l, b * pt)
    b_idx = _rank(tables.bucket_keys, q)
    rec = torch.gather(tables.records, 1, b_idx.clamp(min=0)[..., None].expand(-1, -1, 4))
    key_b, shift_b, start, end = rec.unbind(-1)
    shift_b = shift_b.to(torch.int64)
    valid = (b_idx >= 0) & ((from_key(q) >> shift_b) == (from_key(key_b) >> shift_b))
    length = torch.where(valid, end.to(torch.int64) - start, 0)

    def back(a):
        return a.to(torch.int64).view(l, b, pt).transpose(0, 1).reshape(b, r)

    return back(start), back(length)
