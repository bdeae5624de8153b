"""RDFForest: the dense Dynamic Partition Forest on PyTorch.

Counterpart of `similaritysearchbyrdf_tpu/index/forest.py`, block mode:

fit   hash the corpus (K1) → partition-hash → composite keys → per-table
      stable sort → overflow-rule leaf buckets; with `coarse_dim`, an int8
      coarse tier of every corpus row per table in bucket-sorted order.
query hash with margins (K1) → probe keys (partition steps x bit flips) →
      bucket lookup → range dedup with step-distance priority → ragged
      flatten into blocks of 8 slots → coarse block scores (K2) → top-m2
      select → exact f32 rerank with deduplicated top-k.

Not ported yet: window mode and its pruning, the folded tier and the
groupmax path, the PCA coarse basis, a bf16 coarse tier, the bf16 two-stage
rerank (`rerank_dtype="bfloat16"`), sparse corpora.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..models.families import Device, HashModel, generate_model
from ..ops import rerank as rerank_ops
from ..ops.bitops import clz, to_key
from ..ops.hashing import hash_dense, hash_dense_with_margins
from ..ops.kernels.coarse_gather import coarse_block_scores_kernel
from ..vectors import DenseBatch
from .bucket_table import KEY_PAD, BucketTables, KeyLayout, build_tables, composite_keys, lookup_ranges
from .partitioner import generate_partition_projections, partition_of_hash, stepwise_patterns

NEG_INF_F32 = float("-inf")


@dataclasses.dataclass
class ForestState:
    """All tensors of a fitted dense forest, on one device."""

    model: HashModel
    part_proj: torch.Tensor                 # f32[L, pbits, 32]
    tables: BucketTables
    corpus: torch.Tensor                    # f32[Npad, D] (padding rows 0)
    row_ids: torch.Tensor                   # i32[Npad] user ids (padding -1)
    coarse_proj: Optional[torch.Tensor] = None    # f32[D, cs]
    # per-table coarse rows in bucket-sorted order, so a query block's rows
    # are contiguous (padding rows 0)
    coarse_tier: Optional[torch.Tensor] = None    # i8[L, Npad+ID_PAD, cs]

    @property
    def capacity(self) -> int:
        return self.corpus.shape[0]

    @property
    def device(self) -> torch.device:
        return self.corpus.device


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


def _pad_to(n: int, multiple: int) -> int:
    return int(np.ceil(max(n, 1) / multiple) * multiple)


def _keys_for_corpus(model: HashModel, part_proj: torch.Tensor, values: torch.Tensor,
                     n_valid: int, layout: KeyLayout, chunk: int) -> torch.Tensor:
    """Composite keys i32[L, Npad] (flipped; padding rows KEY_PAD), hashed in
    `chunk`-row pieces so the partition step's [chunk, L, 32] bits stay small."""
    parts = []
    for c0 in range(0, values.shape[0], chunk):
        h = hash_dense(model, values[c0:c0 + chunk])            # [chunk, L]
        parts.append(to_key(composite_keys(h, partition_of_hash(h, part_proj), layout)))
    keys = torch.cat(parts)                                     # [Npad, L]
    keys[n_valid:] = KEY_PAD
    return keys.T.contiguous()


def coarse_seg_width(cd: int) -> int:
    """Row width of the coarse tier: the smallest of 8/16/32/64 holding a
    cd-dim row, else a 128 multiple (the JAX package's lane segment)."""
    for cs in (8, 16, 32, 64):
        if cd <= cs:
            return cs
    return int(np.ceil(cd / 128.0) * 128)


def _coarse_projection(d: int, cd: int, seed: int, mode: str = "random") -> np.ndarray:
    """[d, cd] orthonormal projection: seed-deterministic QR of a Gaussian,
    the same numpy draw as the JAX package."""
    if mode != "random":
        raise NotImplementedError(f"coarse_proj_mode={mode!r} is not ported yet")
    rng = np.random.default_rng(seed ^ 0x5EED)
    return np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cd].astype(np.float32)


def _coarse_low(corpus: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Project and quantize the corpus once, with one global scale:
    [Npad, D] → i8[Npad, cs]. Rounding is half-to-even, as in the reference."""
    low = corpus @ proj
    scale = 127.0 / torch.clamp(low.abs().max(), min=1e-20)
    return torch.clamp(torch.round(low * scale), -127, 127).to(torch.int8)


def _build_coarse_tier(corpus: torch.Tensor, sorted_ids: torch.Tensor, coarse_dim: int,
                       coarse_dtype: str, seed: int, proj_mode: str = "random"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse_proj f32[D, cs], tier i8[L, caprows, cs]): every table's
    coarse rows in its bucket-sorted order, so a query block's rows are one
    contiguous slice. The tier is stored per table; the JAX package packs
    G = 128/cs tables per 128-lane row, a TPU DMA workaround."""
    if coarse_dtype != "int8":
        raise NotImplementedError(f"coarse_dtype={coarse_dtype!r} is not ported yet")
    d = corpus.shape[1]
    cd = min(coarse_dim, d)
    proj = np.eye(d, dtype=np.float32) if cd == d else _coarse_projection(d, cd, seed, proj_mode)
    cs = coarse_seg_width(cd)
    proj = np.pad(proj, ((0, 0), (0, cs - proj.shape[1])))
    coarse_proj = torch.as_tensor(proj, device=corpus.device)
    low = _coarse_low(corpus, coarse_proj)                      # [Npad, cs]
    tier = low[sorted_ids.clamp(min=0).to(torch.int64)]         # [L, caprows, cs]
    tier.masked_fill_((sorted_ids < 0)[..., None], 0)
    return coarse_proj, tier


def fit_dense(conf: RDFConfig, batch: DenseBatch, model: Optional[HashModel] = None,
              part_proj: Optional[torch.Tensor] = None, nb_pad: Optional[int] = None,
              device: Device = None) -> ForestState:
    """Build a forest over a dense corpus (`newFastFit`/`newMultiThreadFit`,
    `DensevectorRDFInit.scala:127-206`). `batch.values` may be a numpy array
    or a tensor; the forest lives on `device` (default: the tensor's, else
    the CPU)."""
    if conf.coarse_dim and conf.coarse_layout != "lane":
        raise NotImplementedError(f"coarse_layout={conf.coarse_layout!r} is not ported yet")
    if conf.rerank_dtype != "float32":
        raise NotImplementedError(f"rerank_dtype={conf.rerank_dtype!r} is not ported yet")
    if isinstance(batch.values, torch.Tensor) and device is None:
        device = batch.values.device
    device = torch.device(device or "cpu")
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    model = model if model is not None else generate_model(conf, device=device)
    if part_proj is None:
        part_proj = generate_partition_projections(conf, device=device)
    n = batch.n
    chunk = min(conf.fit_batch_size, _pad_to(n, 256))
    npad = _pad_to(n, chunk)
    # the JAX package also pads the corpus's dim to a 128 multiple for TPU
    # row-gather speed; the port keeps the true dim (same scores)
    values = torch.zeros((npad, batch.dim), dtype=torch.float32, device=device)
    values[:n] = torch.as_tensor(batch.values, dtype=torch.float32).to(device)
    row_ids = torch.full((npad,), -1, dtype=torch.int32, device=device)
    row_ids[:n] = torch.as_tensor(np.asarray(batch.ids), dtype=torch.int32).to(device)

    keys = _keys_for_corpus(model, part_proj, values, n, layout, chunk)
    pos = torch.arange(npad, dtype=torch.int32, device=device)
    ids = torch.where(pos < n, pos, -1).expand_as(keys)
    tables = build_tables(keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nb_pad)
    del keys, ids
    coarse_proj = coarse_tier = None
    if conf.coarse_dim:
        coarse_proj, coarse_tier = _build_coarse_tier(
            values, tables.sorted_ids, conf.coarse_dim, conf.coarse_dtype, conf.seed,
            proj_mode=conf.coarse_proj_mode)
    return ForestState(
        model=model, part_proj=part_proj, tables=tables, corpus=values, row_ids=row_ids,
        coarse_proj=coarse_proj, coarse_tier=coarse_tier,
    )


# ---------------------------------------------------------------------------
# query: probes and candidate blocks
# ---------------------------------------------------------------------------


def _probe_hashes_margin(h: torch.Tensor, margins: torch.Tensor, layout: KeyLayout,
                         budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-directed probing: flip the `budget` trie-consumed bits with the
    smallest hyperplane margins, plus the self-probe. Equal margins (a
    function drawn twice into one chain) fall in bit order, as the
    reference's top_k gives them. → (probes int64[B, L, P], valid)."""
    eligible = margins[..., :layout.consumed_bits]
    vals, bit_idx = torch.sort(eligible, dim=-1, stable=True)
    nb = min(budget, layout.consumed_bits)
    vals, bit_idx = vals[..., :nb], bit_idx[..., :nb]
    probes = h[..., None] ^ (1 << bit_idx)
    valid = torch.isfinite(vals)
    return (torch.cat([probes, h[..., None]], dim=-1),
            torch.cat([valid, torch.ones_like(valid[..., :1])], dim=-1))


def _probe_hashes(h: torch.Tensor, layout: KeyLayout, multiprobe: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's multi-probe set: `h ^ (1<<i)` for every
    i < 32 - nlz(h) - seg_bits, and not h itself
    (`RandomDrawTreeMap.java:753-756`). Flips of the trie's skipped bits all
    give h's own key, so they collapse into one self-probe that is valid
    when any of them was in range. → (probes int64[B, L, P], valid)."""
    if not multiprobe:
        return h[..., None], torch.ones(h.shape + (1,), dtype=torch.bool, device=h.device)
    i = torch.arange(layout.consumed_bits, dtype=torch.int64, device=h.device)
    limit = 32 - clz(h).to(torch.int64) - layout.seg_bits             # [B, L]
    probes = torch.cat([h[..., None] ^ (1 << i), h[..., None]], dim=-1)
    valid = torch.cat([i < limit[..., None], (limit > layout.consumed_bits)[..., None]],
                      dim=-1)
    return probes, valid


def probe_key_set(h: torch.Tensor, home: torch.Tensor, layout: KeyLayout, steps: int,
                  multiprobe: bool, probes: Optional[torch.Tensor] = None,
                  probe_valid: Optional[torch.Tensor] = None):
    """All composite probe keys of a query batch: step-wise partition
    patterns (P3) x bit-flip probes (P5), table-major. → (probe_keys
    int64[B, R], valid bool[B, R]) with R = L * S * P."""
    b, l = h.shape
    patterns = torch.as_tensor(stepwise_patterns(layout.partition_bits, steps),
                               device=h.device)                      # [S]
    parts = home[..., None] ^ patterns                                # [B, L, S]
    if probes is None:
        probes, probe_valid = _probe_hashes(h, layout, multiprobe)   # [B, L, P]
    s, p = patterns.shape[0], probes.shape[-1]
    keys = composite_keys(probes[:, :, None, :], parts[..., None], layout)
    valid = probe_valid[:, :, None, :].expand(b, l, s, p)
    return keys.reshape(b, -1), valid.reshape(b, -1)


def gather_blocks(tables: BucketTables, h: torch.Tensor, home: torch.Tensor,
                  layout: KeyLayout, steps: int, m_cap: int, multiprobe: bool,
                  probes: Optional[torch.Tensor] = None,
                  probe_valid: Optional[torch.Tensor] = None):
    """Probe fan-out → bucket ranges → dedup and priority → ragged flatten
    at block granularity (block mode). Returns (base, table, end, total, bs):
    base/table/end int64[B, MB], total int64[B]; block mb covers sorted
    positions [base + mb*bs, base + (mb+1)*bs) of its table, and a slot is
    valid while its position is < end."""
    b, l = h.shape
    dev = h.device
    probe_keys, valid = probe_key_set(h, home, layout, steps, multiprobe, probes, probe_valid)
    r = probe_keys.shape[1]
    s = len(stepwise_patterns(layout.partition_bits, steps))
    p = r // (l * s)
    start, length = lookup_ranges(tables, probe_keys)
    length = torch.where(valid, length, 0)
    cap = tables.capacity
    table_of = torch.arange(l, device=dev).repeat_interleave(s * p)          # [R]

    # dedup the (table, start) ranges many probes resolve to, then order the
    # survivors by priority: step distance first (home partition), then probe
    # rank (self-probe, then flips in order). When m_cap truncates, the
    # lowest-value buckets drop first. Sorts are stable, as the reference's
    # are on the CPU, so equal priorities keep (table, start) order.
    dist = torch.as_tensor(
        [bin(int(x)).count("1") for x in stepwise_patterns(layout.partition_bits, steps)],
        device=dev)
    probe_rank = torch.roll(torch.arange(p, device=dev), -1)   # flips 1.., self 0
    prio = (dist[:, None] * p + probe_rank[None, :]).reshape(-1).repeat(l)   # [R]
    rkey = torch.where(length > 0, table_of * (cap + 1) + start, 2**31 - 1)
    _, order = torch.sort((rkey << 32) | prio, dim=1, stable=True)
    rkey_s = torch.gather(rkey, 1, order)
    length_s = torch.gather(length, 1, order)
    dup = torch.cat([torch.zeros_like(rkey_s[:, :1], dtype=torch.bool),
                     rkey_s[:, 1:] == rkey_s[:, :-1]], dim=1)
    length_s = torch.where(dup, 0, length_s)
    prio_s = torch.where(length_s > 0, prio[order], 2**30)
    _, order2 = torch.sort(prio_s, dim=1, stable=True)
    order = torch.gather(order, 1, order2)
    start_s = torch.gather(start, 1, order)
    table_s = table_of[order]
    length_s = torch.gather(length_s, 1, order2)

    # ragged flatten into m_cap slots, at block granularity: each range's
    # allocation rounds up to whole blocks of bs slots, and block mb takes
    # the last range whose first block is <= mb (the reference builds the
    # same assignment with a merge sort and prefix sums, which suits a TPU;
    # here it is one binary search per block)
    bs = 8 if (m_cap % 8 == 0 and m_cap >= 4096) else 1
    mb_cap = m_cap // bs
    alen = (length_s + (bs - 1)) // bs * bs
    cum = torch.cumsum(alen, dim=1)
    first_block = torch.clamp((cum - alen) // bs, max=mb_cap)
    block_base = start_s - (cum - alen)
    end_r = start_s + length_s
    mb = torch.arange(mb_cap, device=dev).expand(b, mb_cap).contiguous()
    owner = torch.searchsorted(first_block.contiguous(), mb, right=True) - 1   # >= 0
    base_b = torch.gather(block_base, 1, owner)
    table_b = torch.gather(table_s, 1, owner)
    end_b = torch.gather(end_r, 1, owner)
    total = torch.clamp(length_s.sum(dim=1), max=m_cap)
    return base_b, table_b, end_b, total, bs


def _gather_id_blocks(sorted_ids: torch.Tensor, base_b: torch.Tensor,
                      table_b: torch.Tensor, bs: int) -> torch.Tensor:
    """Candidate row positions of every block slot, i32[B, MB*bs]. Block
    starts clip into the table (clipped blocks are wholly past their end
    and masked by the caller)."""
    l, cap = sorted_ids.shape
    b, mb_cap = base_b.shape
    mb = torch.arange(mb_cap, device=base_b.device)
    j = torch.arange(bs, device=base_b.device)
    pos = torch.clamp(base_b + mb * bs, 0, cap - bs)[..., None] + j
    t = torch.clamp(table_b, 0, l - 1)[..., None]
    return sorted_ids[t, pos].reshape(b, mb_cap * bs)


def gather_candidates(tables: BucketTables, h, home, layout: KeyLayout, steps: int,
                      m_cap: int, multiprobe: bool, probes=None, probe_valid=None):
    """Probe fan-out → ranges → flatten into a fixed candidate buffer.
    → (cand i32[B, m_cap] row positions, -1 invalid; total int64[B])."""
    base_b, table_b, end_b, total, bs = gather_blocks(
        tables, h, home, layout, steps, m_cap, multiprobe, probes, probe_valid)
    pos = base_b.repeat_interleave(bs, dim=1) + torch.arange(m_cap, device=h.device)
    slot_end = end_b.repeat_interleave(bs, dim=1)
    cand = _gather_id_blocks(tables.sorted_ids, base_b, table_b, bs)
    return torch.where((pos < slot_end) & (cand >= 0), cand, -1), total


# ---------------------------------------------------------------------------
# query: coarse scoring, select, rerank
# ---------------------------------------------------------------------------


def _coarse_block_scores(tier: torch.Tensor, coarse_proj: torch.Tensor,
                         queries: torch.Tensor, base_b: torch.Tensor,
                         table_b: torch.Tensor, end_b: torch.Tensor, bs: int):
    """Coarse scores of every candidate slot, read as contiguous blocks of
    the per-table tier by K2. → (scores f32[B, M] with -inf invalid,
    pos int64[B, M], table int64[B, M])."""
    b, mb_cap = base_b.shape
    mb = torch.arange(mb_cap, device=base_b.device)
    blk_start = base_b + mb * bs
    q_low = (queries @ coarse_proj).to(torch.bfloat16)
    scores = coarse_block_scores_kernel(
        tier, q_low.contiguous(), table_b.to(torch.int32).contiguous(),
        blk_start.to(torch.int32).contiguous(), bs)              # [B, MB, bs]
    pos = blk_start[..., None] + torch.arange(bs, device=base_b.device)
    scores = torch.where(pos < end_b[..., None], scores, NEG_INF_F32)
    return (scores.reshape(b, -1), pos.reshape(b, -1),
            table_b.repeat_interleave(bs, dim=1))


def _select_m2(scores: torch.Tensor, pos: torch.Tensor, table_slot: torch.Tensor,
               m2: int):
    """Top-m2 slots by coarse score → (t2, p2, sel_valid). The reference
    takes approx_max_k on narrow slices and a sort otherwise; on the CPU both
    return the exact top-m2, and so does this stable sort."""
    vals, idx = rerank_ops.top_sorted(scores, m2)
    return (torch.gather(table_slot, 1, idx), torch.gather(pos, 1, idx),
            torch.isfinite(vals))


def _exclude_self(cand: torch.Tensor, row_ids: torch.Tensor,
                  query_ids: torch.Tensor) -> torch.Tensor:
    """Drop candidates whose user id is the query's own
    (`RandomDrawTreeMap.java:982`)."""
    uid = row_ids[cand.clamp(min=0).to(torch.int64)]
    return torch.where((cand >= 0) & (uid == query_ids[:, None]), -1, cand)


def _to_user_ids(state: ForestState, rows: torch.Tensor) -> torch.Tensor:
    return torch.where(rows >= 0, state.row_ids[rows.clamp(min=0).to(torch.int64)], -1)


def _query_dense_coarse(state: ForestState, queries, query_ids, layout: KeyLayout,
                        steps: int, m_cap: int, k: int, multiprobe: bool,
                        exclude_self: bool, refine: int, probes=None, probe_valid=None,
                        h=None, window: int = -1):
    """Query through the coarse tier: coarse scores of all candidates,
    exact re-scores of the top `refine` only. The window rule is the
    reference's: -1 picks 64-slot windows at m_cap >= 32768, 0 is block
    mode; window mode is not ported yet."""
    if window < 0:
        win = 64 if m_cap % 64 == 0 and m_cap >= 32768 else 0
    else:
        win = window if (window and m_cap % window == 0) else 0
    if win:
        raise NotImplementedError(f"coarse window mode (window {win}) is not ported yet")
    if h is None:
        h = hash_dense(state.model, queries)
    home = partition_of_hash(h, state.part_proj)
    base_b, table_b, end_b, total, bs = gather_blocks(
        state.tables, h, home, layout, steps, m_cap, multiprobe, probes, probe_valid)
    scores, pos, table_slot = _coarse_block_scores(
        state.coarse_tier, state.coarse_proj, queries, base_b, table_b, end_b, bs)
    l = state.tables.num_tables
    cap = state.tables.capacity
    m2 = min(max(refine, (k + 1) * l), m_cap)
    t2, p2, sel_valid = _select_m2(scores, pos, table_slot, m2)
    cand2 = state.tables.sorted_ids[t2.clamp(0, l - 1), p2.clamp(0, cap - 1)]
    cand2 = torch.where(sel_valid & (cand2 >= 0), cand2, -1)
    if exclude_self:
        cand2 = _exclude_self(cand2, state.row_ids, query_ids)
    rows, sc = rerank_ops.dedup_topk(
        cand2, rerank_ops.score_candidates(state.corpus, cand2, queries), k)
    return _to_user_ids(state, rows), sc, total


def _query_dense(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                 layout: KeyLayout, steps: int = 0, m_cap: int = 4096, k: int = 10,
                 multiprobe: bool = True, exclude_self: bool = True,
                 probe_mode: str = "reference", probe_budget: int = 8,
                 coarse_refine: int = 2048, coarse_window: int = -1):
    """Batched ANN query core → (ids i32[B, k] user ids with -1 padding,
    scores f32[B, k], candidate counts int64[B]). probe_mode "reference"
    flips low bits blindly as the reference does; "margin" flips the
    `probe_budget` smallest-margin bits per table."""
    probes = probe_valid = None
    if probe_mode == "margin" and multiprobe:
        h, margins = hash_dense_with_margins(state.model, queries)
        probes, probe_valid = _probe_hashes_margin(h, margins, layout, probe_budget)
    else:
        h = hash_dense(state.model, queries)
    if state.coarse_tier is not None:
        return _query_dense_coarse(
            state, queries, query_ids, layout, steps, m_cap, k, multiprobe,
            exclude_self, refine=coarse_refine, probes=probes, probe_valid=probe_valid,
            h=h, window=coarse_window)
    home = partition_of_hash(h, state.part_proj)
    cand, total = gather_candidates(state.tables, h, home, layout, steps, m_cap,
                                    multiprobe, probes, probe_valid)
    if exclude_self:
        cand = _exclude_self(cand, state.row_ids, query_ids)
    rows, scores = rerank_ops.rerank_dense(state.corpus, cand, queries, k,
                                           dup_bound=h.shape[1])
    return _to_user_ids(state, rows), scores, total


def query_dense_many(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                     layout: KeyLayout, chunk: int = 256, **kw):
    """Whole-query-set search, `chunk` queries at a time (bounds peak
    memory). Takes `_query_dense`'s keyword arguments."""
    out = [_query_dense(state, queries[c0:c0 + chunk], query_ids[c0:c0 + chunk],
                        layout, **kw)
           for c0 in range(0, queries.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*out))


# ---------------------------------------------------------------------------
# host-facing forest
# ---------------------------------------------------------------------------


class RDFForest:
    """Host orchestrator for a dense forest (`DensevectorRDFInit` at the
    index layer). Everything lives on `device`."""

    def __init__(self, conf: RDFConfig, model: Optional[HashModel] = None,
                 seed: Optional[int] = None, device: Device = None):
        self.conf = conf
        self.device = torch.device(device or "cpu")
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        self.model = model.to(self.device) if model is not None else generate_model(
            conf, seed, device=self.device)
        self.part_proj = generate_partition_projections(conf, seed, device=self.device)
        self.state: Optional[ForestState] = None

    def fit(self, batch: DenseBatch) -> "RDFForest":
        self.state = fit_dense(self.conf, batch, model=self.model,
                               part_proj=self.part_proj, device=self.device)
        return self

    def query(self, queries: np.ndarray, steps: int = 0,
              query_ids: Optional[np.ndarray] = None, k: Optional[int] = None,
              **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays. Takes
        `query_device`'s keyword arguments."""
        ids, scores = self.query_device(queries, steps=steps, query_ids=query_ids, k=k, **kw)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, queries, steps: int = 0, query_ids=None,
                     k: Optional[int] = None, multiprobe: bool = True,
                     probe_mode: str = "reference", probe_budget: int = 8,
                     coarse_refine: Optional[int] = None, m_cap: Optional[int] = None,
                     coarse_window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the forest's device.
        Queries are taken `conf.query_batch_size` at a time; coarse_refine,
        m_cap and coarse_window default to the config's."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        k = k or self.conf.top_k
        qd = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        exclude = query_ids is not None
        qids = (torch.as_tensor(np.asarray(query_ids), dtype=torch.int32).to(self.device)
                if exclude else torch.full((qd.shape[0],), -1, dtype=torch.int32,
                                           device=self.device))
        ids, scores, _ = query_dense_many(
            self.state, qd, qids, self.layout, chunk=self.conf.query_batch_size,
            steps=steps, m_cap=m_cap or self.conf.max_candidates, k=k,
            multiprobe=multiprobe, exclude_self=exclude, probe_mode=probe_mode,
            probe_budget=probe_budget,
            coarse_refine=coarse_refine or self.conf.coarse_refine,
            coarse_window=(coarse_window if coarse_window is not None
                           else self.conf.coarse_window),
        )
        thr = self.conf.similarity_threshold
        if thr > 0.0:
            # exact-score post-filter (config.py `similarity_threshold`)
            keep = scores >= thr
            ids = torch.where(keep, ids, -1)
            scores = torch.where(keep, scores, NEG_INF_F32)
        return ids, scores

    def size(self) -> int:
        return 0 if self.state is None else int((self.state.row_ids >= 0).sum())

    def index_bytes_per_vector(self) -> float:
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return self.state.tables.index_bytes() / max(1, self.size())
