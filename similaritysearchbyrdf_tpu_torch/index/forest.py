"""RDFForest: the dense Dynamic Partition Forest on PyTorch.

Counterpart of `similaritysearchbyrdf_tpu/index/forest.py`:

fit   hash the corpus (K1) → partition-hash → composite keys → per-table
      stable sort → overflow-rule leaf buckets; with `coarse_dim`, an int8
      or bf16 (`coarse_dtype`) coarse tier of every corpus row per table in
      bucket-sorted order, on a random or PCA basis (`coarse_proj_mode`)
      (and, with `coarse_head_pool`, its mean-pooled head tier); with
      `rerank_dtype="bfloat16"`, a bf16 copy of the corpus for the
      two-stage rerank.
query hash with margins (K1) → probe keys (partition steps x bit flips) →
      bucket lookup → range dedup with step-distance priority → ragged
      flatten, then one of three coarse paths and an exact f32 rerank with
      deduplicated top-k (two-stage over the bf16 copy when the fit made
      one):
      * block mode (m_cap < 32768): blocks of 8 slots → coarse block scores
        (K2) → top-m2 select;
      * window mode (m_cap >= 32768, `coarse_window`): aligned 64-slot
        windows → optional head-tier window pruning (`window_keep`) →
        window scores with the validity mask fused (K2b) → strided 4-way
        tournament → top-m2 select;
      * folded layout (`coarse_layout="folded"`): aligned windows of the
        slot-folded view of the tier → packed per-row maxima (K3) → group
        max → group select, optional id dedup (`select_mult`) or staged
        int8 rerank (`stage2`).

`RDFForest` adds inserts (`add`), the per-table sub-index distribution and
`query_dense`, the public name of the batched query core. Sparse corpora
have their own forest (`index/sparse_forest.py`), built on this module's
tables, candidate blocks and coarse scores.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..models.families import Device, HashModel, generate_model, resolve_device
from ..ops import rerank as rerank_ops
from ..ops.bitops import clz, from_key, to_key
from ..ops.hashing import hash_dense, hash_dense_with_margins
from ..ops.kernels import hash_kernel
from ..ops.kernels.coarse_fold import I32_DEAD, coarse_rowmax_kernel
from ..ops.kernels.coarse_gather import coarse_block_scores_kernel, coarse_window_scores_kernel
from ..ops.kernels.topk_select import topk_packed_select, topk_select
from ..ops.precision import full_f32
from ..utils.timing import span
from ..vectors import DenseBatch
from .bucket_table import KEY_PAD, BucketTables, KeyLayout, build_tables, composite_keys, lookup_ranges
from .chunk_graphs import ChainGraphs, chain_for
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
    # bf16 copy of `corpus` for the two-stage rerank (rerank_dtype="bfloat16")
    corpus_lp: Optional[torch.Tensor] = None      # bf16[Npad, D]
    coarse_proj: Optional[torch.Tensor] = None    # f32[D, cs]
    # per-table coarse rows in bucket-sorted order, so a query block's rows
    # are contiguous (padding rows 0)
    coarse_tier: Optional[torch.Tensor] = None    # i8 or bf16[L, Npad+ID_PAD, cs]
    # mean-pooled head tier for window pruning (`coarse_head_pool` rows per
    # head row, lane layout only)
    coarse_head: Optional[torch.Tensor] = None    # bf16[L, ceil(caprows/hp), cs]
    # "folded": queries run the groupmax path on `coarse_folded`
    coarse_layout: str = "lane"

    @property
    def capacity(self) -> int:
        return self.corpus.shape[0]

    @property
    def coarse_folded(self) -> Optional[torch.Tensor]:
        """The slot-folded tier i8[L, caprows/fold, fold*cs]: a view of
        `coarse_tier` (the JAX package's `_fill_folded` is a row-major
        reshape of the same rows), or None outside the folded layout."""
        if self.coarse_layout != "folded" or self.coarse_tier is None:
            return None
        l, caprows, cs = self.coarse_tier.shape
        fold = coarse_fold_factor(cs)
        if caprows % fold:
            raise ValueError(f"coarse tier rows {caprows} are not a multiple of fold {fold}")
        return self.coarse_tier.view(l, caprows // fold, fold * cs)

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    def to(self, device: Device) -> "ForestState":
        """This state with every tensor, its model's and tables' too, on
        `device`."""
        return state_to(self, device)


def state_to(state, device: Device):
    """A dataclass state with every tensor in it, nested dataclasses'
    too, on `device`."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: state_to(getattr(state, f.name), device)
                                             for f in dataclasses.fields(state)})
    return state


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


def coarse_fold_factor(cs: int) -> int:
    """Slots per physical row of the folded tier: 128 // cs for the packable
    widths, 1 for a 128 multiple. Not a hardware unit here but part of the
    semantics: a physical row is what the rowmax reduces over and what the
    member bits address, as in the JAX package."""
    return max(1, 128 // cs)


_PCA_SAMPLE = 131072      # rows of the strided sample the PCA basis is taken from


def _coarse_projection(corpus: torch.Tensor, cd: int, seed: int,
                       mode: str = "random") -> np.ndarray:
    """[D, cd] orthonormal projection of the row-padded corpus f32[Npad, D].
    "random": seed-deterministic QR of a Gaussian, the same numpy draw as
    the JAX package. "pca": the top-cd eigenvectors of the uncentered
    second moment of a strided sample of at most 128k rows (the same rows
    as the JAX package's, which pads rows alike), formed in full f32 on the
    corpus's device and decomposed in float64 on the host; eigenvalues
    descending, and each column's sign set so that its largest-magnitude
    entry is positive (`eigh`'s sign is arbitrary). Uncentered, because
    search scores are inner products."""
    d = corpus.shape[1]
    if mode == "pca":
        stride = max(1, corpus.shape[0] // _PCA_SAMPLE)
        xs = corpus[::stride]
        with full_f32():
            mom = (xs.T @ xs).cpu().numpy()
        w, v = np.linalg.eigh(mom.astype(np.float64))
        proj = v[:, np.argsort(-w)[:cd]].astype(np.float32)
        flip = np.sign(proj[np.argmax(np.abs(proj), axis=0), np.arange(cd)])
        return (proj * np.where(flip == 0, 1.0, flip)[None, :]).astype(np.float32)
    if mode != "random":
        raise ValueError(f"unknown coarse_proj_mode {mode!r}")
    rng = np.random.default_rng(seed ^ 0x5EED)
    return np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cd].astype(np.float32)


def _coarse_low(corpus: torch.Tensor, proj: torch.Tensor, store_int8: bool = True
                ) -> torch.Tensor:
    """Project the corpus once: [Npad, D] → i8[Npad, cs] quantized with one
    global scale, rounding half to even as in the reference, or the
    projection itself rounded to bf16 (no scale)."""
    with full_f32():
        low = corpus @ proj
    if not store_int8:
        return low.to(torch.bfloat16)
    scale = 127.0 / torch.clamp(low.abs().max(), min=1e-20)
    return torch.clamp(torch.round(low * scale), -127, 127).to(torch.int8)


def _build_coarse_tier(corpus: torch.Tensor, sorted_ids: torch.Tensor, coarse_dim: int,
                       coarse_dtype: str, seed: int, proj_mode: str = "random",
                       proj: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse_proj f32[D, cs], tier [L, caprows, cs], int8 for
    coarse_dtype "int8", else bf16): every table's coarse rows in its
    bucket-sorted order, so a query block's rows are one contiguous slice.
    The tier is stored per table; the JAX package packs G = 128/cs tables
    per 128-lane row, a TPU DMA workaround. `proj` is a saved projection
    (the load path): used as it is, never recomputed, so the rebuilt tier
    equals the fitted one (a PCA basis depends on the fitting device's
    products)."""
    d = corpus.shape[1]
    cd = min(coarse_dim, d)
    if proj is not None:
        proj = np.asarray(proj, dtype=np.float32)
    elif cd == d:
        proj = np.eye(d, dtype=np.float32)
    else:
        proj = _coarse_projection(corpus, cd, seed, proj_mode)
    cs = coarse_seg_width(cd)
    proj = np.pad(proj, ((0, 0), (0, cs - proj.shape[1])))
    coarse_proj = torch.as_tensor(proj, device=corpus.device)
    low = _coarse_low(corpus, coarse_proj, coarse_dtype == "int8")   # [Npad, cs]
    tier = low[sorted_ids.clamp(min=0).to(torch.int64)]         # [L, caprows, cs]
    tier.masked_fill_((sorted_ids < 0)[..., None], 0)
    return coarse_proj, tier


def build_head_tier(tier: torch.Tensor, sorted_ids: torch.Tensor, hp: int) -> torch.Tensor:
    """Head tier bf16[L, ceil(caprows/hp), cs] for window pruning: row r of
    table t is the mean of the table's live coarse rows [r*hp, (r+1)*hp),
    summed in f32 (exact for int8; for a bf16 tier the sum rounds, in
    another order than the JAX package's) and divided by the live count, as
    the JAX package's `build_head_tier` does per lane segment. Built a table
    at a time, so the f32 sums never hold more than one table."""
    l, caprows, cs = tier.shape
    hr = -(-caprows // hp)
    pad = hr * hp - caprows
    out = torch.empty((l, hr, cs), dtype=torch.bfloat16, device=tier.device)
    for t in range(l):
        rows = torch.nn.functional.pad(tier[t], (0, 0, 0, pad)).to(torch.float32)
        live = torch.nn.functional.pad((sorted_ids[t] >= 0).to(torch.int32), (0, pad))
        cnt = live.view(hr, hp).sum(dim=1).clamp(min=1).to(torch.float32)
        out[t] = (rows.view(hr, hp, cs).sum(dim=1) / cnt[:, None]).to(torch.bfloat16)
    return out


def head_tier_traced(tier: torch.Tensor, sorted_ids: torch.Tensor, hp: int) -> torch.Tensor:
    """One shard's head tier, the counterpart of the JAX package's
    `head_tier_traced` (`index/forest.py:556`), which the sharded fit calls
    inside its shard map (no host arrays): the masked mean of
    `build_head_tier`, over the shard's own tier and sorted ids. The JAX
    form reads the lane-packed tier; the port's tier is per table, so the
    two builds are one."""
    return build_head_tier(tier, sorted_ids, hp)


def build_coarse_tiers(conf: RDFConfig, corpus: torch.Tensor, sorted_ids: torch.Tensor,
                       proj: Optional[np.ndarray] = None):
    """(coarse_proj, coarse_tier, coarse_head) as a fit with `conf` makes
    them from the row-padded corpus and the tables' sorted ids (all None
    without `coarse_dim`; the head tier only in the lane layout with
    `coarse_head_pool`). `proj` is a saved projection (the load path)."""
    if not conf.coarse_dim:
        return None, None, None
    coarse_proj, tier = _build_coarse_tier(corpus, sorted_ids, conf.coarse_dim,
                                           conf.coarse_dtype, conf.seed,
                                           proj_mode=conf.coarse_proj_mode, proj=proj)
    head = None
    if conf.coarse_layout == "lane" and conf.coarse_head_pool:
        head = build_head_tier(tier, sorted_ids, conf.coarse_head_pool)
    return coarse_proj, tier, head


def fit_dense(conf: RDFConfig, batch: DenseBatch, model: Optional[HashModel] = None,
              part_proj: Optional[torch.Tensor] = None, nb_pad: Optional[int] = None,
              device: Device = None) -> ForestState:
    """Build a forest over a dense corpus (`newFastFit`/`newMultiThreadFit`,
    `DensevectorRDFInit.scala:127-206`). `batch.values` may be a numpy array
    or a tensor; the forest lives on `device` (default: the tensor's, else
    the first CUDA card, `resolve_device`)."""
    if conf.coarse_layout not in ("lane", "folded"):
        raise ValueError(f"unknown coarse_layout {conf.coarse_layout!r}")
    if conf.coarse_dim and conf.coarse_layout == "folded" and conf.coarse_dtype != "int8":
        raise ValueError("coarse_layout='folded' requires coarse_dtype='int8' (the groupmax "
                         "kernel packs integer scores)")
    if isinstance(batch.values, torch.Tensor) and device is None:
        device = batch.values.device
    device = resolve_device(device)
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
    row_ids[:n] = torch.as_tensor(batch.ids, dtype=torch.int32).to(device)

    keys = _keys_for_corpus(model, part_proj, values, n, layout, chunk)
    pos = torch.arange(npad, dtype=torch.int32, device=device)
    ids = torch.where(pos < n, pos, -1).expand_as(keys)
    tables = build_tables(keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nb_pad)
    del keys, ids
    coarse_proj, coarse_tier, coarse_head = build_coarse_tiers(conf, values, tables.sorted_ids)
    corpus_lp = values.to(torch.bfloat16) if conf.rerank_dtype == "bfloat16" else None
    return ForestState(
        model=model, part_proj=part_proj, tables=tables, corpus=values, row_ids=row_ids,
        corpus_lp=corpus_lp, coarse_proj=coarse_proj, coarse_tier=coarse_tier,
        coarse_head=coarse_head, coarse_layout=conf.coarse_layout,
    )


# ---------------------------------------------------------------------------
# query: options
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryOptions:
    """The options of one forest query, with the JAX package's defaults.
    probe_mode "reference" flips low bits blindly as the reference does;
    "margin" flips the `probe_budget` smallest-margin bits per table."""

    steps: int = 0
    m_cap: int = 4096
    k: int = 10
    multiprobe: bool = True
    exclude_self: bool = True
    probe_mode: str = "reference"
    probe_budget: int = 8
    coarse_refine: int = 2048
    coarse_window: int = -1
    window_keep: int = 0
    head_pool: int = 0
    coarse_group: int = 64
    rows_keep: int = 1
    select_mult: int = 1
    stage2: int = 0

    def chain_key(self) -> tuple:
        """The options that change a chunk's hash and flatten graphs, in
        `_chunk_chain`'s key."""
        return (self.steps, self.m_cap, self.multiprobe, self.probe_mode, self.probe_budget,
                self.coarse_window, self.coarse_group)


def query_options(conf: RDFConfig, k: Optional[int] = None, m_cap: Optional[int] = None,
                  coarse_refine: Optional[int] = None, coarse_window: Optional[int] = None,
                  window_keep: Optional[int] = None, coarse_group: Optional[int] = None,
                  rows_keep: Optional[int] = None, select_mult: Optional[int] = None,
                  stage2: Optional[int] = None, **kw) -> QueryOptions:
    """The options of a query on a forest fitted with `conf`: `kw` as given,
    the others the config's where not given: k, m_cap, coarse_refine,
    coarse_group and select_mult when None or 0; coarse_window, window_keep
    (`coarse_keep`), rows_keep and stage2 only when None; head_pool always
    (`coarse_head_pool`)."""
    return QueryOptions(
        k=k or conf.top_k, m_cap=m_cap or conf.max_candidates,
        coarse_refine=coarse_refine or conf.coarse_refine,
        coarse_window=conf.coarse_window if coarse_window is None else coarse_window,
        window_keep=conf.coarse_keep if window_keep is None else window_keep,
        head_pool=conf.coarse_head_pool, coarse_group=coarse_group or conf.coarse_group,
        rows_keep=conf.coarse_rows_keep if rows_keep is None else rows_keep,
        select_mult=select_mult or conf.coarse_select_mult,
        stage2=conf.coarse_stage2 if stage2 is None else stage2, **kw)


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


# (device, partition_bits, steps, P, L) → the probe constants of a chunk
_PROBE_CONSTANTS: dict = {}


def probe_constants(device: torch.device, partition_bits: int, steps: int, p: int, l: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(patterns int64[S], prio int64[R], table_of int64[R]) with R = L * S
    * P: the step-wise partition patterns (P3), each probe's priority (step
    distance first, then probe rank: self-probe, then flips in order) and
    its table, table-major. Uploaded once per key and device, on a chunk's
    first use (its two waits spanned `rdf.sync.patterns` and
    `rdf.sync.priority`); every later chunk reads them without a wait."""
    key = (device, partition_bits, steps, p, l)
    got = _PROBE_CONSTANTS.get(key)
    if got is None:
        pats = stepwise_patterns(partition_bits, steps)
        with span("rdf.sync.patterns"):
            patterns = torch.as_tensor(pats, device=device)
        dist = np.asarray([bin(int(x)).count("1") for x in pats], dtype=np.int64)
        probe_rank = np.roll(np.arange(p, dtype=np.int64), -1)     # flips 1.., self 0
        prio = np.tile((dist[:, None] * p + probe_rank[None, :]).reshape(-1), l)
        with span("rdf.sync.priority"):
            got = (patterns, torch.as_tensor(prio, device=device),
                   torch.as_tensor(np.repeat(np.arange(l, dtype=np.int64), len(pats) * p),
                                   device=device))
        _PROBE_CONSTANTS[key] = got
    return got


def probe_key_set(h: torch.Tensor, home: torch.Tensor, layout: KeyLayout, steps: int,
                  multiprobe: bool, probes: Optional[torch.Tensor] = None,
                  probe_valid: Optional[torch.Tensor] = None):
    """All composite probe keys of a query batch: step-wise partition
    patterns (P3) x bit-flip probes (P5), table-major. → (probe_keys
    int64[B, R], valid bool[B, R]) with R = L * S * P."""
    b, l = h.shape
    if probes is None:
        probes, probe_valid = _probe_hashes(h, layout, multiprobe)   # [B, L, P]
    p = probes.shape[-1]
    patterns = probe_constants(h.device, layout.partition_bits, steps, p, l)[0]   # [S]
    parts = home[..., None] ^ patterns                                # [B, L, S]
    s = patterns.shape[0]
    keys = composite_keys(probes[:, :, None, :], parts[..., None], layout)
    valid = probe_valid[:, :, None, :].expand(b, l, s, p)
    return keys.reshape(b, -1), valid.reshape(b, -1)


def gather_blocks(tables: BucketTables, h: torch.Tensor, home: torch.Tensor,
                  layout: KeyLayout, steps: int, m_cap: int, multiprobe: bool,
                  probes: Optional[torch.Tensor] = None,
                  probe_valid: Optional[torch.Tensor] = None,
                  window: int = 0, align: int = 8):
    """Probe fan-out → bucket ranges → dedup and priority → ragged flatten
    at block granularity. Returns (base, table, start, end, total, bs):
    base/table/end int64[B, MB], total int64[B]; block mb covers sorted
    positions [base + mb*bs, base + (mb+1)*bs) of its table, and a slot is
    valid while its position is < end (and >= start in window mode; start
    is None in block mode).

    window > 0 is the aligned-window mode: each range's allocation starts at
    its `align`-aligned head (start & ~(align-1)) and rounds up to whole
    windows of `window` slots, so every window is aligned and `window`
    long; rows before the range's true start are masked by `start`."""
    b, l = h.shape
    dev = h.device
    probe_keys, valid = probe_key_set(h, home, layout, steps, multiprobe, probes, probe_valid)
    r = probe_keys.shape[1]
    s = len(stepwise_patterns(layout.partition_bits, steps))
    _, prio, table_of = probe_constants(dev, layout.partition_bits, steps, r // (l * s), l)
    start, length = lookup_ranges(tables, probe_keys)
    length = torch.where(valid, length, 0)
    cap = tables.capacity

    # dedup the (table, start) ranges many probes resolve to, then order the
    # survivors by priority: step distance first (home partition), then probe
    # rank (self-probe, then flips in order). When m_cap truncates, the
    # lowest-value buckets drop first. Sorts are stable, as the reference's
    # are on the CPU, so equal priorities keep (table, start) order.
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
    if window:
        if m_cap % window or window % align:
            raise ValueError(f"window {window} must divide m_cap {m_cap} and be a "
                             f"multiple of align {align}")
        bs = window
        head = start_s & (align - 1)
        alloc_start = start_s - head
        alen = torch.where(length_s > 0, (head + length_s + (bs - 1)) // bs * bs, 0)
    else:
        bs = 8 if (m_cap % 8 == 0 and m_cap >= 4096) else 1
        alloc_start = start_s
        alen = (length_s + (bs - 1)) // bs * bs
    mb_cap = m_cap // bs
    cum = torch.cumsum(alen, dim=1)
    first_block = torch.clamp((cum - alen) // bs, max=mb_cap)
    block_base = alloc_start - (cum - alen)
    end_r = start_s + length_s
    mb = torch.arange(mb_cap, device=dev).expand(b, mb_cap).contiguous()
    owner = torch.searchsorted(first_block.contiguous(), mb, right=True) - 1   # >= 0
    base_b = torch.gather(block_base, 1, owner)
    table_b = torch.gather(table_s, 1, owner)
    start_b = torch.gather(start_s, 1, owner) if window else None
    end_b = torch.gather(end_r, 1, owner)
    total = torch.clamp(length_s.sum(dim=1), max=m_cap)
    return base_b, table_b, start_b, end_b, total, bs


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
    base_b, table_b, _, end_b, total, bs = gather_blocks(
        tables, h, home, layout, steps, m_cap, multiprobe, probes, probe_valid)
    pos = base_b.repeat_interleave(bs, dim=1) + torch.arange(m_cap, device=h.device)
    slot_end = end_b.repeat_interleave(bs, dim=1)
    cand = _gather_id_blocks(tables.sorted_ids, base_b, table_b, bs)
    return torch.where((pos < slot_end) & (cand >= 0), cand, -1), total


# ---------------------------------------------------------------------------
# query: coarse scoring, select, rerank
# ---------------------------------------------------------------------------


def _i32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int32).contiguous()


def _coarse_block_scores(tier: torch.Tensor, coarse_proj: torch.Tensor,
                         queries: torch.Tensor, base_b: torch.Tensor,
                         table_b: torch.Tensor, end_b: torch.Tensor, bs: int,
                         start_b: Optional[torch.Tensor] = None, abs_starts: bool = False):
    """Coarse scores of every candidate slot, read as contiguous blocks of
    the per-table tier: by K2 in block mode, by K2b in window mode (start_b
    given), which also applies the validity mask. abs_starts: base_b holds
    absolute window starts already (the pruned subset). → (scores f32[B, M]
    with -inf invalid, pos int64[B, M], table int64[B, M])."""
    b, mb_cap = base_b.shape
    dev = base_b.device
    mb = torch.arange(mb_cap, device=dev)
    blk_start = base_b if abs_starts else base_b + mb * bs
    with full_f32():
        q_low = (queries @ coarse_proj).to(torch.bfloat16).contiguous()
    if start_b is None:
        scores = coarse_block_scores_kernel(tier, q_low, _i32(table_b), _i32(blk_start), bs)
        pos = blk_start[..., None] + torch.arange(bs, device=dev)
        scores = torch.where(pos < end_b[..., None], scores, NEG_INF_F32)
    else:
        # clamp BEFORE positions are derived: a live window within `bs` of
        # the table's end keeps covering its range (start > caprows - bs
        # implies [start, end) lies in [caprows - bs, caprows)), and scores
        # always belong to `pos`
        blk_start = torch.clamp(blk_start, max=tier.shape[1] - bs)
        live = (blk_start < end_b) & (blk_start + bs > start_b)
        scores = coarse_window_scores_kernel(
            tier, q_low, _i32(table_b), _i32(blk_start), _i32(start_b), _i32(end_b),
            live.contiguous(), bs)                                # masked [B, MB, bs]
        pos = blk_start[..., None] + torch.arange(bs, device=dev)
    return (scores.reshape(b, -1), pos.reshape(b, -1),
            table_b.repeat_interleave(bs, dim=1))


def _prune_windows(head: torch.Tensor, hp: int, q_low: torch.Tensor,
                   base_b: torch.Tensor, table_b: torch.Tensor, start_b: torch.Tensor,
                   end_b: torch.Tensor, win: int, keep: int):
    """Window pruning: score each window by its head-tier proxy (the max,
    over the head rows it overlaps, of the pooled row's dot with the query)
    and keep the `keep` best windows per query, back in slot order. →
    (blk_start, table, start, end), each int64[B, keep], with blk_start
    absolute. The proxy is not a bound: a window whose best row hides in a
    poor pool group can drop, so `keep` trades recall for scored windows."""
    l, hr, _ = head.shape
    b, mb_cap = base_b.shape
    dev = base_b.device
    mb = torch.arange(mb_cap, device=dev)
    blk_start = base_b + mb * win
    live = (blk_start < end_b) & (blk_start + win > start_b)
    # head rows overlapping [blk_start, blk_start + win): starts are aligned
    # to 8, not to hp, so one extra row covers the straddle
    gidx = (blk_start // hp)[..., None] + torch.arange(win // hp + 1, device=dev)
    rows = head[table_b.clamp(0, l - 1)[..., None], gidx.clamp(0, hr - 1)]   # [B, MB, R, cs]
    sc = torch.einsum("bmrc,bc->bmr", rows.to(torch.float32), q_low.to(torch.float32))
    row_lo = gidx * hp
    lo = torch.maximum(blk_start, start_b)[..., None]
    hi = torch.minimum(blk_start + win, end_b)[..., None]
    wscore = torch.where((row_lo + hp > lo) & (row_lo < hi), sc, NEG_INF_F32).amax(dim=2)
    wscore = torch.where(live, wscore, NEG_INF_F32)
    # exact top-keep by window score (stable: ties keep slot order), then
    # back to slot order, the JAX package's order, on which the select's
    # ties depend
    _, wi = torch.sort(wscore, dim=1, descending=True, stable=True)
    wi, _ = torch.sort(wi[:, :keep], dim=1)
    return tuple(torch.gather(x, 1, wi) for x in (blk_start, table_b, start_b, end_b))


def _strided_tournament(scores: torch.Tensor, pos: torch.Tensor, table_slot: torch.Tensor,
                        win: int, m_slab: int, m2: int):
    """Window-mode prefilter, a strided 4-way max tournament: each window's
    slots regroup into win/4 groups of 4 members spaced win/4 apart, and the
    best member of each survives, so the select runs over a 4x narrower
    slab. Strided, not consecutive: a bucket's rows are consecutive slots,
    and its best rows should not knock each other out. Ties go to the first
    member (`argmax`, as `jnp.argmax`). The identity unless win % 4 == 0 and
    m2 * 8 <= m_slab."""
    if not (win and win % 4 == 0 and m2 * 8 <= m_slab):
        return scores, pos, table_slot
    b = scores.shape[0]
    shape = (b, m_slab // win, 4, win // 4)
    am = scores.reshape(shape).argmax(dim=2, keepdim=True)        # [B, MB, 1, win/4]

    def pick(x):
        return torch.gather(x.reshape(shape), 2, am).reshape(b, -1)

    return pick(scores), pick(pos), pick(table_slot)


def _select_rows(tables: BucketTables, scores: torch.Tensor, pos: torch.Tensor,
                 table_slot: torch.Tensor, m2: int) -> torch.Tensor:
    """The corpus rows of the top-m2 slots by coarse score, i32[B, m2]
    with -1 for a dead slot. The reference takes approx_max_k on narrow
    slices and a sort otherwise; on the CPU both return the exact top-m2,
    and so does this stable sort."""
    vals, idx = rerank_ops.top_sorted(scores, m2)
    t2, p2 = torch.gather(table_slot, 1, idx), torch.gather(pos, 1, idx)
    sel_valid = torch.isfinite(vals)
    cand2 = tables.sorted_ids[t2.clamp(0, tables.num_tables - 1),
                              p2.clamp(0, tables.capacity - 1)]
    return torch.where(sel_valid & (cand2 >= 0), cand2, -1)


def _exclude_self(cand: torch.Tensor, row_ids: torch.Tensor,
                  query_ids: torch.Tensor) -> torch.Tensor:
    """Drop candidates whose user id is the query's own
    (`RandomDrawTreeMap.java:982`)."""
    uid = row_ids[cand.clamp(min=0).to(torch.int64)]
    return torch.where((cand >= 0) & (uid == query_ids[:, None]), -1, cand)


def _to_user_ids(state: ForestState, rows: torch.Tensor) -> torch.Tensor:
    return torch.where(rows >= 0, state.row_ids[rows.clamp(min=0).to(torch.int64)], -1)


def _rerank(state: ForestState, cand2: torch.Tensor, queries: torch.Tensor,
            query_ids: torch.Tensor, exclude_self: bool, k: int):
    """Exact f32 rerank of the selected candidate rows → user ids, scores;
    with a bf16 corpus copy, its two-stage form over the best 256 bf16
    prescores (the JAX package's refine at both coarse paths)."""
    if exclude_self:
        cand2 = _exclude_self(cand2, state.row_ids, query_ids)
    if state.corpus_lp is not None:
        rows, sc = rerank_ops.rerank_dense_two_stage(
            state.corpus_lp, state.corpus, cand2, queries, k,
            dup_bound=state.tables.num_tables, refine=256)
    else:
        rows, sc = rerank_ops.dedup_topk(
            cand2, rerank_ops.score_candidates(state.corpus, cand2, queries), k)
    return _to_user_ids(state, rows), sc


def _hash_stage(model: HashModel, layout: KeyLayout, opts: QueryOptions, queries: torch.Tensor):
    """The `rdf.hash` stage: K1, with margins and the margin probes in
    probe_mode "margin". → (h int64[B, L], probes, probe_valid), the probes
    None for the reference probes, which `probe_key_set` derives from h."""
    if opts.probe_mode == "margin" and opts.multiprobe:
        h, margins = hash_dense_with_margins(model, queries)
        return (h,) + _probe_hashes_margin(h, margins, layout, opts.probe_budget)
    return hash_dense(model, queries), None, None


def window_size(m_cap: int, window: int) -> int:
    """The coarse tier's window size, 0 for block mode, by the reference's
    rule: -1 picks 64-slot windows at m_cap >= 32768, 0 is block mode, > 0
    an explicit window size (block mode unless it divides m_cap)."""
    if window < 0:
        return 64 if m_cap % 64 == 0 and m_cap >= 32768 else 0
    return window if (window and m_cap % window == 0) else 0


class ChunkPlan(NamedTuple):
    """How a query's chunks run on a state's coarse tier (`_coarse_plan`)."""

    tier: Optional[str]     # "folded", "lane", or None without a coarse tier
    win: int                # window size, 0 in block mode
    align: int              # the flatten's window alignment
    prune: bool             # the head tier prunes windows (lane tier)


def _coarse_plan(state: ForestState, opts: QueryOptions) -> ChunkPlan:
    """The plan of a query on `state`: a folded tier's windows by
    `_fold_window`; a lane tier's by `window_size`, pruned by the head tier
    to the window_keep best where 0 < window_keep < m_cap // win; block mode
    without a coarse tier."""
    if state.coarse_folded is not None:
        win, align = _fold_window(state, opts.m_cap, opts.coarse_window, opts.coarse_group)
        return ChunkPlan("folded", win, align, False)
    if state.coarse_tier is None:
        return ChunkPlan(None, 0, 8, False)
    win = window_size(opts.m_cap, opts.coarse_window)
    hp, keep = opts.head_pool, opts.window_keep
    prune = (keep > 0 and win > 0 and state.coarse_head is not None and hp > 0
             and win % hp == 0 and keep < opts.m_cap // win)
    return ChunkPlan("lane", win, 8, prune)


def _prune(state: ForestState, queries, blocks, win: int, window_keep: int, head_pool: int):
    """`_prune_windows` on the flattened blocks (base_b, table_b, start_b,
    end_b, total) → the same five, base_b then absolute window starts."""
    base_b, table_b, start_b, end_b, total = blocks
    with full_f32():
        q_low = (queries @ state.coarse_proj).to(torch.bfloat16)
    return _prune_windows(state.coarse_head, head_pool, q_low, base_b, table_b, start_b, end_b,
                          win, window_keep) + (total,)


def _coarse_rest(state: ForestState, queries, query_ids, opts: QueryOptions, plan: ChunkPlan,
                 blocks, bs: int):
    """The lane tier's stages after the candidates: coarse scores of all
    candidate blocks of `bs` slots (`rdf.score`), the top `coarse_refine`
    (`rdf.select`) and their exact re-scores (`rdf.rerank`). → (ids,
    scores)."""
    base_b, table_b, start_b, end_b, _ = blocks
    m_slab = opts.window_keep * plan.win if plan.prune else opts.m_cap
    with span("rdf.score"):
        scores, pos, table_slot = _coarse_block_scores(
            state.coarse_tier, state.coarse_proj, queries, base_b, table_b, end_b, bs,
            start_b=start_b, abs_starts=plan.prune)
    m2 = min(max(opts.coarse_refine, (opts.k + 1) * state.tables.num_tables), m_slab)
    with span("rdf.select"):
        scores, pos, table_slot = _strided_tournament(scores, pos, table_slot, plan.win, m_slab,
                                                      m2)
        cand2 = _select_rows(state.tables, scores, pos, table_slot, m2)
    with span("rdf.rerank"):
        return _rerank(state, cand2, queries, query_ids, opts.exclude_self, opts.k)


def _first_dups(sorted_keys: torch.Tensor) -> torch.Tensor:
    """bool[B, M]: True where an entry equals its left neighbour."""
    return torch.cat([torch.zeros_like(sorted_keys[:, :1], dtype=torch.bool),
                      sorted_keys[:, 1:] == sorted_keys[:, :-1]], dim=1)


def query_int8(queries: torch.Tensor, coarse_proj: torch.Tensor) -> torch.Tensor:
    """The folded path's coarse query i8[B, cs]: each query's projection
    quantized with its own scale (any positive scale keeps its order),
    rounding half to even as the JAX package does."""
    with full_f32():
        q_low = queries @ coarse_proj
    qscale = 127.0 / torch.clamp(q_low.abs().amax(dim=1, keepdim=True), min=1e-20)
    return torch.clamp(torch.round(q_low * qscale), -127, 127).to(torch.int8).contiguous()


def _fold_window(state: ForestState, m_cap: int, window: int, group_slots: int) -> Tuple[int, int]:
    """(win, align) of a folded-tier query: windows start on the group grid
    and on 8-physical-row boundaries (`align`); `window` > 0 is the window
    size, else the largest power of 2 <= min(4096, m_cap/8, table size),
    since each probed range needs a window of its own."""
    capf, lanes = state.coarse_folded.shape[1:]
    fold = lanes // state.coarse_proj.shape[1]
    gsl = group_slots
    if (gsl // fold) * fold != gsl or gsl & (gsl - 1):
        raise ValueError(f"coarse_group {gsl} must be a power of 2 and a multiple of "
                         f"fold {fold}")
    align = max(gsl, 8 * fold)
    capslots = capf * fold
    if window > 0:
        win = window
    else:
        win = align
        while win * 2 <= min(4096, max(align, m_cap // 8), capslots):
            win *= 2
    if win % align or m_cap % win or win > capslots:
        raise ValueError(f"folded window {win} must be a multiple of {align}, divide "
                         f"m_cap {m_cap} and fit the table ({capslots} slots)")
    return win, align


def _fold_live(state: ForestState, blocks, win: int):
    """The folded tier's flattened blocks (base_b, table_b, start_b, end_b,
    total) → (blk, table_b, start_b, end_b, total, live): blk the absolute
    window starts, clamped into the table BEFORE positions are derived (as
    in window mode), and live whether a window holds a slot of its range."""
    base_b, table_b, start_b, end_b, total = blocks
    mb = torch.arange(base_b.shape[1], device=base_b.device)
    blk = torch.clamp(base_b + mb * win, 0, state.coarse_tier.shape[1] - win)   # slots
    return blk, table_b, start_b, end_b, total, (blk < end_b) & (blk + win > start_b)


def _query_groupmax(state: ForestState, queries, query_ids, opts: QueryOptions,
                    plan: ChunkPlan, blocks):
    """The folded tier after the candidates (`_fold_live`'s blocks of
    `plan.win`-slot windows): each folded row reduced by K3 to its best packed
    `(score << mshift) | member`, rows to groups of `coarse_group` slots by
    a max, and the select runs on one int32 per group. rows_keep=0 reranks
    every slot of the best refine/group groups (optionally over-selecting by
    `select_mult` and deduplicating ids, or re-scoring them in int8 and
    keeping the `stage2` best unique ids); rows_keep=1|2 reranks only each
    group's best (and second) slot. All packed selects are the JAX
    package's, with the same bit layouts, so the selections agree bit for
    bit: the one-operand selects keep their prefix through the top-k kernel
    over packed keys (`ops/kernels/topk_select.py`), the others sort in
    int64, where no value wraps. → (ids, scores)."""
    refine, rows_keep, stage2 = opts.coarse_refine, opts.rows_keep, opts.stage2
    folded = state.coarse_folded                  # i8[L, capf, lanes]
    l_n, _, lanes = folded.shape
    cs = state.coarse_proj.shape[1]
    fold = lanes // cs
    gsl = opts.coarse_group
    rpg = gsl // fold
    mshift = gsl.bit_length() - 1
    # the packed (score << mshift) | member must fit int32 on every path
    score_bits = (cs * 127 * 127).bit_length() + 1       # signed int8 dot
    if score_bits + mshift > 32:
        raise ValueError(f"folded groupmax pack overflow: score bits {score_bits} + "
                         f"member bits {mshift} > 32")
    blk, table_b, start_b, end_b, _, live = blocks
    b, mb_cap = blk.shape
    dev = queries.device
    wpr = plan.win // fold
    ngw = plan.win // gsl
    with span("rdf.score"):
        qi8 = query_int8(queries, state.coarse_proj)
        rs = torch.where(live, blk // fold, -1)
        # rows_keep 2 at rpg 1: a group is one row, and its second slot comes
        # from the kernel's second output
        emit2 = rows_keep == 2 and rpg == 1
        out = coarse_rowmax_kernel(folded, qi8, _i32(table_b), _i32(rs), wpr, rpg, mshift, emit2)
        rowpk, rowpk2 = out if emit2 else (out, None)
        # rows with no live slot (flatten round-up past `end`, the aligned head
        # before `start`) are dead; rows straddling a boundary keep their max,
        # a fold-granular superset of real corpus rows
        slot0 = blk[..., None] + torch.arange(wpr, device=dev) * fold
        row_live = (live[..., None] & (slot0 < end_b[..., None])
                    & (slot0 + fold > start_b[..., None]))
        rowpk = torch.where(row_live, rowpk.view(b, mb_cap, wpr), I32_DEAD)
        if rowpk2 is not None:
            rowpk2 = torch.where(row_live, rowpk2.view(b, mb_cap, wpr), I32_DEAD)
        g4 = rowpk.reshape(b, mb_cap, ngw, rpg)
        g1 = g4.amax(dim=-1)                                        # [B, MB, NGW]
    cap = state.tables.capacity
    sorted_ids = state.tables.sorted_ids
    if rows_keep == 0:
        width = mb_cap * ngw
        rtarget = max(1, min(refine // gsl, width))
        rgg = max(1, min(rtarget * opts.select_mult, width))
        with span("rdf.select"):
            bits_w = max(1, (width - 1).bit_length())
            sh = max(0, score_bits + mshift - (32 - bits_w))
            if sh <= mshift + 8:
                # one-operand select: the group value quantized to its top
                # 32 - bits_w bits, the group index in the low bits (the
                # kernel packs them; the score bound keeps the value under
                # its clamp's top); the dead sentinel clamps to lo, below
                # every live value
                lo = -(1 << (31 - bits_w))
                pack_s = topk_packed_select(g1.reshape(b, width), rgg, sh, bits_w)
                sel = (pack_s & ((1 << bits_w) - 1)).long()
                live_sel = (pack_s >> bits_w) > lo
            else:
                flat = g1.reshape(b, width).to(torch.int64)
                vals, sel = torch.sort(flat, dim=1, descending=True, stable=True)
                sel, live_sel = sel[:, :rgg], vals[:, :rgg] != I32_DEAD
            mbi = sel // ngw
            base = torch.gather(blk, 1, mbi) + (sel % ngw) * gsl        # [B, RGG]
            t2 = torch.gather(table_b, 1, mbi)
            sel_valid = live_sel.repeat_interleave(gsl, dim=1)
            # every slot of a selected group; groups are gsl-aligned and never
            # straddle the table's end
            id_cap = sorted_ids.shape[1]
            basec = base.clamp(0, (id_cap - gsl) // gsl * gsl)
            cand2 = sorted_ids[t2.clamp(0, l_n - 1)[..., None],
                               basec[..., None] + torch.arange(gsl, device=dev)]
            cand2 = cand2.reshape(b, rgg * gsl)
            cand2 = torch.where(sel_valid & (cand2 >= 0), cand2, -1)
        if 0 < stage2 < rgg * gsl:
            with span("rdf.stage2"):
                cand2 = _stage2(folded, qi8, base, t2, cand2, gsl, rpg, stage2)
        elif rgg > rtarget:
            with span("rdf.stage2"):
                cand2 = _dedup_selected(cand2, cap, rtarget * gsl)
    else:
        with span("rdf.select"):
            if rows_keep == 2:
                if rowpk2 is not None:
                    g2 = rowpk2.reshape(b, mb_cap, ngw)
                else:
                    # the group's second-best row (member bits make packed values
                    # unique, so equality finds the winner row)
                    g2 = torch.where(g4 == g1[..., None], I32_DEAD, g4).amax(dim=-1)
                gsel = torch.cat([g1, g2], dim=2)                   # [B, MB, 2*NGW]
            else:
                gsel = g1
            keep = gsel.shape[2] // ngw
            width = mb_cap * ngw * keep
            flat = gsel.reshape(b, width).to(torch.int64)
            rg = min(refine, width)
            bits_w = max(1, (width - 1).bit_length())
            q_bits = 32 - bits_w - mshift
            if 0 <= score_bits + mshift - q_bits <= 10 and q_bits >= 8:
                # one-operand select carrying the member bits: quantized value,
                # member, flat index; dead clamps strictly below every live value
                sh = score_bits + mshift - q_bits
                lo = -(1 << (q_bits - 1))
                qv = torch.where(flat == I32_DEAD, lo, torch.clamp(flat >> sh, min=lo + 1))
                pack = ((qv << (bits_w + mshift)) | ((flat & (gsl - 1)) << bits_w)
                        | torch.arange(width, device=dev))        # fits int32
                pack_s = topk_select(pack.to(torch.int32), rg, descending=True)
                sel = (pack_s & ((1 << bits_w) - 1)).long()
                member = (pack_s >> bits_w) & (gsl - 1)
                sel_valid = (pack_s >> (bits_w + mshift)) > lo
            else:
                vals, sel = torch.sort(flat, dim=1, descending=True, stable=True)
                selpk, sel = vals[:, :rg], sel[:, :rg]
                member = selpk & (gsl - 1)
                sel_valid = selpk != I32_DEAD
            mbi = sel // (ngw * keep)
            pos = torch.gather(blk, 1, mbi) + (sel % ngw) * gsl + member
            t2 = torch.gather(table_b, 1, mbi)
            cand2 = sorted_ids[t2.clamp(0, l_n - 1), pos.clamp(0, cap - 1)]
            cand2 = torch.where(sel_valid & (cand2 >= 0), cand2, -1)
    with span("rdf.rerank"):
        return _rerank(state, cand2, queries, query_ids, opts.exclude_self, opts.k)


def _stage2(folded: torch.Tensor, qi8: torch.Tensor, base: torch.Tensor, t2: torch.Tensor,
            cand2: torch.Tensor, gsl: int, rpg: int, stage2: int) -> torch.Tensor:
    """Staged rerank: re-score every slot of the selected groups with the
    same int8 dots K3 reduced away, deduplicate ids keeping each id's best
    copy, and keep the `stage2` best unique ids (-1 padded) for the exact
    rerank."""
    l_n, capf, lanes = folded.shape
    b, rgg = base.shape
    cs = qi8.shape[1]
    fold = lanes // cs
    rowf = base.clamp(0, capf * fold - gsl) // fold
    tf = t2.clamp(0, l_n - 1)
    if rpg > 1:
        rowf = (rowf[..., None] + torch.arange(rpg, device=base.device)).reshape(b, rgg * rpg)
        tf = tf.repeat_interleave(rpg, dim=1)
    frows = folded[tf, rowf].view(b, -1, fold, cs)             # [B, R2, fold, cs]
    slot_sc = (frows.to(torch.int32) * qi8.to(torch.int32)[:, None, None, :]).sum(
        -1, dtype=torch.int32).reshape(b, rgg * gsl)           # (row, slot) = cand2 order
    # sort 1: (id asc, -score asc), so each id's best copy leads; then the
    # `stage2` smallest (-score, id) of the unique ids: ids ascend after
    # sort 1, so that is the stable sort's order by score. The sentinel
    # 2^30 clears every real row index (< Npad) and every negated score:
    # |score| <= cs*127^2, which is 4,129,024 at the widest tier width
    # (cs 256), so -score + 2^30 lies in (0, 2^31), a dead entry's 2^31
    # above it, and the key ((-score + 2^30) << 31) | id stays below 2^63
    sent = 1 << 30
    idk = torch.where(cand2 >= 0, cand2, sent).to(torch.int64)
    negsc = torch.where(cand2 >= 0, -slot_sc, sent).to(torch.int64)
    key, _ = torch.sort((idk << 32) | (negsc + 2**31), dim=1)
    id_s = key >> 32
    neg_s = (key & 0xFFFFFFFF) - 2**31
    neg_s = torch.where(_first_dups(id_s) | (id_s == sent), sent, neg_s)
    top = topk_select(((neg_s + sent) << 31) | id_s, stage2, descending=False)
    return torch.where(top < (2 * sent) << 31, top & (2**31 - 1), -1)


def _dedup_selected(cand2: torch.Tensor, cap: int, width: int) -> torch.Tensor:
    """Deduplicate the over-selected candidate ids keeping select order,
    then truncate to `width` (-1 padded). With room for the rank beside the
    id (cap < 2^27), one packed key per sort: the row id in the high bits,
    the select rank quantized to the low bits, so truncation moves only
    within one quantum of rank, as in the JAX package."""
    b, m = cand2.shape
    dev = cand2.device
    big = 2**31 - 1
    bits_id = cap.bit_length()
    rank_bits = 31 - bits_id
    rank = torch.arange(m, device=dev)
    if rank_bits >= 4:
        rq_sh = max(0, (m - 1).bit_length() - rank_bits)
        sent = (1 << bits_id) - 1                     # > any real row id
        idk = torch.where(cand2 >= 0, cand2, sent).to(torch.int64)
        k1, _ = torch.sort((idk << rank_bits) | (rank >> rq_sh), dim=1)
        id_s = k1 >> rank_bits
        rq = k1 & ((1 << rank_bits) - 1)
        k2 = torch.where(_first_dups(id_s) | (id_s == sent), big, (rq << bits_id) | id_s)
        k2, _ = torch.sort(k2, dim=1)
        k2 = k2[:, :width]
        return torch.where(k2 == big, -1, k2 & ((1 << bits_id) - 1))
    idk = torch.where(cand2 >= 0, cand2, big).to(torch.int64)
    idk_s, rank_s = torch.sort(idk, dim=1, stable=True)      # (id, rank) order
    key2 = torch.where(_first_dups(idk_s) | (idk_s == big), rank_s + (1 << 30), rank_s)
    _, order = torch.sort(key2, dim=1, stable=True)
    out = torch.gather(idk_s, 1, order)[:, :width]
    return torch.where(out == big, -1, out)


def _chunk_chain(state: ForestState, queries: torch.Tensor, layout: KeyLayout,
                 opts: QueryOptions, plan: ChunkPlan) -> Optional[ChainGraphs]:
    """The hash stage and the candidates' lookup and flatten of this chunk
    as CUDA graphs (`index/chunk_graphs.py`), the partitions' product eager
    between them; or None where the chunk runs them eagerly: off the card,
    in block mode (`plan.win` 0, as always without a coarse tier), for a
    hash other than K1's (the p-stable product calls cuBLAS, the other
    index transforms upload constants), and on a key's first use. The key:
    the calling thread, the device, the chunk's shape and dtype, the layout,
    and the options that change the graphs (`QueryOptions.chain_key`)."""
    if not (plan.win and queries.is_cuda
            and state.model.family == "angle" and state.model.type_of_index == "original"):
        return None
    key = (threading.get_ident(), queries.device, queries.shape, queries.dtype,
           layout) + opts.chain_key()

    def build():
        def between(h, probes, probe_valid):
            return (partition_of_hash(h, state.part_proj),)

        def second(h, probes, probe_valid, home):
            return gather_blocks(state.tables, h, home, layout, opts.steps, opts.m_cap,
                                 opts.multiprobe, probes, probe_valid, window=plan.win,
                                 align=plan.align)[:5]

        return ChainGraphs(queries, functools.partial(_hash_stage, state.model, layout, opts),
                           between, second)

    return chain_for(state, key, build)


def _query_chunk(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                 layout: KeyLayout, opts: QueryOptions, plan: ChunkPlan,
                 chain: Optional[ChainGraphs]):
    """One chunk of the batched ANN query → (ids i32[B, k] user ids with -1
    padding, scores f32[B, k], candidate counts int64[B]): the hash, the
    candidates (with the lane tier's window pruning or the folded tier's
    window liveness), then `_coarse_rest` on a lane tier, `_query_groupmax`
    on a folded one, or an exact rerank of every candidate. With `chain`
    (`_chunk_chain`) the hash and the lookup and flatten replay as CUDA
    graphs inside the same spans; the kernels and their order are those of
    `chain` None, every stage eager, so the answers are equal bit for bit."""
    with span("rdf.hash"):
        if chain is None:
            h, probes, probe_valid = _hash_stage(state.model, layout, opts, queries)
        else:
            h = chain.run_first(queries)[0]
            hash_kernel.LAUNCHES += 1                 # the replay launched K1 once
    if plan.tier is None:                     # block mode: never a chain
        home = partition_of_hash(h, state.part_proj)
        cand, total = gather_candidates(state.tables, h, home, layout, opts.steps, opts.m_cap,
                                        opts.multiprobe, probes, probe_valid)
        if opts.exclude_self:
            cand = _exclude_self(cand, state.row_ids, query_ids)
        if state.corpus_lp is not None:
            rows, scores = rerank_ops.rerank_dense_two_stage(
                state.corpus_lp, state.corpus, cand, queries, opts.k, dup_bound=h.shape[1])
        else:
            rows, scores = rerank_ops.rerank_dense(state.corpus, cand, queries, opts.k,
                                                   dup_bound=h.shape[1])
        return _to_user_ids(state, rows), scores, total
    with span("rdf.candidates"):
        home = partition_of_hash(h, state.part_proj)
        if chain is None:
            *blocks, bs = gather_blocks(state.tables, h, home, layout, opts.steps, opts.m_cap,
                                        opts.multiprobe, probes, probe_valid, window=plan.win,
                                        align=plan.align)
        else:
            with span("rdf.graph.replay"):
                *blocks, total = chain.run_second(home)
            # the static blocks are read by this chunk's later kernels, which
            # run before the next replay in stream order; `total` outlives the
            # chunk
            blocks, bs = (*blocks, total.clone()), plan.win
        if plan.tier == "folded":
            blocks = _fold_live(state, blocks, plan.win)
        elif plan.prune:
            blocks = _prune(state, queries, blocks, plan.win, opts.window_keep, opts.head_pool)
    if plan.tier == "folded":
        ids, scores = _query_groupmax(state, queries, query_ids, opts, plan, blocks)
    else:
        ids, scores = _coarse_rest(state, queries, query_ids, opts, plan, blocks, bs)
    return ids, scores, blocks[4]                 # every form of blocks holds total 5th


def _query_dense(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                 layout: KeyLayout, opts: QueryOptions):
    """One chunk, replayed where `_chunk_chain` has graphs."""
    plan = _coarse_plan(state, opts)
    return _query_chunk(state, queries, query_ids, layout, opts, plan,
                        _chunk_chain(state, queries, layout, opts, plan))


def query_dense(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                layout: KeyLayout, **kw):
    """The batched ANN query core, under the public name the JAX package
    gives its jitted form: `QueryOptions`' fields as keywords → (ids i32[B,
    k] user ids with -1 padding, scores f32[B, k], candidate counts
    int64[B]). On the card, a chunk of a lane tier in window mode or of a
    folded tier whose key this state has seen replays its hash stage and
    its candidates' lookup and flatten as CUDA graphs (`_chunk_chain`)."""
    return _query_dense(state, queries, query_ids, layout, QueryOptions(**kw))


def _query_many(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                layout: KeyLayout, chunk: int, opts: QueryOptions):
    """`query_dense_many` on an options record. A partial last chunk runs
    eagerly: its size changes from call to call."""
    plan = _coarse_plan(state, opts)
    out = []
    for c0 in range(0, queries.shape[0], chunk):
        q = queries[c0:c0 + chunk]
        with span("rdf.chunk"):
            chain = _chunk_chain(state, q, layout, opts, plan) if q.shape[0] == chunk else None
            out.append(_query_chunk(state, q, query_ids[c0:c0 + chunk], layout, opts, plan,
                                    chain))
    return tuple(torch.cat(parts) for parts in zip(*out))


def query_dense_many(state: ForestState, queries: torch.Tensor, query_ids: torch.Tensor,
                     layout: KeyLayout, chunk: int = 256, **kw):
    """Whole-query-set search, `chunk` queries at a time (bounds peak
    memory). Takes `query_dense`'s keyword arguments."""
    return _query_many(state, queries, query_ids, layout, chunk, QueryOptions(**kw))


# ---------------------------------------------------------------------------
# host-facing forest
# ---------------------------------------------------------------------------


class RDFForest:
    """Host orchestrator for a dense forest (`DensevectorRDFInit` at the
    index layer). Everything lives on `device` (default: the first CUDA
    card; `device="cpu"` for the CPU)."""

    def __init__(self, conf: RDFConfig, model: Optional[HashModel] = None,
                 seed: Optional[int] = None, device: Device = None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        self.model = model.to(self.device) if model is not None else generate_model(
            conf, seed, device=self.device)
        self.part_proj = generate_partition_projections(conf, seed, device=self.device)
        self.state: Optional[ForestState] = None

    def fit(self, batch: DenseBatch) -> "RDFForest":
        self.state = fit_dense(self.conf, batch, model=self.model,
                               part_proj=self.part_proj, device=self.device)
        return self

    def add(self, batch: DenseBatch) -> "RDFForest":
        """Incremental insert: refit on the live rows (a prefix of the
        corpus) followed by `batch`, concatenated on the device
        (`RandomDrawTreeMap.put:1557` inserts one point into the trie)."""
        if self.state is None:
            return self.fit(batch)
        old_n = self.size()
        values = torch.cat([self.state.corpus[:old_n, :batch.dim],
                            torch.as_tensor(batch.values, dtype=torch.float32).to(self.device)])
        ids = torch.cat([self.state.row_ids[:old_n],
                         torch.as_tensor(batch.ids, dtype=torch.int32).to(self.device)])
        return self.fit(DenseBatch(ids, values))

    def query(self, queries: np.ndarray, steps: int = 0,
              query_ids: Optional[np.ndarray] = None, k: Optional[int] = None,
              **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays. Takes
        `query_device`'s keyword arguments."""
        with span("rdf.query"):
            ids, scores = self.query_device(queries, steps=steps, query_ids=query_ids, k=k,
                                            **kw)
            with span("rdf.sync.answers"):
                ids = ids.cpu().numpy()
            with span("rdf.sync.answers"):
                scores = scores.cpu().numpy()
        return ids, scores

    def query_device(self, queries, steps: int = 0, query_ids=None,
                     k: Optional[int] = None, multiprobe: bool = True,
                     probe_mode: str = "reference", probe_budget: int = 8,
                     coarse_refine: Optional[int] = None, m_cap: Optional[int] = None,
                     coarse_window: Optional[int] = None, window_keep: Optional[int] = None,
                     coarse_group: Optional[int] = None, rows_keep: Optional[int] = None,
                     select_mult: Optional[int] = None, stage2: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the forest's device.
        Queries are taken `conf.query_batch_size` at a time; the options not
        given are the config's (`query_options`)."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        with span("rdf.sync.upload"):
            qd = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        exclude = query_ids is not None
        if exclude:
            with span("rdf.sync.upload"):
                qids = torch.as_tensor(query_ids, dtype=torch.int32).to(self.device)
        else:
            qids = torch.full((qd.shape[0],), -1, dtype=torch.int32, device=self.device)
        opts = query_options(
            self.conf, steps=steps, k=k, multiprobe=multiprobe, exclude_self=exclude,
            probe_mode=probe_mode, probe_budget=probe_budget, coarse_refine=coarse_refine,
            m_cap=m_cap, coarse_window=coarse_window, window_keep=window_keep,
            coarse_group=coarse_group, rows_keep=rows_keep, select_mult=select_mult,
            stage2=stage2)
        ids, scores, _ = _query_many(self.state, qd, qids, self.layout,
                                     self.conf.query_batch_size, opts)
        return above_threshold(ids, scores, self.conf.similarity_threshold)

    def live_ids(self) -> torch.Tensor:
        """The user ids of the fitted rows, i32[N] in row order: the rows
        the tables hold, whatever their ids' sign (the JAX package reads a
        negative id as the -1 padding)."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return self.state.row_ids[live_rows(self.state.tables)]

    def size(self) -> int:
        return 0 if self.state is None else int(live_rows(self.state.tables).shape[0])

    def index_bytes_per_vector(self) -> float:
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return self.state.tables.index_bytes() / max(1, self.size())

    def sub_index_distribution(self) -> np.ndarray:
        """Objects per (table, sub-index), int64[L, 2**partitionBits]
        (`allSubIndexObjectsNumberDistribution`, `RandomDrawTreeMap.java:
        2793-2802`). The sub-index is the key's top bits: keys are unflipped
        to their unsigned values before the shift. Counted on the device."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return sub_index_counts(self.state.tables, self.layout)


def above_threshold(ids: torch.Tensor, scores: torch.Tensor, thr: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact-score post-filter (config.py `similarity_threshold`, the
    live form of `RandomDrawTreeMap.java:856-868`): answers scoring below
    `thr` become -1 with score -inf; `thr` <= 0 keeps every answer."""
    if thr <= 0.0:
        return ids, scores
    keep = scores >= thr
    return torch.where(keep, ids, -1), torch.where(keep, scores, NEG_INF_F32)


def live_rows(tables: BucketTables) -> torch.Tensor:
    """The corpus rows the tables hold, int64[N] ascending: padding rows are
    known by position (the fit gives them the -1 row), never by their id."""
    rows = tables.sorted_ids[0]
    return rows[rows >= 0].sort().values.to(torch.int64)


def sub_index_counts(tables: BucketTables, layout: KeyLayout) -> np.ndarray:
    """Live rows per (table, sub-index), int64[L, 2**partitionBits]: the
    sub-index is the key's top bits, read after unflipping the keys to their
    unsigned values. Counted on the tables' device."""
    keys = from_key(tables.sorted_keys)                              # [L, cap]
    ids = tables.sorted_ids[:, :keys.shape[1]]
    parts = keys >> (layout.seg_bits + layout.consumed_bits)
    l = keys.shape[0]
    np_parts = 1 << layout.partition_bits
    flat = parts + np_parts * torch.arange(l, device=keys.device)[:, None]
    counts = torch.bincount(flat[ids >= 0], minlength=l * np_parts)
    return counts.view(l, np_parts).cpu().numpy()
