"""The sharded forest: a full forest over each corpus shard, one top-k merge.

Counterpart of `similaritysearchbyrdf_tpu/parallel/sharded_forest.py`, the
distributed design the reference paper sketches (content-partitioned
sub-indexes on many nodes):

  * the corpus is cut into shards of `nloc` rows; every shard holds a
    complete forest (all L tables) over its rows, built with no
    communication;
  * a query batch goes to every shard; candidate generation, the coarse
    tier and the exact rerank are the single-device pipeline
    (`index/forest._query_dense`), run on each shard in turn;
  * the shards' top-k lists are concatenated in shard order and merged by
    one stable descending sort (ties go to the earlier shard, as the JAX
    package's `lax.top_k` gives them); across processes the lists first
    pass through one all-gather, and every process runs the same merge.

A sharded state is a list of single-device states, one per shard of this
process. The shard layout is the JAX package's row for row: `nloc =
pad128(ceil(n / S))`, shard s holds rows [s*nloc, (s+1)*nloc), and its
padding rows take part in the fit as there (the maximum key, the -1 row),
so each shard's tables equal the JAX shard's. The padding is known by
position (`n_live`, a prefix of the shard), so a negative user id is a
live row; the JAX package reads it as padding and drops it.

The coarse tier of a sharded fit is not the single fit's, as in the JAX
package: the seeded random QR basis (`conf.seed ^ 0x5EED`) whatever
`coarse_proj_mode` says, an int8 scale of each shard's own, the folded tier
as a view of the shard's table-ordered rows, and the head tier from
`head_tier_traced`.

The sparse forest shards the same way (`fit_sparse_sharded`); its query is
the classic path (K1 on densified rows, then `rerank_sparse_merge`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..index.bucket_table import KeyLayout, build_tables
from ..index.forest import (ForestState, QueryOptions, _build_coarse_tier, _keys_for_corpus,
                            _pad_to, _query_dense, head_tier_traced, live_rows, query_options)
from ..index.partitioner import generate_partition_projections
from ..index.sparse_forest import (_DENSIFY_DIM_LIMIT, _GATHER_CHUNK_BYTES, SparseForestState,
                                   _keys_for_sparse_corpus, _query_sparse)
from ..models.families import HashModel, generate_model
from ..ops import rerank as rerank_ops
from ..vectors import DenseBatch, SparseBatch
from .mesh import ForestMesh, make_forest_mesh


# ---------------------------------------------------------------------------
# the merge (shared by every sharded engine)
# ---------------------------------------------------------------------------


def merge_topk(mesh: ForestMesh, ids: List[torch.Tensor], scores: List[torch.Tensor], k: int,
               mask: str = "finite") -> Tuple[torch.Tensor, torch.Tensor]:
    """The one merge of every sharded engine's read path: this process's
    shards' (ids, scores) [B, k] lists, gathered over the processes into
    global shard order, concatenated per query and cut to the best k by a
    stable descending sort (ties to the earlier shard). An id stays where
    its merged score is finite (mask "finite": the flat engines and IVF)
    or above -inf ("above_neg_inf": the forests), else -1. → (ids i32[B,
    k], scores f32[B, k]) on the first shard's device."""
    dev = mesh.comm_device
    g_ids = mesh.all_gather(torch.stack([i.to(dev, torch.int32) for i in ids]))
    g_sc = mesh.all_gather(torch.stack([s.to(dev, torch.float32) for s in scores]))
    s, b, kk = g_ids.shape
    flat_ids = g_ids.permute(1, 0, 2).reshape(b, s * kk)
    flat_sc = g_sc.permute(1, 0, 2).reshape(b, s * kk)
    m_sc, order = torch.sort(flat_sc, dim=1, descending=True, stable=True)
    m_sc = m_sc[:, :k].contiguous()
    m_ids = torch.gather(flat_ids, 1, order[:, :k])
    keep = torch.isfinite(m_sc) if mask == "finite" else m_sc > float("-inf")
    return torch.where(keep, m_ids, -1), m_sc


def merge_totals(mesh: ForestMesh, totals: List[torch.Tensor]) -> torch.Tensor:
    """The candidate counts [B] summed over every shard of every process."""
    dev = mesh.comm_device
    local = torch.stack([t.to(dev, torch.int64) for t in totals]).sum(dim=0)
    return mesh.all_reduce(local, "sum")


def _on(t: torch.Tensor, dev: torch.device, cache: Dict) -> torch.Tensor:
    """`t` on `dev`, copied once per device per call."""
    if dev not in cache:
        cache[dev] = t.to(dev)
    return cache[dev]


# ---------------------------------------------------------------------------
# dense fit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedForestState:
    """This process's forest shards, in global order: `shards[i]` is shard
    `first_shard + i`, a single-device `ForestState` over `nloc` rows of
    which the first `n_live[i]` are live."""

    shards: List[ForestState]
    n_live: List[int]
    nloc: int
    first_shard: int = 0

    @property
    def model(self) -> HashModel:
        return self.shards[0].model

    @property
    def part_proj(self) -> torch.Tensor:
        return self.shards[0].part_proj

    def live_ids(self) -> torch.Tensor:
        """The user ids of this process's live rows, in global row order,
        on the first shard's device."""
        dev = self.shards[0].device
        return torch.cat([st.row_ids[live_rows(st.tables)].to(dev) for st in self.shards])


def _replicas(model: HashModel, part_proj: torch.Tensor, devices) -> Dict:
    """(model, part_proj) on each distinct device of the mesh."""
    return {dev: (model.to(dev), part_proj.to(dev)) for dev in dict.fromkeys(devices)}


def _local_fit(conf: RDFConfig, layout: KeyLayout, values: torch.Tensor,
               row_ids: torch.Tensor, n_live: int, model: HashModel, part_proj: torch.Tensor
               ) -> ForestState:
    """One shard's forest from its rows f32[nloc, D] and ids i32[nloc] on its
    device: rows from `n_live` on are padding and take part in the sort
    with the maximum key and the -1 row, the bucket arrays are `nloc` wide,
    as in the JAX package's `_local_fit`. The coarse basis is the identity
    at coarse_dim >= D, else the seeded random QR basis, whatever
    `coarse_proj_mode` says (`sharded_forest.py:209-217` of the JAX
    package)."""
    nloc = values.shape[0]
    keys = _keys_for_corpus(model, part_proj, values, n_live, layout,
                            min(conf.fit_batch_size, nloc))
    pos = torch.arange(nloc, dtype=torch.int32, device=values.device)
    ids = torch.where(pos < n_live, pos, -1).expand_as(keys)
    tables = build_tables(keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nloc)
    del keys, ids
    proj = tier = head = None
    if conf.coarse_dim:
        proj, tier = _build_coarse_tier(values, tables.sorted_ids, conf.coarse_dim,
                                        conf.coarse_dtype, conf.seed, proj_mode="random")
        if conf.coarse_layout == "lane" and conf.coarse_head_pool:
            head = head_tier_traced(tier, tables.sorted_ids, conf.coarse_head_pool)
    return ForestState(
        model=model, part_proj=part_proj, tables=tables, corpus=values, row_ids=row_ids,
        corpus_lp=values.to(torch.bfloat16) if conf.rerank_dtype == "bfloat16" else None,
        coarse_proj=proj, coarse_tier=tier, coarse_head=head, coarse_layout=conf.coarse_layout)


def _shard_slices(n: int, nloc: int, count: int, first: int = 0):
    """(lo, n_live) of shards first .. first+count-1 over n rows laid out
    nloc to a shard."""
    return [(min(s * nloc, n), int(np.clip(n - s * nloc, 0, nloc)))
            for s in range(first, first + count)]


def _rows(a, lo: int, n_live: int, nloc: int, dtype: torch.dtype, dev: torch.device,
          fill=0) -> torch.Tensor:
    """Rows [lo, lo + n_live) of a numpy array or tensor on `dev`, padded
    with `fill` to `nloc` rows."""
    part = torch.as_tensor(a[lo:lo + n_live]).to(dev, dtype)
    out = torch.full((nloc,) + tuple(part.shape[1:]), fill, dtype=dtype, device=dev)
    out[:n_live] = part
    return out


def _fit_shards(conf: RDFConfig, mesh: ForestMesh, batch: DenseBatch, nloc: int,
                slices, model: Optional[HashModel], part_proj: Optional[torch.Tensor]
                ) -> ShardedForestState:
    if conf.coarse_layout not in ("lane", "folded"):
        raise ValueError(f"unknown coarse_layout {conf.coarse_layout!r}")
    if conf.coarse_dim and conf.coarse_layout == "folded" and conf.coarse_dtype != "int8":
        raise ValueError("coarse_layout='folded' requires coarse_dtype='int8' (the groupmax "
                         "kernel packs integer scores)")
    dev0 = mesh.devices[0]
    model = model if model is not None else generate_model(conf, device=dev0)
    if part_proj is None:
        part_proj = generate_partition_projections(conf, device=dev0)
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    reps = _replicas(model, part_proj, mesh.devices)
    shards = []
    for dev, (lo, n_live) in zip(mesh.devices, slices):
        values = _rows(batch.values, lo, n_live, nloc, torch.float32, dev)
        row_ids = _rows(batch.ids, lo, n_live, nloc, torch.int32, dev, fill=-1)
        shards.append(_local_fit(conf, layout, values, row_ids, n_live, *reps[dev]))
    return ShardedForestState(shards=shards, n_live=[nl for _, nl in slices], nloc=nloc,
                              first_shard=mesh.first_shard)


def fit_sharded(conf: RDFConfig, batch: DenseBatch, mesh: Optional[ForestMesh] = None,
                model: Optional[HashModel] = None, part_proj: Optional[torch.Tensor] = None
                ) -> Tuple[ShardedForestState, ForestMesh]:
    """The fit from a corpus this process holds whole (numpy values or a
    tensor): `nloc = pad128(ceil(n / S))` rows a shard, shard s the rows
    [s*nloc, (s+1)*nloc). For corpora no process can hold, use
    `fit_sharded_distributed`."""
    mesh = mesh or make_forest_mesh()
    nloc = _pad_to(int(np.ceil(batch.n / mesh.n_shards)), 128)
    slices = _shard_slices(batch.n, nloc, mesh.n_local, mesh.first_shard)
    return _fit_shards(conf, mesh, batch, nloc, slices, model, part_proj), mesh


def distributed_nloc(mesh: ForestMesh, n: int, nloc: Optional[int] = None) -> int:
    """Rows a shard of a multi-process fit: `nloc` when given, else the
    largest need ceil(n / local shards) over the processes, padded to 128
    (an all-reduce max; the JAX package gathers the needs)."""
    if nloc is not None:
        return int(nloc)
    need = int(np.ceil(n / mesh.n_local))
    return _pad_to(int(mesh.host_max(need)[0]), 128)


def fit_sharded_distributed(conf: RDFConfig, local_batch: DenseBatch,
                            mesh: Optional[ForestMesh] = None,
                            model: Optional[HashModel] = None,
                            part_proj: Optional[torch.Tensor] = None,
                            nloc: Optional[int] = None
                            ) -> Tuple[ShardedForestState, ForestMesh]:
    """The multi-process fit: every process supplies only its own rows,
    laid over its shards `nloc` at a time (`distributed_nloc`), so the
    global corpus never exists in one process. The model and partition
    chains come from `conf.seed` alike in every process."""
    mesh = mesh or make_forest_mesh()
    nloc = distributed_nloc(mesh, local_batch.n, nloc)
    slices = _shard_slices(local_batch.n, nloc, mesh.n_local)
    return _fit_shards(conf, mesh, local_batch, nloc, slices, model, part_proj), mesh


# ---------------------------------------------------------------------------
# dense query
# ---------------------------------------------------------------------------


def query_shards(state: ShardedForestState, queries: torch.Tensor,
                 query_ids: Optional[torch.Tensor], layout: KeyLayout,
                 opts: QueryOptions) -> List[Tuple[torch.Tensor, ...]]:
    """Each shard's own (ids [B, k], scores [B, k], total [B]) of the
    single-device `_query_dense`, on the shard's device. Exclusion
    (`opts.exclude_self`) needs `query_ids`."""
    qcache, icache = {}, {}
    out = []
    for st in state.shards:
        dev = st.device
        qi = (_on(query_ids, dev, icache) if query_ids is not None
              else torch.full((queries.shape[0],), -1, dtype=torch.int32, device=dev))
        out.append(_query_dense(st, _on(queries, dev, qcache), qi, layout, opts))
    return out


def make_query_fn(mesh: ForestMesh, layout: KeyLayout, steps: int = 0, m_cap: int = 4096,
                  k: int = 10, multiprobe: bool = True, exclude_self: bool = True,
                  probe_mode: str = "reference", probe_budget: int = 8,
                  coarse_refine: int = 2048, coarse_window: int = -1, window_keep: int = 0,
                  head_pool: int = 0, coarse_group: int = 64, rows_keep: int = 0,
                  select_mult: int = 1, stage2: int = 0) -> Callable:
    """The sharded query step: fn(state, queries [B, D], query_ids [B] or
    None, chunk=None) → (ids i32[B, k], scores f32[B, k], total int64[B])
    on the first shard's device, the same in every process. `chunk` runs
    the queries that many at a time (bounds each shard's memory)."""
    opts = QueryOptions(steps=steps, m_cap=m_cap, k=k, multiprobe=multiprobe,
                        exclude_self=exclude_self, probe_mode=probe_mode,
                        probe_budget=probe_budget, coarse_refine=coarse_refine,
                        coarse_window=coarse_window, window_keep=window_keep,
                        head_pool=head_pool, coarse_group=coarse_group, rows_keep=rows_keep,
                        select_mult=select_mult, stage2=stage2)
    # a call without query ids excludes nothing
    no_ids = dataclasses.replace(opts, exclude_self=False)

    def step(state, queries, query_ids, o):
        outs = query_shards(state, queries, query_ids, layout, o)
        ids, scores = merge_topk(mesh, [r[0] for r in outs], [r[1] for r in outs], k,
                                 mask="above_neg_inf")
        return ids, scores, merge_totals(mesh, [r[2] for r in outs])

    def many(state, queries, query_ids=None, chunk: Optional[int] = None):
        o = no_ids if query_ids is None else opts
        q = queries.shape[0]
        if chunk is None or chunk >= q:
            return step(state, queries, query_ids, o)
        outs = [step(state, queries[c0:c0 + chunk],
                     None if query_ids is None else query_ids[c0:c0 + chunk], o)
                for c0 in range(0, q, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return many


class ShardedRDFForest:
    """Host orchestrator for the sharded forest (the query surface of
    `RDFForest`). The mesh defaults to one shard a visible card; give
    `make_forest_mesh(devices=[...])` for the CPU or several shards a
    card."""

    def __init__(self, conf: RDFConfig, mesh: Optional[ForestMesh] = None,
                 seed: Optional[int] = None):
        self.conf = conf
        self.mesh = mesh or make_forest_mesh()
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        dev = self.mesh.devices[0]
        self.model = generate_model(conf, seed, device=dev)
        self.part_proj = generate_partition_projections(conf, seed, device=dev)
        self.state: Optional[ShardedForestState] = None
        self._query_fns: Dict = {}

    def fit(self, batch: DenseBatch) -> "ShardedRDFForest":
        self.state, _ = fit_sharded(self.conf, batch, self.mesh, self.model, self.part_proj)
        return self

    def query(self, queries, steps: int = 0, query_ids: Optional[np.ndarray] = None,
              k: Optional[int] = None, **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays. Takes
        `query_device`'s keyword arguments."""
        ids, scores = self.query_device(queries, steps=steps, query_ids=query_ids, k=k, **kw)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_kw(self, steps: int = 0, k: Optional[int] = None, multiprobe: bool = True,
                 probe_mode: str = "reference", probe_budget: int = 8,
                 window_keep: Optional[int] = None, rows_keep: Optional[int] = None
                 ) -> QueryOptions:
        """The options of a query with these settings, the rest from the
        config (`query_options`)."""
        return query_options(self.conf, steps=steps, k=k, multiprobe=multiprobe,
                             probe_mode=probe_mode, probe_budget=probe_budget,
                             window_keep=window_keep, rows_keep=rows_keep)

    def query_device(self, queries, steps: int = 0, query_ids=None, k: Optional[int] = None,
                     multiprobe: bool = True, probe_mode: str = "reference",
                     probe_budget: int = 8, window_keep: Optional[int] = None,
                     rows_keep: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer, `conf.query_batch_size` queries
        at a time (each query's result does not depend on its chunk, so the
        last chunk is not padded); each query's own id is excluded when
        `query_ids` is given."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        opts = self.query_kw(steps, k, multiprobe, probe_mode, probe_budget, window_keep,
                             rows_keep)
        if opts not in self._query_fns:
            self._query_fns[opts] = make_query_fn(self.mesh, self.layout,
                                                  **dataclasses.asdict(opts))
        dev = self.mesh.comm_device
        qd = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        qids = (None if query_ids is None
                else torch.as_tensor(query_ids).to(dev, torch.int32))
        ids, scores, _ = self._query_fns[opts](self.state, qd, qids,
                                               chunk=self.conf.query_batch_size)
        return ids, scores

    def live_ids(self) -> torch.Tensor:
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return self.state.live_ids()

    def size(self) -> int:
        """Live rows over every shard of every process."""
        if self.state is None:
            return 0
        return self.mesh.host_sum(int(sum(self.state.n_live)))


# ---------------------------------------------------------------------------
# the sparse forest, sharded
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedSparseForestState:
    """This process's sparse forest shards in global order, each a
    single-device `SparseForestState` (no coarse tier) over `nloc` rows of
    which the first `n_live[i]` are live; `dim` is the feature space."""

    shards: List[SparseForestState]
    n_live: List[int]
    nloc: int
    dim: int
    first_shard: int = 0


def _sparse_chunk(conf: RDFConfig, dim: int, nnz: int, nloc: int) -> int:
    """Rows hashed at once, as `fit_sparse` sizes them (hashing is row-wise,
    so the chunk changes no key)."""
    chunk = min(conf.fit_batch_size, nloc)
    if dim > _DENSIFY_DIM_LIMIT:
        per_row = nnz * conf.table_num * conf.lsh_table.chain_length * 4
        chunk = min(chunk, _pad_to(max(256, _GATHER_CHUNK_BYTES // max(per_row, 1)), 256))
    return chunk


def fit_sparse_sharded(conf: RDFConfig, batch: SparseBatch, mesh: Optional[ForestMesh] = None,
                       model: Optional[HashModel] = None,
                       part_proj: Optional[torch.Tensor] = None
                       ) -> Tuple[ShardedSparseForestState, ForestMesh]:
    """Shard a padded-COO corpus over the mesh, `nloc = pad128(ceil(n /
    S))` rows a shard; every shard builds all L tables over its rows with
    no communication, its padding rows sorted in with the maximum key as
    in the dense fit."""
    mesh = mesh or make_forest_mesh()
    rerank_ops.check_sparse_size_for_merge(batch.size)
    dev0 = mesh.devices[0]
    model = model if model is not None else generate_model(conf, device=dev0)
    if part_proj is None:
        part_proj = generate_partition_projections(conf, device=dev0)
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    reps = _replicas(model, part_proj, mesh.devices)
    n, dim = batch.n, int(batch.size)
    nloc = _pad_to(int(np.ceil(n / mesh.n_shards)), 128)
    chunk = _sparse_chunk(conf, dim, batch.nnz_pad, nloc)
    shards, n_live = [], []
    for dev, (lo, nl) in zip(mesh.devices,
                             _shard_slices(n, nloc, mesh.n_local, mesh.first_shard)):
        idx = _rows(batch.indices, lo, nl, nloc, torch.int32, dev)
        val = _rows(batch.values, lo, nl, nloc, torch.float32, dev)
        row_ids = _rows(batch.ids, lo, nl, nloc, torch.int32, dev, fill=-1)
        m, pp = reps[dev]
        keys = _keys_for_sparse_corpus(m, pp, idx, val, nl, layout, chunk, dim)
        pos = torch.arange(nloc, dtype=torch.int32, device=dev)
        ids = torch.where(pos < nl, pos, -1).expand_as(keys)
        tables = build_tables(keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nloc)
        del keys, ids
        shards.append(SparseForestState(model=m, part_proj=pp, tables=tables,
                                        corpus_indices=idx, corpus_values=val,
                                        row_ids=row_ids))
        n_live.append(nl)
    return ShardedSparseForestState(shards=shards, n_live=n_live, nloc=nloc, dim=dim,
                                    first_shard=mesh.first_shard), mesh


def query_sparse_shards(state: ShardedSparseForestState, q_indices: torch.Tensor,
                        q_values: torch.Tensor, query_ids: Optional[torch.Tensor],
                        layout: KeyLayout, dim: int, steps: int, m_cap: int, k: int,
                        exclude_self: bool = True) -> List[Tuple[torch.Tensor, ...]]:
    """Each shard's own (ids [B, k], scores [B, k], total [B]) of the
    classic sparse path (no multi-probe), on the shard's device."""
    exclude = exclude_self and query_ids is not None
    ci, cv, cq = {}, {}, {}
    outs = []
    for st in state.shards:
        dev = st.device
        qi = (_on(query_ids, dev, cq) if query_ids is not None
              else torch.full((q_indices.shape[0],), -1, dtype=torch.int32, device=dev))
        outs.append(_query_sparse(st, _on(q_indices, dev, ci), _on(q_values, dev, cv), qi,
                                  layout, dim, steps=steps, m_cap=m_cap, k=k, multiprobe=False,
                                  exclude_self=exclude))
    return outs


def make_sparse_query_fn(mesh: ForestMesh, layout: KeyLayout, dim: int, steps: int = 0,
                         m_cap: int = 4096, k: int = 10, exclude_self: bool = True) -> Callable:
    """The sharded sparse query: fn(state, q_indices [B, NNZq], q_values,
    query_ids [B] or None, chunk=None) → (ids i32[B, k], scores f32[B, k],
    total int64[B]). Each shard runs the classic sparse path (no
    multi-probe, as the reference's sparse query has none), then the merge;
    `chunk` runs the queries that many at a time."""

    def step(state, q_indices, q_values, query_ids):
        outs = query_sparse_shards(state, q_indices, q_values, query_ids, layout, dim,
                                   steps=steps, m_cap=m_cap, k=k, exclude_self=exclude_self)
        ids, scores = merge_topk(mesh, [o[0] for o in outs], [o[1] for o in outs], k,
                                 mask="above_neg_inf")
        return ids, scores, merge_totals(mesh, [o[2] for o in outs])

    def many(state, q_indices, q_values, query_ids=None, chunk: Optional[int] = None):
        q = q_indices.shape[0]
        if chunk is None or chunk >= q:
            return step(state, q_indices, q_values, query_ids)
        outs = [step(state, q_indices[c0:c0 + chunk], q_values[c0:c0 + chunk],
                     None if query_ids is None else query_ids[c0:c0 + chunk])
                for c0 in range(0, q, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return many
