"""SparseRDFForest: the forest over sparse vectors (`SparsevectorRDFInit`).

Counterpart of `similaritysearchbyrdf_tpu/index/sparse_forest.py`. The
reference's sparse path (`SparsevectorRDFInit.scala`, the sparse overload of
`RandomDrawTreeMap.getSimilarWithStepWiseFaster`, `RandomDrawTreeMap.java:
686-732`) differs from the dense one in three ways, all kept here:

fit   rows are padded-COO (`vectors.SparseBatch`); they hash densified up
      to 4096 dims (K1 on the card), by projection-column gathers above;
      the coarse tier is a random Gaussian projection of the sparse rows
      (Σ_j v[n,j] · P[idx[n,j]]), not the dense tier's QR basis;
query step-wise partition fan-out with no multi-probe, block (K2) or window
      (K2b) coarse scores of the candidate blocks, an exact top-m2 select
      (no tournament, no window pruning), and the exact sparse·sparse
      sort-merge rerank (`ops/rerank.rerank_sparse_merge`).

The buckets, candidate blocks and coarse scoring are the dense forest's
own (`index/forest.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..models.families import Device, HashModel, generate_model, resolve_device
from ..ops import rerank as rerank_ops
from ..ops.bitops import to_key
from ..ops.hashing import densify, hash_dense, hash_sparse, hash_sparse_densify
from ..ops.precision import full_f32
from ..vectors import SparseBatch
from .bucket_table import KEY_PAD, BucketTables, KeyLayout, build_tables, composite_keys
from .forest import (_coarse_block_scores, _exclude_self, _pad_to, _select_rows,
                     above_threshold, coarse_seg_width, gather_blocks, gather_candidates,
                     live_rows, state_to, sub_index_counts, window_size)
from .partitioner import generate_partition_projections, partition_of_hash

# Up to this width a batch hashes densified; above it, by gathers.
_DENSIFY_DIM_LIMIT = 4096
# Past the densify limit, a fit chunk's [chunk, NNZ, T*C] gathered
# projection columns stay under this many bytes.
_GATHER_CHUNK_BYTES = 512 << 20


@dataclasses.dataclass
class SparseForestState:
    """All tensors of a fitted sparse forest, on one device."""

    model: HashModel
    part_proj: torch.Tensor                 # f32[L, pbits, 32]
    tables: BucketTables
    corpus_indices: torch.Tensor            # i32[Npad, NNZ] (padding rows 0)
    corpus_values: torch.Tensor             # f32[Npad, NNZ] (padding rows 0)
    row_ids: torch.Tensor                   # i32[Npad] user ids (padding -1)
    coarse_proj: Optional[torch.Tensor] = None    # f32[dim, cs]
    # per-table coarse rows in bucket-sorted order (padding rows 0)
    coarse_tier: Optional[torch.Tensor] = None    # i8 or bf16[L, Npad+ID_PAD, cs]

    @property
    def capacity(self) -> int:
        return self.corpus_indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.corpus_indices.device

    def to(self, device: Device) -> "SparseForestState":
        """This state with every tensor, its model's and tables' too, on
        `device`."""
        return state_to(self, device)


def _hash_batch(model: HashModel, idx: torch.Tensor, val: torch.Tensor, dim: int
                ) -> torch.Tensor:
    if dim <= _DENSIFY_DIM_LIMIT:
        return hash_sparse_densify(model, idx, val)
    return hash_sparse(model, idx, val)


def _keys_for_sparse_corpus(model: HashModel, part_proj: torch.Tensor, indices: torch.Tensor,
                            values: torch.Tensor, n_valid: int, layout: KeyLayout, chunk: int,
                            dim: int) -> torch.Tensor:
    """Composite keys i32[L, Npad] (flipped; padding rows KEY_PAD), hashed
    `chunk` rows at a time."""
    parts = []
    for c0 in range(0, indices.shape[0], chunk):
        h = _hash_batch(model, indices[c0:c0 + chunk], values[c0:c0 + chunk], dim)
        parts.append(to_key(composite_keys(h, partition_of_hash(h, part_proj), layout)))
    keys = torch.cat(parts)                                          # [Npad, L]
    keys[n_valid:] = KEY_PAD
    return keys.T.contiguous()


def _rows_on(a, dtype: torch.dtype, npad: int, device: torch.device) -> torch.Tensor:
    """Rows of a numpy array or tensor on `device`, padded with zero rows
    to `npad`."""
    t = torch.as_tensor(a).to(device=device, dtype=dtype)
    return torch.nn.functional.pad(t, (0, 0, 0, npad - t.shape[0])).contiguous()


def fit_sparse(conf: RDFConfig, batch: SparseBatch, model: Optional[HashModel] = None,
               part_proj: Optional[torch.Tensor] = None, nb_pad: Optional[int] = None,
               device: Device = None) -> SparseForestState:
    """Build a forest over a sparse corpus (`SparsevectorRDFInit.newMultiThreadFit`,
    `SparsevectorRDFInit.scala:124-200`). `batch.indices` / `values` may be
    numpy arrays or tensors; the forest lives on `device` (default: the
    tensors', else the first CUDA card)."""
    rerank_ops.check_sparse_size_for_merge(batch.size)
    if isinstance(batch.indices, torch.Tensor) and device is None:
        device = batch.indices.device
    device = resolve_device(device)
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    model = model if model is not None else generate_model(conf, device=device)
    if part_proj is None:
        part_proj = generate_partition_projections(conf, device=device)
    n = batch.n
    chunk = min(conf.fit_batch_size, _pad_to(n, 256))
    if batch.size > _DENSIFY_DIM_LIMIT:
        per_row = batch.nnz_pad * conf.table_num * conf.lsh_table.chain_length * 4
        chunk = min(chunk, _pad_to(max(256, _GATHER_CHUNK_BYTES // max(per_row, 1)), 256))
    npad = _pad_to(n, chunk)
    idx = _rows_on(batch.indices, torch.int32, npad, device)
    val = _rows_on(batch.values, torch.float32, npad, device)
    row_ids = torch.full((npad,), -1, dtype=torch.int32, device=device)
    row_ids[:n] = torch.as_tensor(batch.ids, dtype=torch.int32).to(device)

    keys = _keys_for_sparse_corpus(model, part_proj, idx, val, n, layout, chunk, batch.size)
    pos = torch.arange(npad, dtype=torch.int32, device=device)
    ids = torch.where(pos < n, pos, -1).expand_as(keys)
    tables = build_tables(keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nb_pad)
    del keys, ids
    coarse_proj = coarse_tier = None
    if conf.coarse_dim:
        coarse_proj, coarse_tier = _build_sparse_coarse_tier(
            idx, val, tables.sorted_ids, batch.size, min(conf.coarse_dim, batch.size),
            conf.coarse_dtype, conf.seed, chunk)
    return SparseForestState(model=model, part_proj=part_proj, tables=tables,
                             corpus_indices=idx, corpus_values=val, row_ids=row_ids,
                             coarse_proj=coarse_proj, coarse_tier=coarse_tier)


def _sparse_coarse_projection(dim: int, coarse_dim: int, seed: int) -> np.ndarray:
    """The sparse tier's basis f32[dim, cs]: a seeded Gaussian scaled by
    1/sqrt(cd) (Johnson–Lindenstrauss: inner products kept in expectation;
    the exact rerank corrects the coarse order), zero columns up to the
    tier width. The JAX package's draw, not the dense tier's QR basis."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    p = (rng.normal(size=(dim, coarse_dim)) / np.sqrt(coarse_dim)).astype(np.float32)
    return np.pad(p, ((0, 0), (0, coarse_seg_width(coarse_dim) - coarse_dim)))


def _build_sparse_coarse_tier(indices: torch.Tensor, values: torch.Tensor,
                              sorted_ids: torch.Tensor, dim: int, coarse_dim: int,
                              coarse_dtype: str, seed: int, chunk: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse_proj f32[dim, cs], tier [L, Npad+ID_PAD, cs]): each row's
    projection low[n] = Σ_j v[n,j] · P[idx[n,j]], computed `chunk` rows at
    a time in full f32, quantized to int8 with one global scale (rounding
    half to even) or rounded to bf16, then laid out per table in its
    bucket-sorted order (padding rows 0). The JAX package packs 128 // cs
    tables per 128-lane row; the port keeps one table per slab."""
    cp = torch.as_tensor(_sparse_coarse_projection(dim, coarse_dim, seed),
                         device=indices.device)
    low = torch.empty((indices.shape[0], cp.shape[1]), dtype=torch.float32,
                      device=indices.device)
    for c0 in range(0, indices.shape[0], chunk):
        rows = cp[indices[c0:c0 + chunk].to(torch.int64)]             # [chunk, NNZ, cs]
        with full_f32():
            low[c0:c0 + chunk] = torch.einsum("bnc,bn->bc", rows, values[c0:c0 + chunk])
    if coarse_dtype == "int8":
        scale = 127.0 / torch.clamp(low.abs().max(), min=1e-20)
        low = torch.clamp(torch.round(low * scale), -127, 127).to(torch.int8)
    else:
        low = low.to(torch.bfloat16)
    tier = low[sorted_ids.clamp(min=0).to(torch.int64)]               # [L, caprows, cs]
    tier.masked_fill_((sorted_ids < 0)[..., None], 0)
    return cp, tier


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _query_sparse(state: SparseForestState, q_indices: torch.Tensor, q_values: torch.Tensor,
                  query_ids: torch.Tensor, layout: KeyLayout, dim: int, steps: int = 0,
                  m_cap: int = 4096, k: int = 10, multiprobe: bool = False,
                  exclude_self: bool = True, coarse_refine: int = 2048,
                  coarse_window: int = -1):
    """Batched sparse query core → (ids i32[B, k] user ids with -1 padding,
    scores f32[B, k], candidate counts int64[B]). No probes by default: the
    reference's sparse path has none. With a coarse tier, the window rule is
    the dense one (`window_size`), and the top m2 = min(max(coarse_refine,
    (k+1)·L), m_cap) slots by coarse score are reranked (the JAX package
    takes approx_max_k where m2·8 fits the slab, exact on the CPU; here a
    stable exact top-m2 in both cases, `_select_rows`)."""
    # densified once, for K1 (up to the densify limit) and the coarse projection
    dense_q = (densify(q_indices, q_values, dim)
               if dim <= _DENSIFY_DIM_LIMIT or state.coarse_tier is not None else None)
    h = (hash_dense(state.model, dense_q) if dim <= _DENSIFY_DIM_LIMIT
         else hash_sparse(state.model, q_indices, q_values))
    home = partition_of_hash(h, state.part_proj)
    if state.coarse_tier is not None:
        base_b, table_b, start_b, end_b, total, bs = gather_blocks(
            state.tables, h, home, layout, steps, m_cap, multiprobe,
            window=window_size(m_cap, coarse_window))
        scores, pos, table_slot = _coarse_block_scores(
            state.coarse_tier, state.coarse_proj, dense_q,
            base_b, table_b, end_b, bs, start_b=start_b)
        m2 = min(max(coarse_refine, (k + 1) * state.tables.num_tables), m_cap)
        cand = _select_rows(state.tables, scores, pos, table_slot, m2)
    else:
        cand, total = gather_candidates(state.tables, h, home, layout, steps, m_cap, multiprobe)
    if exclude_self:
        cand = _exclude_self(cand, state.row_ids, query_ids)
    rows, scores = rerank_ops.rerank_sparse_merge(
        state.corpus_indices, state.corpus_values, cand, q_indices, q_values, k,
        dup_bound=h.shape[1])
    ids = torch.where(rows >= 0, state.row_ids[rows.clamp(min=0).to(torch.int64)], -1)
    return ids, scores, total


def query_sparse_many(state: SparseForestState, q_indices: torch.Tensor,
                      q_values: torch.Tensor, query_ids: torch.Tensor, layout: KeyLayout,
                      dim: int, chunk: int = 256, **kw):
    """Whole-query-set sparse search, `chunk` queries at a time (bounds the
    merge's [chunk, m2, NNZ+NNZq] slabs). Takes `_query_sparse`'s keyword
    arguments."""
    out = [_query_sparse(state, q_indices[c0:c0 + chunk], q_values[c0:c0 + chunk],
                         query_ids[c0:c0 + chunk], layout, dim, **kw)
           for c0 in range(0, q_indices.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*out))


class SparseRDFForest:
    """Host orchestrator for the sparse forest, on `device` (default: the
    first CUDA card; `device="cpu"` for the CPU)."""

    def __init__(self, conf: RDFConfig, model: Optional[HashModel] = None,
                 seed: Optional[int] = None, device: Device = None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        self.model = model.to(self.device) if model is not None else generate_model(
            conf, seed, device=self.device)
        self.part_proj = generate_partition_projections(conf, seed, device=self.device)
        self.state: Optional[SparseForestState] = None
        self.dim = conf.vector_dim

    def fit(self, batch: SparseBatch) -> "SparseRDFForest":
        self.dim = batch.size
        self.state = fit_sparse(self.conf, batch, model=self.model, part_proj=self.part_proj,
                                device=self.device)
        return self

    def query(self, queries: SparseBatch, steps: int = 0,
              query_ids: Optional[np.ndarray] = None, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; with
        `query_ids`, each query's own id is excluded."""
        ids, scores = self.query_device(queries, steps=steps, query_ids=query_ids, k=k)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, queries: SparseBatch, steps: int = 0, query_ids=None,
                     k: Optional[int] = None, coarse_refine: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the forest's device,
        `conf.query_batch_size` queries at a time; coarse_refine defaults to
        the config's."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        k = k or self.conf.top_k
        qi = torch.as_tensor(queries.indices).to(self.device, torch.int32)
        qv = torch.as_tensor(queries.values).to(self.device, torch.float32)
        exclude = query_ids is not None
        qids = (torch.as_tensor(np.asarray(query_ids), dtype=torch.int32).to(self.device)
                if exclude else torch.full((qi.shape[0],), -1, dtype=torch.int32,
                                           device=self.device))
        ids, scores, _ = query_sparse_many(
            self.state, qi, qv, qids, self.layout, self.dim, chunk=self.conf.query_batch_size,
            steps=steps, m_cap=self.conf.max_candidates, k=k, exclude_self=exclude,
            coarse_refine=coarse_refine or self.conf.coarse_refine,
            coarse_window=self.conf.coarse_window)
        return above_threshold(ids, scores, self.conf.similarity_threshold)

    def live_ids(self) -> torch.Tensor:
        """The user ids of the fitted rows, i32[N]: the rows the tables
        hold, whatever their ids' sign (-1 pads only rows past N)."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return self.state.row_ids[live_rows(self.state.tables)]

    def size(self) -> int:
        return 0 if self.state is None else int(self.live_ids().shape[0])

    def sub_index_distribution(self) -> np.ndarray:
        """Objects per (table, sub-index), int64[L, 2**partitionBits]: the
        sparse mirror of the dense forest's (`RandomDrawTreeMap.java:
        2793-2802`, surfaced by `SparsevectorRDFInit.scala:505-530`)."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        return sub_index_counts(self.state.tables, self.layout)
