"""The sharded quantized-flat engines, dense and sparse.

Counterpart of `similaritysearchbyrdf_tpu/parallel/sharded_flat.py`. Each
shard holds `nloc` rows of the int8 (or bf16) sketch and of the exact tier;
a query goes to every shard, each runs the single-device scan and refine
(`ops/flat.flat_topk` or `flat_topk_grouped`: K4, then K2b's re-score or
the argpack select, as the shard's rows decide), and the shards' top-k
lists meet in the merge of `sharded_forest.merge_topk` (an id kept where
its score is finite).

The int8 scale is global: computed over the whole corpus before sharding
(across processes, an all-reduce max of each process's max |x|), because
per-shard scales would make sketch scores of different shards
incomparable. Layouts are the JAX package's: the one-process fit takes
`nloc = ceil(n / S)` rows a shard with no padding to 128, the
multi-process fit `nloc = pad128(max need)`, so the two differ unless n /
S is a multiple of 128. A shard's padding rows are scanned (zero rows
score 0, as there) and known by position (`n_live`), so any user id, a
negative one too, can be returned; the JAX package drops ids below 0.

Not ported: the strided second sketch copy of the halved group-max reduce
(`sketch_gmax`, `_host_gmax_strided`, `_auto_strided_copy`), a TPU layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.flat import (_NPAD_MULTIPLE, _pad_rows, _round_up, build_flat_sketch,
                        build_flat_sketch_sparse, flat_topk, flat_topk_grouped, flat_topk_sparse,
                        sketch_scale)
from ..ops.rerank import check_sparse_size_for_merge
from ..vectors import SparseBatch
from .mesh import ForestMesh, make_forest_mesh
from .sharded_forest import _on, _rows, _shard_slices, merge_topk


@dataclasses.dataclass
class FlatShard:
    """One shard of the flat engine: the sketch [round_up(nloc, 8192),
    ceil(D/32)*32] (rows past nloc zero, the grouped scan's numbering), the
    exact tier [nloc, D], the ids i32[nloc] and the live row count (the
    live rows are a prefix)."""

    sketch: torch.Tensor
    corpus: torch.Tensor
    row_ids: torch.Tensor
    n_live: int


@dataclasses.dataclass
class ShardedFlatState:
    """This process's flat shards in global order and the rows a shard."""

    shards: List[FlatShard]
    nloc: int
    first_shard: int = 0


def _amax(values) -> float:
    if isinstance(values, torch.Tensor):
        if not values.numel():
            return 0.0
        lo, hi = torch.aminmax(values)
        return max(-float(lo), float(hi))
    return float(np.max(np.abs(values))) if np.size(values) else 0.0


def _flat_shard(values, ids, lo: int, n_live: int, nloc: int, dev: torch.device,
                sketch_dtype: str, scale: float) -> FlatShard:
    x = _rows(values, lo, n_live, nloc, torch.float32, dev)
    sketch, _ = build_flat_sketch(x, sketch_dtype, scale=scale)
    return FlatShard(sketch=_pad_rows(sketch, _round_up(nloc, _NPAD_MULTIPLE)).contiguous(),
                     corpus=x, row_ids=_rows(ids, lo, n_live, nloc, torch.int32, dev, fill=-1),
                     n_live=n_live)


def _check_dtype(sketch_dtype: str) -> None:
    if sketch_dtype not in ("int8", "bfloat16"):
        raise ValueError(f"unsupported flat sketch dtype: {sketch_dtype}")


def fit_flat_sharded(values, ids, mesh: Optional[ForestMesh] = None,
                     sketch_dtype: str = "int8") -> Tuple[ShardedFlatState, ForestMesh]:
    """The fit from a corpus f32[N, D] (numpy or a tensor) and user ids
    this process holds whole: `nloc = ceil(n / S)` rows a shard, one
    global scale."""
    _check_dtype(sketch_dtype)
    mesh = mesh or make_forest_mesh()
    n = int(values.shape[0])
    nloc = max(1, int(np.ceil(n / mesh.n_shards)))
    scale = sketch_scale(_amax(values)) if sketch_dtype == "int8" else 1.0
    shards = [_flat_shard(values, ids, lo, nl, nloc, dev, sketch_dtype, scale)
              for dev, (lo, nl) in zip(mesh.devices,
                                       _shard_slices(n, nloc, mesh.n_local, mesh.first_shard))]
    return ShardedFlatState(shards, nloc, mesh.first_shard), mesh


def _global_nloc_and_amax(mesh: ForestMesh, n_local: int, amax_local: float
                          ) -> Tuple[int, float]:
    """Rows a shard and the global max |x| of a multi-process fit: the
    largest ceil(n / local shards) over the processes padded to 128, and
    the largest max |x| (one all-reduce max)."""
    need, amax = mesh.host_max(int(np.ceil(n_local / mesh.n_local)), amax_local)
    return _round_up(max(int(need), 1), 128), amax


def fit_flat_sharded_distributed(local_values, local_ids, mesh: Optional[ForestMesh] = None,
                                 sketch_dtype: str = "int8"
                                 ) -> Tuple[ShardedFlatState, ForestMesh]:
    """The multi-process fit: every process supplies only its own rows,
    laid over its shards; the processes agree on `nloc` and on the global
    scale, so the global corpus never exists in one process."""
    _check_dtype(sketch_dtype)
    mesh = mesh or make_forest_mesh()
    n = int(local_values.shape[0])
    nloc, amax = _global_nloc_and_amax(mesh, n, _amax(local_values))
    scale = sketch_scale(amax) if sketch_dtype == "int8" else 1.0
    shards = [_flat_shard(local_values, local_ids, lo, nl, nloc, dev, sketch_dtype, scale)
              for dev, (lo, nl) in zip(mesh.devices, _shard_slices(n, nloc, mesh.n_local))]
    return ShardedFlatState(shards, nloc, mesh.first_shard), mesh


def _local_flat_query(sh: FlatShard, queries, query_ids, *, k, refine, block, exclude_self,
                      mode="scan", r_groups=24):
    if mode == "grouped":
        return flat_topk_grouped(sh.sketch, sh.corpus, sh.row_ids, queries, query_ids, k,
                                 refine=refine, r_groups=max(r_groups, 3 * k),
                                 exclude_self=exclude_self, n_live=sh.n_live)
    return flat_topk(sh.sketch, sh.corpus, sh.row_ids, queries, query_ids, k, refine=refine,
                     block=block, exclude_self=exclude_self, n_live=sh.n_live)


def query_flat_shards(state: ShardedFlatState, queries: torch.Tensor,
                      query_ids: Optional[torch.Tensor], **kw) -> List[Tuple[torch.Tensor, ...]]:
    """Each shard's own (ids [B, k], scores [B, k]) on its device
    (`_local_flat_query`'s keywords in `kw`)."""
    qc, ic = {}, {}
    return [_local_flat_query(sh, _on(queries, sh.corpus.device, qc),
                              None if query_ids is None else _on(query_ids, sh.corpus.device, ic),
                              **kw)
            for sh in state.shards]


def make_flat_query_fn(mesh: ForestMesh, k: int = 10, refine: int = 128, block: int = 1 << 15,
                       exclude_self: bool = True, mode: str = "scan",
                       r_groups: int = 24) -> Callable:
    """fn(state, queries [B, D], query_ids [B] or None) → (ids i32[B, k],
    scores f32[B, k]) on the first shard's device: each shard's scan
    ("scan") or grouped scan ("grouped"), then the merge. Exclusion needs
    `query_ids`."""
    kw = dict(k=k, refine=refine, block=block, exclude_self=exclude_self, mode=mode,
              r_groups=r_groups)

    def fn(state, queries, query_ids=None):
        outs = query_flat_shards(state, queries, query_ids, **kw)
        return merge_topk(mesh, [o[0] for o in outs], [o[1] for o in outs], k)

    return fn


def _unfitted(nq: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    print("need to fit the data first")
    kk = max(k, 1)
    return np.full((nq, kk), -1, np.int32), np.full((nq, kk), -np.inf, np.float32)


class ShardedFlatIndex:
    """Host orchestrator for the sharded flat engine (the query surface of
    `FlatIndex`); `mode` "grouped" (K4, the per-device fast path) or
    "scan"."""

    def __init__(self, mesh: Optional[ForestMesh] = None, sketch_dtype: str = "int8",
                 refine: int = 128, block: int = 1 << 15, mode: str = "grouped",
                 r_groups: int = 24):
        self.mesh = mesh
        self.sketch_dtype = sketch_dtype
        self.refine = refine
        self.block = block
        self.mode = mode
        self.r_groups = r_groups
        self.state: Optional[ShardedFlatState] = None

    def fit(self, batch) -> "ShardedFlatIndex":
        self.state, self.mesh = fit_flat_sharded(batch.values, batch.ids, self.mesh,
                                                 self.sketch_dtype)
        return self

    def query(self, queries, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; an
        unfitted index prints the reference's message and answers -1 ids
        and -inf scores."""
        if self.state is None:
            return _unfitted(len(queries), k)
        ids, scores = self.query_device(queries, k, query_ids, exclude_self)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, queries, k: int = 10, query_ids=None, exclude_self: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer, the whole batch at once."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        dev = self.mesh.comm_device
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        qids = (None if query_ids is None
                else torch.as_tensor(query_ids).to(dev, torch.int32))
        fn = make_flat_query_fn(self.mesh, k=k, refine=self.refine, block=self.block,
                                exclude_self=exclude_self, mode=self.mode,
                                r_groups=self.r_groups)
        return fn(self.state, q, qids)


# ---------------------------------------------------------------------------
# the sparse flat engine, sharded
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseFlatShard:
    """One shard of the sparse flat engine: the int8 sketch of its
    densified rows [round_up(nloc, 8192), ceil(size/32)*32], the
    padded-COO exact tier i32/f32[nloc, NNZ], the ids i32[nloc] and the
    live row count."""

    sketch: torch.Tensor
    c_idx: torch.Tensor
    c_val: torch.Tensor
    row_ids: torch.Tensor
    n_live: int


@dataclasses.dataclass
class ShardedSparseFlatState:
    """This process's sparse flat shards in global order, the rows a shard
    and the feature-space size."""

    shards: List[SparseFlatShard]
    nloc: int
    size: int
    first_shard: int = 0


def _sparse_flat_shards(batch: SparseBatch, nloc: int, scale: float, devices, slices):
    out = []
    for dev, (lo, nl) in zip(devices, slices):
        idx = _rows(batch.indices, lo, nl, nloc, torch.int32, dev)
        val = _rows(batch.values, lo, nl, nloc, torch.float32, dev)
        sketch, _ = build_flat_sketch_sparse(idx, val, int(batch.size), scale=scale)
        out.append(SparseFlatShard(
            sketch=_pad_rows(sketch, _round_up(nloc, _NPAD_MULTIPLE)).contiguous(),
            c_idx=idx, c_val=val, row_ids=_rows(batch.ids, lo, nl, nloc, torch.int32, dev,
                                                fill=-1), n_live=nl))
    return out


def fit_sparse_flat_sharded(batch: SparseBatch, mesh: Optional[ForestMesh] = None
                            ) -> Tuple[ShardedSparseFlatState, ForestMesh]:
    """Shard the sparse flat engine: `nloc = ceil(n / S)` padded-COO rows a
    shard and the int8 sketch of their densified rows, built a chunk at a
    time on the shard's device with the global scale."""
    mesh = mesh or make_forest_mesh()
    check_sparse_size_for_merge(int(batch.size))
    n = batch.n
    nloc = max(1, int(np.ceil(n / mesh.n_shards)))
    scale = sketch_scale(_amax(batch.values))
    shards = _sparse_flat_shards(batch, nloc, scale, mesh.devices,
                                 _shard_slices(n, nloc, mesh.n_local, mesh.first_shard))
    return ShardedSparseFlatState(shards, nloc, int(batch.size), mesh.first_shard), mesh


def fit_sparse_flat_sharded_distributed(local_batch: SparseBatch,
                                        mesh: Optional[ForestMesh] = None
                                        ) -> Tuple[ShardedSparseFlatState, ForestMesh]:
    """The multi-process sparse flat fit: every process supplies only its
    own padded-COO rows; `nloc` and the scale are agreed as in
    `fit_flat_sharded_distributed`."""
    mesh = mesh or make_forest_mesh()
    check_sparse_size_for_merge(int(local_batch.size))
    n = local_batch.n
    nloc, amax = _global_nloc_and_amax(mesh, n, _amax(local_batch.values))
    shards = _sparse_flat_shards(local_batch, nloc, sketch_scale(amax), mesh.devices,
                                 _shard_slices(n, nloc, mesh.n_local))
    return ShardedSparseFlatState(shards, nloc, int(local_batch.size), mesh.first_shard), mesh


def make_sparse_flat_query_fn(mesh: ForestMesh, k: int = 10, refine: int = 128,
                              r_groups: int = 24, exclude_self: bool = True) -> Callable:
    """fn(state, q_indices [B, NNZq], q_values, query_ids [B] or None) →
    (ids i32[B, k], scores f32[B, k]): each shard's `flat_topk_sparse`
    (max(r_groups, 3k) groups kept), then the merge."""

    def fn(state, q_indices, q_values, query_ids=None):
        ci, cv, cq = {}, {}, {}
        ids, scores = [], []
        for sh in state.shards:
            dev = sh.c_idx.device
            i, s = flat_topk_sparse(
                sh.sketch, sh.c_idx, sh.c_val, sh.row_ids, _on(q_indices, dev, ci),
                _on(q_values, dev, cv), None if query_ids is None else _on(query_ids, dev, cq),
                k, refine=refine, r_groups=max(r_groups, 3 * k), exclude_self=exclude_self,
                n_live=sh.n_live)
            ids.append(i)
            scores.append(s)
        return merge_topk(mesh, ids, scores, k)

    return fn


class ShardedSparseFlatIndex:
    """Host orchestrator for the sharded sparse flat engine (the query
    surface of `SparseFlatIndex`)."""

    def __init__(self, mesh: Optional[ForestMesh] = None, refine: int = 128,
                 r_groups: int = 24):
        self.mesh = mesh
        self.refine = refine
        self.r_groups = r_groups
        self.state: Optional[ShardedSparseFlatState] = None

    def fit(self, batch: SparseBatch) -> "ShardedSparseFlatIndex":
        self.state, self.mesh = fit_sparse_flat_sharded(batch, self.mesh)
        return self

    def query(self, q_indices, q_values, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            return _unfitted(len(q_indices), k)
        ids, scores = self.query_device(q_indices, q_values, k, query_ids, exclude_self)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, q_indices, q_values, k: int = 10, query_ids=None,
                     exclude_self: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        dev = self.mesh.comm_device
        qi = torch.as_tensor(q_indices).to(dev, torch.int32)
        qv = torch.as_tensor(q_values).to(dev, torch.float32)
        qids = (None if query_ids is None
                else torch.as_tensor(query_ids).to(dev, torch.int32))
        fn = make_sparse_flat_query_fn(self.mesh, k=k, refine=self.refine,
                                       r_groups=self.r_groups, exclude_self=exclude_self)
        return fn(self.state, qi, qv, qids)
