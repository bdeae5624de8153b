"""The sharded clustered-flat (IVF) engine.

Counterpart of `similaritysearchbyrdf_tpu/parallel/sharded_ivf.py`:

  k-means  global spherical Lloyd over the sharded corpus: each shard
           assigns its rows against the shared centroids (f32 rows against
           bf16 centroids, the JAX package's sharded numerics) and adds its
           rows' int64 fixed-point sums and counts (`ops/ivf.
           cluster_sums_fixed`); the shards' sums add on the first shard's
           device and, across processes, through one all-reduce, so the
           centroids do not depend on the shard or process count. The
           fixed-point shift comes from the global max |x| and row count.
  layout   every shard lays its own rows out cluster-ordered over the
           global cluster ids (8-aligned ranges, true ends), so cluster c
           is one window range on every shard; the int8 scale is global.
  query    every shard selects the same `nprobe` clusters, scores their
           windows with K2b (`ops/ivf.ivf_topk`) and refines exactly; the
           shards' lists meet in `sharded_forest.merge_topk` (an id kept
           where its score is finite).

The JAX package's sums are f32 sums of bf16 one-hot products, merged by
`psum`: their rounding depends on the order, so a centroid may sit one bf16
step from the port's.

The multi-process fit draws its initial centroids as the one-process fit
does (the same global row sample, each row taken by the process that holds
it), so a multi-process fit equals the one-process fit bit for bit when the
two lay rows out alike; the JAX package samples each process's own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.flat import _SKETCH_COLS, _pad_cols, _round_up, quantize_sketch_rows, sketch_scale
from ..ops.ivf import (_ASSIGN_CHUNK, IVFState, _cluster_perm, _n_clusters, build_ivf_heads,
                       cluster_bits, cluster_sums_fixed, ivf_live_rows, ivf_topk,
                       ivf_window_budget, update_centroids)
from ..ops.precision import full_f32
from .mesh import ForestMesh, make_forest_mesh
from .sharded_flat import _amax, _global_nloc_and_amax
from .sharded_forest import _on, _rows, _shard_slices, merge_topk


@dataclasses.dataclass
class ShardedIVFState:
    """This process's IVF shards in global order, each a single-device
    `IVFState` over the shard's own rows (its sketch, exact tier and ids
    [npad_max, ...], its starts and ends over the global clusters, a copy
    of the shared centroids on its device, its head tier when pruning)."""

    shards: List[IVFState]
    first_shard: int = 0

    @property
    def centroids(self) -> torch.Tensor:
        return self.shards[0].centroids


def build_heads_sharded(state: ShardedIVFState, mesh: ForestMesh,
                        head_pool: int) -> ShardedIVFState:
    """Each shard's head tier over its own cluster-ordered sketch rows (no
    communication): the single-device `build_ivf_heads` on the rows the
    shard's clusters hold."""
    return dataclasses.replace(state, shards=[
        st._replace(heads=build_ivf_heads(
            st.sketch, st.row_ids, head_pool,
            live=ivf_live_rows(st.starts, st.ends, st.sketch.shape[0])))
        for st in state.shards])


def _assign_f32(x: torch.Tensor, centroids: torch.Tensor,
                chunk: int = _ASSIGN_CHUNK) -> torch.Tensor:
    """i32[N]: each f32 row's centroid of largest inner product (the first
    on ties), the bf16 centroids widened to f32, products in full f32."""
    ct = centroids.to(torch.float32).T
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    with full_f32():
        for c0 in range(0, x.shape[0], chunk):
            out[c0:c0 + chunk] = (x[c0:c0 + chunk] @ ct).argmax(dim=1).to(torch.int32)
    return out


def _kmeans_sharded(mesh: ForestMesh, xs: List[torch.Tensor], n_live: List[int], k: int,
                    iters: int, init_cent: torch.Tensor, n_glob: int
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Global spherical k-means over the shards' rows xs f32[nloc, Dp], the
    first `n_live` of each live. → (centroids bf16[K, Dp] on the first
    shard's device, each shard's last assignment i32[n_live])."""
    dev0 = mesh.comm_device
    cent = init_cent.to(dev0, torch.bfloat16)
    xbs = [x[:nl].to(torch.bfloat16) for x, nl in zip(xs, n_live)]    # the summed rows
    amax = max([float(xb.abs().max()) if xb.numel() else 0.0 for xb in xbs])
    bits = cluster_bits(mesh.host_max(amax)[0], n_glob)
    assigns: List[torch.Tensor] = []
    for _ in range(iters):
        sums = torch.zeros((k, xs[0].shape[1]), dtype=torch.int64, device=dev0)
        counts = torch.zeros(k, dtype=torch.int64, device=dev0)
        assigns = []
        ccache = {}
        for x, xb, nl in zip(xs, xbs, n_live):
            a = _assign_f32(x[:nl], _on(cent, x.device, ccache))
            s, c = cluster_sums_fixed(xb, a, k, bits)
            sums += s.to(dev0)
            counts += c.to(dev0)
            assigns.append(a)
        mesh.all_reduce(sums, "sum")
        mesh.all_reduce(counts, "sum")
        cent = update_centroids(sums.to(torch.float64) * 2.0 ** -bits, counts, cent)
    return cent, assigns


def _lay_out(mesh: ForestMesh, xs, rids, assigns, kc: int, scale: float, cent: torch.Tensor
             ) -> ShardedIVFState:
    """Each shard's cluster-ordered arrays over the global clusters, all
    shards `npad_max` rows (the largest layout over every process, 8-aligned)."""
    layouts = [_cluster_perm(a.cpu().numpy(), kc) for a in assigns]
    tot = max([int(st[-1]) for _, st, _ in layouts] + [8])
    npad_max = _round_up(int(mesh.host_max(tot)[0]), 8)
    shards = []
    for x, rid, (perm, starts, counts) in zip(xs, rids, layouts):
        dev = x.device
        perm_d = torch.as_tensor(perm, device=dev)
        dead = perm_d < 0
        safe = perm_d.clamp(min=0)
        co = torch.zeros((npad_max, x.shape[1]), dtype=torch.float32, device=dev)
        co[:perm.size] = x[safe].masked_fill_(dead[:, None], 0.0)
        ro = torch.full((npad_max,), -1, dtype=torch.int32, device=dev)
        ro[:perm.size] = rid[safe].masked_fill_(dead, -1)
        shards.append(IVFState(
            sketch=quantize_sketch_rows(co, scale), corpus=co, row_ids=ro,
            centroids=cent.to(dev),
            starts=torch.as_tensor(np.minimum(starts, npad_max).astype(np.int32), device=dev),
            ends=torch.as_tensor(np.minimum(starts[:-1] + counts, npad_max).astype(np.int32),
                                 device=dev)))
    return ShardedIVFState(shards=shards, first_shard=mesh.first_shard)


def _ivf_fit(mesh: ForestMesh, values, ids, nloc: int, slices, n_glob: int, kc: int,
             iters: int, scale: float, init_rows: np.ndarray, row_offset: int
             ) -> ShardedIVFState:
    """The fit over this process's rows `values` (global rows row_offset ..
    row_offset + n - 1), laid over its shards by `slices`."""
    dp = _round_up(int(values.shape[1]), _SKETCH_COLS)
    dev0 = mesh.comm_device
    xs = [_pad_cols(_rows(values, lo, nl, nloc, torch.float32, dev), dp)
          for dev, (lo, nl) in zip(mesh.devices, slices)]
    rids = [_rows(ids, lo, nl, nloc, torch.int32, dev, fill=-1)
            for dev, (lo, nl) in zip(mesh.devices, slices)]
    # the initial centroids: rows of the global sample, each from the process
    # that holds it (an all-reduce sum of rows and zeros is exact)
    n = int(values.shape[0])
    mine = (init_rows >= row_offset) & (init_rows < row_offset + n)
    init = torch.zeros((kc, dp), dtype=torch.float32, device=dev0)
    if mine.any():
        rows = torch.as_tensor(values[init_rows[mine] - row_offset]).to(dev0, torch.float32)
        init[torch.as_tensor(np.flatnonzero(mine), device=dev0)] = _pad_cols(rows, dp)
    mesh.all_reduce(init, "sum")
    cent, assigns = _kmeans_sharded(mesh, xs, [nl for _, nl in slices], kc, iters, init, n_glob)
    return _lay_out(mesh, xs, rids, assigns, kc, scale, cent)


def _init_rows(n_glob: int, kc: int, seed: int) -> np.ndarray:
    """The one-process fit's initial centroid rows (`seed ^ 0xC1`)."""
    rng = np.random.default_rng(seed ^ 0xC1)
    return rng.choice(max(n_glob, 1), size=kc, replace=n_glob < kc)


def fit_ivf_sharded(values, ids, mesh: Optional[ForestMesh] = None, target_cluster: int = 256,
                    iters: int = 6, seed: int = 0, k_clusters: Optional[int] = None
                    ) -> Tuple[ShardedIVFState, ForestMesh]:
    """The fit from a corpus f32[N, D] (numpy or a tensor) and user ids this
    process holds whole: `nloc = pad8(ceil(n / S))` rows a shard, K =
    k_clusters or n // target_cluster within [16, 65536]."""
    mesh = mesh or make_forest_mesh()
    n = int(values.shape[0])
    nloc = _round_up(max(int(np.ceil(n / mesh.n_shards)), 1), 8)
    kc = _n_clusters(n, target_cluster, k_clusters)
    state = _ivf_fit(mesh, values, ids, nloc,
                     _shard_slices(n, nloc, mesh.n_local, mesh.first_shard), n, kc, iters,
                     sketch_scale(_amax(values)), _init_rows(n, kc, seed), 0)
    return state, mesh


def fit_ivf_sharded_distributed(local_values, local_ids, mesh: Optional[ForestMesh] = None,
                                target_cluster: int = 256, iters: int = 6, seed: int = 0,
                                k_clusters: Optional[int] = None
                                ) -> Tuple[ShardedIVFState, ForestMesh]:
    """The multi-process fit: every process supplies only its own rows (the
    global corpus is process 0's rows, then process 1's, ...). The
    processes agree on `nloc` (padded to 128), the global scale, the row
    count (an all-reduce sum) and the layouts' length; k-means is the same
    all-reduced loop."""
    mesh = mesh or make_forest_mesh()
    n = int(local_values.shape[0])
    nloc, amax = _global_nloc_and_amax(mesh, n, _amax(local_values))
    counts = mesh.all_gather(torch.tensor([n], dtype=torch.int64, device=mesh.comm_device))
    counts = counts.cpu().numpy()
    n_glob = int(counts.sum())
    offset = int(counts[:mesh.process_index].sum())
    kc = _n_clusters(n_glob, target_cluster, k_clusters)
    state = _ivf_fit(mesh, local_values, local_ids, nloc, _shard_slices(n, nloc, mesh.n_local),
                     n_glob, kc, iters, sketch_scale(amax), _init_rows(n_glob, kc, seed),
                     offset)
    return state, mesh


def ivf_window_budget_sharded(state: ShardedIVFState, nprobe: int, win: int, cap: int = 4096,
                              mesh: Optional[ForestMesh] = None) -> int:
    """The window budget every shard shares: the largest `ivf_window_budget`
    over the shards (clusters differ in length from shard to shard), over
    every process when `mesh` spans several."""
    wb = max(ivf_window_budget(st.starts, st.ends, nprobe, win, cap) for st in state.shards)
    return int(mesh.host_max(wb)[0]) if mesh is not None else wb


def make_ivf_query_fn(mesh: ForestMesh, k: int = 10, nprobe: int = 32, win: int = 64,
                      wb: Optional[int] = None, refine: int = 128, exclude_self: bool = True,
                      head_pool: int = 0, keep: int = 0) -> Callable:
    """fn(state, queries [B, D], query_ids [B] or None) → (ids i32[B, k],
    scores f32[B, k]): every shard probes the same clusters over its own
    rows (`ivf_topk`: K2b window scores, the exact refine), then the
    merge. `wb` None covers each whole shard (test sizes); pass
    `ivf_window_budget_sharded` at scale. head_pool and keep > 0 prune
    each shard's windows (the state's heads must be built)."""

    kw = dict(k=k, nprobe=nprobe, win=win, wb=wb, refine=refine, exclude_self=exclude_self,
              head_pool=head_pool, keep=keep)

    def fn(state, queries, query_ids=None):
        outs = query_ivf_shards(state, queries, query_ids, **kw)
        return merge_topk(mesh, [o[0] for o in outs], [o[1] for o in outs], k)

    return fn


def query_ivf_shards(state: ShardedIVFState, queries: torch.Tensor,
                     query_ids: Optional[torch.Tensor], k: int, nprobe: int, win: int,
                     wb: Optional[int], refine: int, exclude_self: bool = True,
                     head_pool: int = 0, keep: int = 0) -> List[Tuple[torch.Tensor, ...]]:
    """Each shard's own (ids [B, k], scores [B, k]) of `ivf_topk` over its
    rows, on its device."""
    qc, ic = {}, {}
    out = []
    for st in state.shards:
        dev = st.sketch.device
        out.append(ivf_topk(st.sketch, st.corpus, st.row_ids, st.centroids, st.starts, st.ends,
                            _on(queries, dev, qc),
                            None if query_ids is None else _on(query_ids, dev, ic), k,
                            nprobe=nprobe, win=win, wb=wb, refine=refine,
                            exclude_self=exclude_self, heads=st.heads if keep else None,
                            head_pool=head_pool, keep=keep))
    return out


class ShardedIVFIndex:
    """Host orchestrator for the sharded IVF engine (the query surface of
    `IVFFlatIndex`; `nprobe` is the recall knob). `head_pool` rows per
    pooled head row (dividing `win`) and `keep` windows per query and shard
    turn on window pruning."""

    def __init__(self, mesh: Optional[ForestMesh] = None, target_cluster: int = 256,
                 nprobe: int = 32, win: int = 64, refine: int = 128, iters: int = 6,
                 seed: int = 0, wb: Optional[int] = None, head_pool: int = 0, keep: int = 0):
        self.mesh = mesh
        self.target_cluster = target_cluster
        self.nprobe = nprobe
        self.win = win
        self.refine = refine
        self.iters = iters
        self.seed = seed
        self.wb = wb
        self.head_pool = head_pool
        self.keep = keep
        self.state: Optional[ShardedIVFState] = None

    def fit(self, batch) -> "ShardedIVFIndex":
        self.state, self.mesh = fit_ivf_sharded(batch.values, batch.ids, self.mesh,
                                                target_cluster=self.target_cluster,
                                                iters=self.iters, seed=self.seed)
        self.ensure_heads()
        return self

    def ensure_heads(self) -> None:
        """Build the derived per-shard head tier when pruning is configured
        (fit and load call it; heads are never saved)."""
        if self.state is None or not self.head_pool:
            return
        self.state = build_heads_sharded(self.state, self.mesh, self.head_pool)

    def query(self, queries, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True, nprobe: Optional[int] = None,
              keep: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; an
        unfitted index prints the reference's message and answers -1 ids
        and -inf scores."""
        if self.state is None:
            print("need to fit the data first")
            kk = max(k, 1)
            return (np.full((len(queries), kk), -1, np.int32),
                    np.full((len(queries), kk), -np.inf, np.float32))
        ids, scores = self.query_device(queries, k, query_ids, exclude_self, nprobe, keep)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, queries, k: int = 10, query_ids=None, exclude_self: bool = True,
                     nprobe: Optional[int] = None, keep: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer, the whole batch at once."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        npb = min(nprobe or self.nprobe, int(self.state.centroids.shape[0]))
        wb = self.wb or ivf_window_budget_sharded(self.state, npb, self.win, mesh=self.mesh)
        kp = self.keep if keep is None else keep
        if self.state.shards[0].heads is None or not self.head_pool:
            kp = 0
        fn = make_ivf_query_fn(self.mesh, k=k, nprobe=npb, win=self.win, wb=wb,
                               refine=self.refine, exclude_self=exclude_self,
                               head_pool=self.head_pool if kp else 0, keep=kp)
        dev = self.mesh.comm_device
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        qids = (None if query_ids is None
                else torch.as_tensor(query_ids).to(dev, torch.int32))
        return fn(self.state, q, qids)
