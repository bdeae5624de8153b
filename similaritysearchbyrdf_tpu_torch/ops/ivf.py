"""Clustered-flat (IVF) engine: k-means layout + probed window scan.

Counterpart of `similaritysearchbyrdf_tpu/ops/ivf.py`:

  build  spherical Lloyd k-means of the corpus (bf16 rows, assignment by
         the largest inner product), then the int8 sketch and the exact tier
         stored cluster-ordered: each cluster one contiguous row range,
         padded to a multiple of 8 rows;
  query  centroid scores → the top `nprobe` clusters → their rows in
         aligned windows of `win` rows, scored against the bf16 query by K2b
         (`ops/kernels/coarse_gather.py`, the sketch as a one-table tier;
         optionally pruned first to the `keep` windows whose pooled head
         rows score best) → the top `refine` rows → the exact f32 re-score
         of `ops/flat.py`.

Widths: the sketch, the exact tier and the centroids are padded with zero
columns to a multiple of 32 (the port's sketch width), where the JAX
package pads to 128; zero columns change no score.

Numerics:
  * every bf16 product with f32 output of the reference (centroid scores,
    the k-means assignment, head scores) is `precision.matmul_f32`: exact
    products, so only the summation order differs from the reference. A
    bf16 `matmul` on the card would round the scores to bf16 and tie
    argmaxes the reference keeps apart.
  * the k-means update sums each cluster's rows exactly, in int64 fixed
    point (`_cluster_sums`), so the sums do not depend on the order of the
    additions and two builds from one seed lay out identically on the card
    (a float scatter-add with atomics would not). The reference's f32 sums
    round; the new centroids agree with its within one bf16 step.
  * every `top_k`, `approx_max_k` and one-key `lax.sort` of the reference
    is a stable sort here: exact, ties in index order, as the reference's
    CPU path gives them.

The reference's XLA row gather (its non-TPU branch of `ivf_topk`) is K2b's
plain version here, taken for CPU tensors only; a CUDA tensor launches K2b.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.families import Device, resolve_device
from ..utils.timing import span
from ..vectors import DenseBatch
from .flat import (_SKETCH_COLS, _exact_refine, _pad_cols, _pad_rows, _round_up,
                   build_flat_sketch, effective_query_batch, quantize_sketch_rows,
                   sketch_scale)
from .kernels.coarse_gather import coarse_window_scores_kernel
from .precision import matmul_f32
from .rerank import top_sorted

NEG_INF = float("-inf")
# rows assigned at once: the assignment's [chunk, K] f32 scores are 1 GB at
# K 31,250 (the reference's 65,536-row chunk would make 8.2 GB); the argmax
# of a row does not depend on the chunk
_ASSIGN_CHUNK = 8192
_UPDATE_CHUNK = 1 << 20    # rows summed into the clusters at once


# ---------------------------------------------------------------------------
# k-means (spherical Lloyd)
# ---------------------------------------------------------------------------


def _kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                   chunk: int = _ASSIGN_CHUNK) -> torch.Tensor:
    """The assignment: i32[N], each row's centroid of largest bf16 inner
    product (the first on ties, as `argmax` gives it), `chunk` rows at a
    time."""
    ct = centroids.to(torch.bfloat16).T
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for c0 in range(0, x.shape[0], chunk):
        sc = matmul_f32(x[c0:c0 + chunk], ct, torch.bfloat16)
        out[c0:c0 + chunk] = sc.argmax(dim=1).to(torch.int32)
    return out


def cluster_bits(amax: float, n: int) -> int:
    """The fixed-point shift of the cluster sums: as large as keeps any sum
    of n rows of values below `amax` in magnitude below 2^62."""
    return 62 - math.frexp(amax)[1] - n.bit_length()      # |x| < 2^frexp exponent


def _cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f64[K, D] sums, int64[K] counts) of the rows with assign >= 0. Each
    value is scaled by a power of two 2^bits, rounded to int64 and added
    with integer adds, which give one result in any order: bits is as
    large as keeps any sum of N rows below 2^62, so a bf16 corpus loses at
    most its values below 2^-bits (below 2^-39 for 8M unit rows)."""
    n = x.shape[0]
    bits = cluster_bits(float(x.abs().max()) if n else 0.0, n)
    sums, counts = cluster_sums_fixed(x, assign, k, bits)
    return sums.to(torch.float64) * 2.0 ** -bits, counts


def cluster_sums_fixed(x: torch.Tensor, assign: torch.Tensor, k: int, bits: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[K, D] sums of the rows with assign >= 0, each value scaled by
    2^bits and rounded, int64[K] counts): integer sums, so sums of parts
    (shards, processes) add up to the whole's in any order."""
    n, d = x.shape
    live = assign >= 0
    sums = torch.zeros((k, d), dtype=torch.int64, device=x.device)
    for c0 in range(0, n, _UPDATE_CHUNK):
        a = assign[c0:c0 + _UPDATE_CHUNK]
        lv = live[c0:c0 + _UPDATE_CHUNK]
        # scaling by a power of two is exact in float64
        fixed = torch.round(x[c0:c0 + _UPDATE_CHUNK][lv].to(torch.float64) * 2.0 ** bits)
        sums.index_add_(0, a[lv].to(torch.int64), fixed.to(torch.int64))
    counts = torch.bincount(assign[live].to(torch.int64), minlength=k)
    return sums, counts


def update_centroids(sums: torch.Tensor, counts: torch.Tensor, centroids: torch.Tensor
                     ) -> torch.Tensor:
    """New centroids bf16[K, D] from f64 cluster sums and counts: the mean;
    an empty cluster keeps its centroid; every centroid scaled to unit
    norm."""
    mean = (sums / counts.clamp(min=1)[:, None].to(torch.float64)).to(torch.float32)
    new_c = torch.where((counts > 0)[:, None], mean, centroids.to(torch.float32))
    norm = torch.linalg.vector_norm(new_c, dim=1, keepdim=True)
    return (new_c / norm.clamp(min=1e-20)).to(torch.bfloat16)


def _kmeans_iter(x: torch.Tensor, centroids: torch.Tensor, valid: torch.Tensor,
                 chunk: int = _ASSIGN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration on bf16 rows x[N, Dp] → (new centroids bf16[K,
    Dp], assign i32[N], -1 for invalid rows): assign by the largest inner
    product, update by the mean; an empty cluster keeps its centroid, and
    every centroid is scaled to unit norm (assignment is by inner product,
    so a long centroid would swallow everything)."""
    k = centroids.shape[0]
    assign = torch.where(valid, _kmeans_assign(x, centroids, chunk), -1)
    sums, counts = _cluster_sums(x, assign, k)
    return update_centroids(sums, counts, centroids), assign


def kmeans(x: torch.Tensor, valid: torch.Tensor, k: int, iters: int = 8, seed: int = 0,
           chunk: int = _ASSIGN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical Lloyd k-means of the rows x[N, Dp] (f32 or bf16) → (centroids
    bf16[K, Dp], assign i32[N], -1 for invalid rows). The initial centroids
    are the bf16 rows the reference's numpy draw picks among the valid ones
    (`valid` need not be a prefix)."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("kmeans: empty corpus")
    rng = np.random.default_rng(seed ^ 0xC1)
    pool = np.flatnonzero(valid.cpu().numpy())
    if pool.size == 0:
        raise ValueError("kmeans: no valid rows")
    init_rows = rng.choice(pool, size=k, replace=pool.size < k)
    xb = x.to(torch.bfloat16)
    centroids = xb[torch.as_tensor(init_rows, device=x.device)]
    assign = None
    for _ in range(iters):
        centroids, assign = _kmeans_iter(xb, centroids, valid, chunk)
    return centroids, assign


def kmeans_sampled(x: torch.Tensor, k: int, train_sample: int, iters: int = 8,
                   seed: int = 0, chunk: int = _ASSIGN_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd on `train_sample` rows drawn uniformly (the reference's numpy
    draw), then one assignment of every row (all rows valid)."""
    n = x.shape[0]
    s = min(train_sample, n)
    rng = np.random.default_rng(seed ^ 0x5A)
    sel = np.sort(rng.choice(n, size=s, replace=False))
    xs = x[torch.as_tensor(sel, device=x.device)]
    centroids, _ = kmeans(xs, torch.ones(s, dtype=torch.bool, device=x.device), k,
                          iters=iters, seed=seed, chunk=chunk)
    del xs
    return centroids, _kmeans_assign(x, centroids, chunk)


# ---------------------------------------------------------------------------
# build: cluster-ordered layout
# ---------------------------------------------------------------------------


class IVFState(NamedTuple):
    sketch: torch.Tensor      # i8 (or bf16) [Npad, Dp]  cluster-ordered scoring copy
    corpus: torch.Tensor      # f32 (or bf16) [Npad, Dp] cluster-ordered exact tier
    row_ids: torch.Tensor     # i32[Npad] user ids (-1 = pad)
    centroids: torch.Tensor   # bf16[K, Dp] unit-norm cluster centres
    starts: torch.Tensor      # i32[K+1] 8-aligned cluster offsets
    # i32[K] true cluster ends: the alignment pad rows are zero and score 0,
    # which would beat real negative-scoring candidates into the refine set
    ends: torch.Tensor
    # bf16[ceil(Npad/hp), Dp] mean-pooled head tier for window pruning,
    # derived from the sketch (`build_ivf_heads`)
    heads: Optional[torch.Tensor] = None


def ivf_live_rows(starts: torch.Tensor, ends: torch.Tensor, npad: int) -> torch.Tensor:
    """bool[npad]: the rows some cluster holds, [starts[c], ends[c]) for
    every c. The layout marks its rows by position, so a row whose user id
    is negative is live too (the JAX package reads the -1 id as padding)."""
    edge = torch.zeros(npad + 1, dtype=torch.int32, device=starts.device)
    lo = starts[:-1].to(torch.int64).clamp(max=npad)
    hi = ends.to(torch.int64).clamp(max=npad)
    edge.index_add_(0, lo, torch.ones_like(lo, dtype=torch.int32))
    edge.index_add_(0, hi, torch.full_like(hi, -1, dtype=torch.int32))
    return torch.cumsum(edge, 0)[:npad] > 0


def build_ivf_heads(sketch: torch.Tensor, row_ids: torch.Tensor, hp: int,
                    live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head tier bf16[ceil(Npad/hp), Dp]: row g is the mean of the live
    sketch rows [g*hp, (g+1)*hp) (the 8-alignment pad rows are zero and
    would dilute it), summed in f32 and divided by the live count. A pool
    may straddle two clusters: it is a proxy, masked per window at query
    time by head-row/window overlap. `live` is the layout's live rows
    (`ivf_live_rows`); without it, the rows whose id is >= 0, as the JAX
    package takes them."""
    n, dp = sketch.shape
    h = -(-n // hp)
    s = _pad_rows(sketch, h * hp).view(h, hp, dp).to(torch.float32)
    live = row_ids >= 0 if live is None else live
    m = torch.nn.functional.pad(live, (0, h * hp - n)).view(h, hp, 1).to(torch.float32)
    return ((s * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)).to(torch.bfloat16)


def default_train_sample(n: int, k: int) -> Optional[int]:
    """The opt-in sampled-Lloyd policy: train on max(1M, 32 rows a cluster)
    sampled rows past 2M rows, then assign every row once."""
    if n <= 2_000_000:
        return None
    return min(n, max(1_000_000, 32 * k))


def _cluster_perm(assign: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-ordered permutation with every cluster padded to a multiple
    of 8 rows → (perm i64[npad_total] source rows, -1 = pad; starts
    i64[K+1]; counts i64[K]). Within a cluster, rows keep corpus order."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k)
    starts = np.zeros(k + 1, np.int64)
    starts[1:] = np.cumsum((counts + 7) // 8 * 8)
    src_off = np.zeros(k + 1, np.int64)
    src_off[1:] = np.cumsum(counts)
    a_sorted = assign[order]
    perm = np.full(int(starts[-1]), -1, np.int64)
    perm[starts[a_sorted] + np.arange(order.size) - src_off[a_sorted]] = order
    return perm, starts, counts


def _n_clusters(n: int, target_cluster: int, k: Optional[int]) -> int:
    return int(np.clip(n // target_cluster, 16, 65536)) if k is None else k


def build_ivf(corpus: torch.Tensor, row_ids, target_cluster: int = 256, iters: int = 8,
              seed: int = 0, sketch_dtype: str = "int8", k: Optional[int] = None,
              train_sample: "Optional[int] | str" = None) -> IVFState:
    """Cluster the corpus f32[N, D] (on its device) and lay out both tiers
    cluster-ordered. `k` defaults to N // target_cluster within [16, 65536].
    `train_sample`: Lloyd on that many sampled rows, then one assignment of
    every row (None: train on every row; "auto": `default_train_sample`)."""
    n, d = corpus.shape
    dev = corpus.device
    corpus_p = _pad_cols(corpus.to(torch.float32), _round_up(d, _SKETCH_COLS))
    k = _n_clusters(n, target_cluster, k)
    if train_sample == "auto":
        train_sample = default_train_sample(n, k)
    if train_sample is not None and train_sample < n:
        centroids, assign = kmeans_sampled(corpus_p, k, train_sample, iters=iters, seed=seed)
    else:
        centroids, assign = kmeans(corpus_p, torch.ones(n, dtype=torch.bool, device=dev), k,
                                   iters=iters, seed=seed)
    perm, starts, counts = _cluster_perm(assign.cpu().numpy(), k)
    perm_d = torch.as_tensor(perm, device=dev)
    dead = perm_d < 0
    safe = perm_d.clamp(min=0)
    corpus_o = corpus_p[safe].masked_fill_(dead[:, None], 0.0)
    sketch, _ = build_flat_sketch(corpus_o, sketch_dtype)
    rid = torch.as_tensor(np.asarray(row_ids, dtype=np.int32), device=dev)
    return IVFState(sketch=sketch, corpus=corpus_o,
                    row_ids=rid[safe].masked_fill_(dead, -1), centroids=centroids,
                    starts=torch.as_tensor(starts.astype(np.int32), device=dev),
                    ends=torch.as_tensor((starts[:-1] + counts).astype(np.int32), device=dev))


def build_ivf_streamed(corpus_np: np.ndarray, row_ids: np.ndarray, target_cluster: int = 256,
                       iters: int = 6, seed: int = 0, train_sample: int = 2_000_000,
                       corpus_dtype: str = "bfloat16", chunk_rows: int = 1 << 20,
                       k: Optional[int] = None, kmeans_chunk: int = _ASSIGN_CHUNK,
                       device: Device = None) -> IVFState:
    """The large-N build: the f32 corpus stays on the host, and the device
    (`device`, default the first CUDA card) holds the int8 sketch and a
    `corpus_dtype` (bf16 by default) exact tier. Lloyd trains on
    `train_sample` sampled rows; the assignment and the cluster-ordered
    layout go to the device `chunk_rows` rows at a time. The tiers are
    allocated in whole chunks, as the reference's are; rows past the last
    cluster are dead (id -1)."""
    device = resolve_device(device)
    n, d = corpus_np.shape
    dp = _round_up(d, _SKETCH_COLS)
    k = _n_clusters(n, target_cluster, k)
    rng = np.random.default_rng(seed ^ 0x5A)
    s = min(train_sample, n)
    sel = np.sort(rng.choice(n, size=s, replace=False))
    xs = np.zeros((s, dp), np.float32)
    xs[:, :d] = corpus_np[sel]
    centroids, _ = kmeans(torch.as_tensor(xs, device=device),
                          torch.ones(s, dtype=torch.bool, device=device), k, iters=iters,
                          seed=seed, chunk=kmeans_chunk)
    del xs

    def rows_to_device(rows: np.ndarray) -> torch.Tensor:
        return _pad_cols(torch.as_tensor(np.asarray(rows, np.float32), device=device), dp)

    assign = np.empty(n, np.int32)
    for s0 in range(0, n, chunk_rows):
        xc = rows_to_device(corpus_np[s0:s0 + chunk_rows])
        assign[s0:s0 + chunk_rows] = _kmeans_assign(xc, centroids, kmeans_chunk).cpu().numpy()
    perm, starts, counts = _cluster_perm(assign, k)
    npad_total = int(starts[-1])
    amax = 0.0
    for s0 in range(0, n, chunk_rows):
        amax = max(amax, float(np.abs(corpus_np[s0:s0 + chunk_rows]).max()))
    scale = sketch_scale(amax)

    cdt = torch.bfloat16 if corpus_dtype == "bfloat16" else torch.float32
    npad_alloc = -(-npad_total // chunk_rows) * chunk_rows
    sketch = torch.zeros((npad_alloc, dp), dtype=torch.int8, device=device)
    corpus_o = torch.zeros((npad_alloc, dp), dtype=cdt, device=device)
    rids_o = torch.full((npad_alloc,), -1, dtype=torch.int32, device=device)
    rid = np.asarray(row_ids, np.int32)
    for s0 in range(0, npad_total, chunk_rows):
        pc = perm[s0:s0 + chunk_rows]
        live = pc >= 0
        rows_h = np.zeros((pc.size, d), np.float32)
        rows_h[live] = corpus_np[pc[live]]
        ids_h = np.full(pc.size, -1, np.int32)
        ids_h[live] = rid[pc[live]]
        rows = rows_to_device(rows_h)
        sketch[s0:s0 + pc.size] = quantize_sketch_rows(rows, scale)
        corpus_o[s0:s0 + pc.size] = rows.to(cdt)
        rids_o[s0:s0 + pc.size] = torch.as_tensor(ids_h, device=device)
    return IVFState(sketch=sketch, corpus=corpus_o, row_ids=rids_o, centroids=centroids,
                    starts=torch.as_tensor(starts.astype(np.int32), device=device),
                    ends=torch.as_tensor((starts[:-1] + counts).astype(np.int32),
                                         device=device))


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """`a` as a numpy array; a tensor's copy is a host wait."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    with span("rdf.sync.window_budget"):
        return a.cpu().numpy()


def ivf_window_budget(starts, ends, nprobe: int, win: int, cap: int = 4096) -> int:
    """Windows per query that cannot truncate a probed cluster: the sum of
    the `nprobe` largest clusters' window counts (the worst probe set),
    at least `nprobe`, at most `cap` (past it, `_flatten_windows` drops
    the last-selected clusters first). Takes [K+1]/[K] or per-shard [S,
    K+1]/[S, K] offsets, as arrays or tensors."""
    st, en = _host(starts), _host(ends)
    lens = en - st[..., :-1]
    if lens.size == 0:
        return nprobe
    wc = -np.sort(-((lens + win - 1) // win), axis=-1)[..., :nprobe]
    need = int(wc.sum(axis=-1).max())
    return int(min(max(need, nprobe), cap))


def _flatten_windows(sel_start: torch.Tensor, sel_end: torch.Tensor, win: int, wb: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged flatten of the selected clusters [B, P] (8-aligned starts,
    true ends) into `wb` windows of `win` rows per query, in selection
    order: window j belongs to the first cluster whose cumulative window
    count exceeds j. → (blk_start int64[B, WB], end int64[B, WB], live
    bool[B, WB])."""
    b, p = sel_start.shape
    sel_start, sel_end = sel_start.to(torch.int64), sel_end.to(torch.int64)
    wc = (sel_end - sel_start + win - 1) // win
    cum = torch.cumsum(wc, dim=1)
    base = cum - wc
    j = torch.arange(wb, device=sel_start.device)
    idx = torch.searchsorted(cum, j.expand(b, wb).contiguous(), right=True)
    safe = idx.clamp(max=p - 1)
    blk = torch.gather(sel_start, 1, safe) + (j - torch.gather(base, 1, safe)) * win
    end = torch.gather(sel_end, 1, safe)
    return blk, end, (idx < p) & (blk < end)


def _ivf_prune_windows(heads: torch.Tensor, hp: int, qb: torch.Tensor, blk: torch.Tensor,
                       end_b: torch.Tensor, live: torch.Tensor, win: int, keep: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window pruning on the head tier: score every window by the best of
    the head rows it overlaps (bf16 products, f32 sums) and keep the `keep`
    best windows per query (stable: ties in slot order), back in slot
    order. The head score is a proxy, not a bound: `keep` trades recall for
    scored windows."""
    h = heads.shape[0]
    # starts are 8-aligned, not hp-aligned: one extra head row covers the straddle
    gidx = (blk // hp)[..., None] + torch.arange(win // hp + 1, device=blk.device)
    rows = heads[gidx.clamp(0, h - 1)]                                # [B, WB, R, Dp]
    sc = matmul_f32(rows, qb[:, None, :, None], torch.bfloat16)[..., 0]
    row_lo = gidx * hp
    hi = torch.minimum(blk + win, end_b)[..., None]
    hvalid = (row_lo + hp > blk[..., None]) & (row_lo < hi)
    wscore = torch.where(hvalid, sc, NEG_INF).amax(dim=2)
    wscore = torch.where(live, wscore, NEG_INF)
    _, wi = torch.sort(wscore, dim=1, descending=True, stable=True)
    wi, _ = torch.sort(wi[:, :keep], dim=1)
    return tuple(torch.gather(a, 1, wi) for a in (blk, end_b, live))


def ivf_topk(sketch: torch.Tensor, corpus: torch.Tensor, row_ids: torch.Tensor,
             centroids: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
             queries: torch.Tensor, query_ids: Optional[torch.Tensor], k: int, nprobe: int = 32,
             win: int = 256, wb: Optional[int] = None, refine: int = 128,
             exclude_self: bool = True, heads: Optional[torch.Tensor] = None,
             head_pool: int = 0, keep: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF query → (ids i32[B, k] user ids, scores f32[B, k]; -1 / -inf
    pads): centroid scores → top-`nprobe` clusters → their windows scored
    by K2b → top-`refine` rows → exact f32 re-score. `wb` windows per query
    (default: every window of the corpus plus one round-up per cluster;
    callers pass `ivf_window_budget`). With `heads`, `head_pool` (dividing
    `win`) and 0 < keep < wb, the windows are pruned to `keep` first. A
    row is a candidate only inside its cluster's [start, end), so padding
    is known by position and any user id can be returned; `query_ids`
    None excludes nothing."""
    npad, dp = sketch.shape
    kc = centroids.shape[0]
    b = queries.shape[0]
    dev = sketch.device
    wb = wb or max(-(-npad // win) + kc, 1)
    with span("rdf.candidates"):
        qp = _pad_cols(queries.to(torch.float32), dp)
        qb = qp.to(torch.bfloat16).contiguous()
        c_scores = matmul_f32(qb, centroids.T, torch.bfloat16)           # [B, K]
        sel = top_sorted(c_scores, min(nprobe, kc))[1]                   # [B, P]
        blk, end_b, live = _flatten_windows(starts[sel], ends[sel], win, wb)
        if 0 < keep < wb and heads is not None and head_pool > 0 and win % head_pool == 0:
            blk, end_b, live = _ivf_prune_windows(heads, head_pool, qb, blk, end_b, live,
                                                  win, keep)
            wb = keep
    # the windows are read at min(blk, npad - win), as K2b clips them, and
    # labelled with the rows they read; rows before blk belong to earlier
    # clusters and are masked by start = blk. A sketch shorter than one
    # window is padded with zero rows to `win` (masked by pos < end)
    blk_dma = blk.clamp(max=max(npad - win, 0))
    tier = (sketch if npad >= win else _pad_rows(sketch, win))[None]

    def i32(a):
        return a.to(torch.int32).contiguous()

    with span("rdf.score"):
        w_scores = coarse_window_scores_kernel(
            tier, qb, torch.zeros((b, wb), dtype=torch.int32, device=dev), i32(blk_dma),
            i32(blk), i32(end_b), live.contiguous(), win).reshape(b, wb * win)  # -inf invalid
        pos = (blk_dma[..., None] + torch.arange(win, device=dev)).reshape(b, wb * win)
    with span("rdf.select"):
        sel_s, si = top_sorted(w_scores, min(refine, wb * win))
        fin = torch.isfinite(sel_s)
        cand = torch.where(fin, torch.gather(pos, 1, si), npad)
    with span("rdf.rerank"):
        return _exact_refine(corpus, row_ids, qp, cand.clamp(0, npad - 1), fin, query_ids, k,
                             exclude_self)


def tune_nprobe(index: "IVFFlatIndex", sample_queries: np.ndarray, target_recall: float = 0.95,
                k: int = 10, candidates: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)
                ) -> int:
    """The smallest candidate `nprobe` whose top-k matches the index's own
    full-probe pass (every cluster scored) at `target_recall`; sets
    `index.nprobe` and returns it."""
    st = index.state
    if st is None:
        raise RuntimeError("need to fit the data first")
    kc = int(st.centroids.shape[0])
    q = np.asarray(sample_queries, np.float32)
    ref_ids, ref_sc = index.query(q, k=k, exclude_self=False, nprobe=kc)
    # a result is present where its score is finite (any id, negative too)
    ref_sets = [set(map(int, r[np.isfinite(s)])) for r, s in zip(ref_ids, ref_sc)]
    denom = max(sum(len(s) for s in ref_sets), 1)
    for p in sorted(set(min(c, kc) for c in candidates)):
        ids, sc = index.query(q, k=k, exclude_self=False, nprobe=p)
        hits = sum(len(ref_sets[i] & set(map(int, ids[i][np.isfinite(sc[i])])))
                   for i in range(len(ref_sets)))
        if hits / denom >= target_recall:
            index.nprobe = p
            return p
    index.nprobe = kc
    return kc


class IVFFlatIndex:
    """Host orchestrator for the clustered-flat engine (the query surface
    of `FlatIndex`; `nprobe` is the recall knob). Its tensors live on
    `device` (default: the first CUDA card; `device="cpu"` for the CPU).
    `wb` caps the windows per query (None: `ivf_window_budget`, which never
    truncates); `head_pool` rows per pooled head row (dividing `win`) and
    `keep` windows per query turn on window pruning (keep 0: off)."""

    def __init__(self, target_cluster: int = 256, nprobe: int = 32, win: int = 256,
                 refine: int = 128, iters: int = 8, query_batch: int = 1024, seed: int = 0,
                 train_sample: "Optional[int] | str" = None, wb: Optional[int] = None,
                 head_pool: int = 0, keep: int = 0, device: Device = None):
        self.target_cluster = target_cluster
        self.nprobe = nprobe
        self.win = win
        self.refine = refine
        self.iters = iters
        self.query_batch = query_batch
        self.seed = seed
        self.train_sample = train_sample
        self.wb = wb
        self.head_pool = head_pool
        self.keep = keep
        self.device = resolve_device(device)
        self.state: Optional[IVFState] = None

    def fit(self, batch: DenseBatch) -> "IVFFlatIndex":
        """batch: vectors.DenseBatch (numpy values or a tensor)."""
        self.state = build_ivf(
            torch.as_tensor(batch.values, dtype=torch.float32).to(self.device),
            np.asarray(batch.ids, np.int32), target_cluster=self.target_cluster,
            iters=self.iters, seed=self.seed, train_sample=self.train_sample)
        self.ensure_heads()
        return self

    def ensure_heads(self) -> None:
        """Build the derived head tier when window pruning is configured."""
        if self.state is None or not self.head_pool:
            return
        st = self.state
        self.state = st._replace(heads=build_ivf_heads(
            st.sketch, st.row_ids, self.head_pool,
            live=ivf_live_rows(st.starts, st.ends, st.sketch.shape[0])))

    def query(self, queries, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True, nprobe: Optional[int] = None,
              keep: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; an
        unfitted index answers -1 ids and -inf scores."""
        if self.state is None:
            print("need to fit the data first")
            return (np.full((len(queries), k), -1, np.int32),
                    np.full((len(queries), k), -np.inf, np.float32))
        with span("rdf.query"):
            ids, scores = self.query_device(queries, k, query_ids, exclude_self, nprobe, keep)
            with span("rdf.sync.answers"):
                ids = ids.cpu().numpy()
            with span("rdf.sync.answers"):
                scores = scores.cpu().numpy()
        return ids, scores

    def query_device(self, queries, k: int = 10, query_ids=None, exclude_self: bool = True,
                     nprobe: Optional[int] = None, keep: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the index's device,
        taken `effective_query_batch` queries at a time, each chunk padded
        to that batch."""
        if self.state is None:
            raise RuntimeError("need to fit the data first")
        st = self.state
        with span("rdf.sync.upload"):
            q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = q.shape[0]
        qids = None
        if query_ids is not None:
            with span("rdf.sync.upload"):
                qids = torch.as_tensor(query_ids, dtype=torch.int32).to(self.device)
        npb = nprobe or self.nprobe
        bsz = effective_query_batch(nq, self.query_batch)
        wb = self.wb or ivf_window_budget(st.starts, st.ends, npb, self.win)
        kp = self.keep if keep is None else keep
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            qc = _pad_rows(q[s0:s1], bsz)
            qi = None if qids is None else torch.nn.functional.pad(qids[s0:s1], (0, bsz - (s1 - s0)))
            with span("rdf.chunk"):
                ids, scores = ivf_topk(st.sketch, st.corpus, st.row_ids, st.centroids,
                                       st.starts, st.ends, qc, qi, k, nprobe=npb, win=self.win,
                                       wb=wb, refine=self.refine, exclude_self=exclude_self,
                                       heads=st.heads, head_pool=self.head_pool, keep=kp)
            out_i.append(ids[:s1 - s0])
            out_s.append(scores[:s1 - s0])
        return torch.cat(out_i), torch.cat(out_s)
