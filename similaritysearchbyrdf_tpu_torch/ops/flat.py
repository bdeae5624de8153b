"""Quantized-flat engine: brute-force sketch scan + exact f32 refine.

Counterpart of the dense part of `similaritysearchbyrdf_tpu/ops/flat.py`:

  sketch  a low-precision copy of the corpus (int8 with one global scale,
          or bf16), its columns padded with zeros to a multiple of 32 (the
          int8 `mma` depth; zero columns change no score)
  scan    `flat_topk`: scores = q̂ · sketchᵀ a block of rows at a time, a
          running top-`refine`, then the exact f32 re-score
  grouped `flat_topk_grouped`, `FlatIndex`'s default: K4 (`ops/kernels/
          flat_groupmax.py`) takes the max of every 64 consecutive rows'
          scores without writing [B, N], then either
          * exact2: an exact two-level select of the top groups, a row-wise
            re-score of their rows through K2b's aligned windows, a
            top-`refine` select; or
          * argpack (int8, from 1M rows): K4 packs each group's best row into
            its key, and a two-level select of the top-`refine` keys names
            the candidate rows directly;
          then the same exact f32 re-score.

Every `top_k`, `approx_max_k` and one-key `lax.sort` of the reference is a
stable sort here (exact, ties in index order, as the reference's CPU path
gives them). The TPU tactics are not ported: the strided second sketch copy
(`stride_for_halved_gmax`, `sketch_gmax`), 128-lane padding, the VMEM tile
plans and batch caps, `nsub`, the qmajor/qlane kernel split and the
`FLAT_*` environment knobs, whose defaults are the constants and keywords
below.

`FlatIndex.query` opens the tracing spans of `utils/timing.py`: one
`rdf.query` a call, `rdf.sync.upload` and `rdf.sync.answers` round its
host waits, one `rdf.chunk` a query batch, and in it `rdf.score` (the int8
query, K4, the dead-group mask), `rdf.select` (the argpack or exact2
select; in it `rdf.sgtier` where the argpack select folds K4's emitted
supergroup tier) and `rdf.rerank` (the exact re-score, opened here and not
inside `_exact_refine`, which `ops/ivf.py` calls inside its own
`rdf.rerank`).

The sparse flat engine (`SparseFlatIndex`, `flat_topk_sparse`) scans an
int8 sketch of the densified sparse corpus (`build_flat_sketch_sparse`)
with the same grouped preselection and re-scores the candidates exactly by
the sort-merge sparse dot (`rerank.sparse_merge_scores`): the sparse corpus
is never densified to f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.families import Device, resolve_device
from ..utils.timing import span
from ..vectors import DenseBatch, SparseBatch
from .kernels.coarse_gather import coarse_window_scores_kernel
from .kernels.flat_groupmax import flat_groupmax_kernel
from .hashing import densify
from .precision import full_f32
from .rerank import check_sparse_size_for_merge, sparse_merge_scores, top_sorted

NEG_INF = float("-inf")
_I32_DEAD = -(2**31 - 1)   # dead-group sentinel; negation-safe (not int32 min)
_GROUP = 64                # rows per group == re-score window rows
_NPAD_MULTIPLE = 8192      # row padding of the grouped paths: sets NG and the group numbering
_ARGPACK_MIN_ROWS = 1 << 20
_SKETCH_COLS = 32          # sketch column padding: the int8 mma depth
_LANES = 128               # the reference's sketch column padding (select-mode test only)
_QUANT_CHUNK = 1 << 20     # corpus rows quantized at once
_DENSIFY_CHUNK = 65536     # sparse rows densified at once
_ARGPACK_L2 = "sort"


def _default_select_sg(mode: str) -> int:
    """Supergroup width of the two-level selects: 32 for argpack, 64 for
    exact2 (the reference's defaults without `FLAT_SELECT_SG`)."""
    return 32 if mode == "argpack" else 64


def _resolve_select_mode(mode: str, sketch_dtype: torch.dtype, nrows: int, d: int = 0) -> str:
    """"auto" is argpack for an int8 sketch of at least 1M rows whose packed
    key fits int32, else exact2; an explicit "argpack" that cannot pack
    falls back to exact2. `d` is the sketch's width, which the test takes
    rounded up to a multiple of 128 as the reference's lane-padded sketch
    has it (`ops/flat.py:114,155` of the JAX package), so both packages pick
    the same mode for D 2049-2080."""
    d = _round_up(d, _LANES)
    pack_ok = sketch_dtype == torch.int8 and d * 127 * 127 * _GROUP < 2**31
    if mode != "auto":
        return "exact2" if mode == "argpack" and not pack_ok else mode
    return "argpack" if pack_ok and nrows >= _ARGPACK_MIN_ROWS else "exact2"


def effective_query_batch(nq: int, query_batch: int) -> int:
    """The padded dispatch batch: the next power of two >= nq (floor 32),
    capped at `query_batch`."""
    if nq >= query_batch:
        return query_batch
    b = 32
    while b < nq:
        b <<= 1
    return min(b, query_batch)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pad_cols(a: torch.Tensor, width: int) -> torch.Tensor:
    return a if a.shape[1] == width else torch.nn.functional.pad(a, (0, width - a.shape[1]))


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    return a if a.shape[0] == rows else torch.nn.functional.pad(a, (0, 0, 0, rows - a.shape[0]))


def build_flat_sketch(corpus: torch.Tensor, dtype: str = "int8",
                      scale: Optional[float] = None) -> Tuple[torch.Tensor, float]:
    """(sketch [N, ceil(D/32)*32], scale): int8 with one global scale
    127 / max|x| (computed in float64, applied as its f32 value, rounded
    half to even and clipped to ±127, the reference's order), or bf16 with
    scale 1.0. `amax` comes from one `aminmax` pass and the quantization
    runs `_QUANT_CHUNK` rows at a time, so no full-size temporary is made.
    A given `scale` is used as it is (a shard takes the whole corpus's)."""
    n, d = corpus.shape
    width = _round_up(d, _SKETCH_COLS)
    if dtype == "bfloat16":
        return _pad_cols(corpus.to(torch.bfloat16), width), 1.0
    if dtype != "int8":
        raise ValueError(f"unsupported flat sketch dtype: {dtype}")
    if scale is None:
        lo, hi = torch.aminmax(corpus) if corpus.numel() else (torch.zeros(()), torch.zeros(()))
        scale = sketch_scale(max(-float(lo), float(hi)))
    sketch = torch.zeros((n, width), dtype=torch.int8, device=corpus.device)
    for c0 in range(0, n, _QUANT_CHUNK):
        sketch[c0:c0 + _QUANT_CHUNK, :d] = quantize_sketch_rows(corpus[c0:c0 + _QUANT_CHUNK],
                                                                scale)
    return sketch, scale


def sketch_scale(amax: float) -> float:
    """The int8 sketch's one global scale, 127 / max|x|, in float64."""
    return 127.0 / max(amax, 1e-30)


def quantize_sketch_rows(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 sketch rows: x times `scale` applied as its f32 value, rounded
    half to even and clipped to ±127 (the reference's order)."""
    q = torch.round(x.to(torch.float32) * float(np.float32(scale)))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _quantize_queries(queries: torch.Tensor, sketch: torch.Tensor) -> torch.Tensor:
    """Queries in the sketch's type and width: int8 with a per-query scale
    127 / max|q| (a positive factor, so each query's ranking is unchanged),
    or bf16."""
    if sketch.dtype == torch.int8:
        qs = 127.0 / torch.clamp(queries.abs().amax(dim=1, keepdim=True), min=1e-30)
        q_lp = torch.clamp(torch.round(queries * qs), -127, 127).to(torch.int8)
    else:
        q_lp = queries.to(sketch.dtype)
    return _pad_cols(q_lp, sketch.shape[1]).contiguous()


def _exact_refine(corpus, row_ids, queries, cand, pre_valid, query_ids, k, exclude_self,
                  n_live=None):
    """Exact f32 re-score of the candidate rows + final top-k → (ids i32[B,
    k] with -1 padding, scores f32[B, k]). A bf16 corpus widens to f32
    before the dot, which runs in full f32 whatever the TF32 setting.

    A result is present where its score is finite. Padding rows are known
    by position, never by their id: rows from `n_live` on (None: every row
    of `row_ids` is live), so any user id, a negative one too, can be
    returned (the JAX package drops ids below 0). With `exclude_self`, a
    query's own id (`query_ids`, None for none) is left out."""
    n = row_ids.shape[0]
    safe = cand.clamp(0, n - 1).to(torch.int64)
    rows = corpus[safe].to(torch.float32)                           # [B, R, D]
    with full_f32():
        exact = torch.bmm(rows, queries[:, :, None].to(torch.float32))[..., 0]
    uid = row_ids[safe]
    valid = pre_valid if n_live is None else pre_valid & (cand < n_live)
    if exclude_self and query_ids is not None:
        valid = valid & (uid != query_ids[:, None])
    exact = torch.where(valid, exact, NEG_INF)
    top_s, ti = top_sorted(exact, k)
    top_u = torch.gather(uid, 1, ti)
    return torch.where(torch.isfinite(top_s), top_u, -1), top_s


def flat_topk(sketch: torch.Tensor, corpus: torch.Tensor, row_ids: torch.Tensor,
              queries: torch.Tensor, query_ids: torch.Tensor, k: int, refine: int = 128,
              block: int = 1 << 20, exclude_self: bool = True,
              n_live: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked sketch scan → (ids i32[B, k] user ids, scores f32[B, k]); -1
    pads. The sketch may carry padding rows past the n = len(row_ids)
    scanned ones; they are never candidates. Rows from `n_live` on are
    scanned but never results (a shard's padding, `_exact_refine`). Scores
    are an f32 matmul of f32 copies
    of the sketch block (exact for int8 below D 1024, where every partial
    sum is an integer below 2^24; int32 matmul is refused on the card); peak
    memory is one [B, block] score tile plus the running [B, refine]
    survivors."""
    n = row_ids.shape[0]
    b = queries.shape[0]
    dev = sketch.device
    q_f = None
    best_s = torch.full((b, refine), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, refine), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n, block):
        with span("rdf.score"):
            if q_f is None:
                q_f = _quantize_queries(queries, sketch).to(torch.float32)
            rows = sketch[c0:min(c0 + block, n)]
            scores = q_f @ rows.to(torch.float32).T                 # [B, rows]
        with span("rdf.select"):
            s_blk, ti = top_sorted(scores, min(refine, rows.shape[0]))
            cat_s = torch.cat([best_s, s_blk], dim=1)
            cat_i = torch.cat([best_i, (ti + c0).to(torch.int32)], dim=1)
            best_s, sel = top_sorted(cat_s, refine)
            best_i = torch.gather(cat_i, 1, sel)
    with span("rdf.rerank"):
        return _exact_refine(corpus, row_ids, queries, best_i,
                             (best_i >= 0) & torch.isfinite(best_s), query_ids, k,
                             exclude_self, n_live)


def packed_groupmax_qmajor(sk: torch.Tensor, q_i8: torch.Tensor, group: int = _GROUP
                           ) -> torch.Tensor:
    """Argmax-packed group maxima i32[B, npad/group] of a pre-quantized,
    pre-padded int8 query slab: K4 with `pack_arg`, for callers that manage
    their own quantization. Neither package calls it; it keeps the JAX
    package's public surface."""
    return flat_groupmax_kernel(sk, q_i8, group, pack_arg=True)


def _two_level(ng: int, sg: int, rg: int) -> bool:
    """Whether the argpack select takes its two levels over NG groups: they
    split into supergroups of `sg`, at least 2 rg of them (every top group's
    supergroup maximum then beats the rg-th best group, and at most rg
    supergroups can)."""
    return ng % sg == 0 and ng // sg >= 2 * rg


def _fold_emitted_sgmax(sgmax_pre, p3, n, group, sg, emit_sg):
    """Fold the kernel-emitted `emit_sg` supergroup tier to `sg`-wide
    supergroup maxima instead of re-reading the [B, NG] packed slab. The
    emitted tier is unmasked, but live groups are a prefix: supergroups
    wholly inside it are exact, and only the boundary and dead tail are
    recomputed from the masked packed slab `p3` [B, NSG, sg], written into
    the folded tier in place (at `sg == emit_sg`, into `sgmax_pre` itself)."""
    b, nsg, _ = p3.shape
    spre = sgmax_pre if sg == emit_sg else sgmax_pre.view(b, nsg, sg // emit_sg).amax(dim=2)
    full_sg = (-(-n // group)) // sg
    if full_sg < nsg:
        spre[:, full_sg:] = p3[:, full_sg:, :].amax(dim=2)
    return spre


def select_packed_rows(packed: torch.Tensor, group: int, refine: int, n: int,
                       select_sg: Optional[int] = None, l2: str = _ARGPACK_L2,
                       sgmax_pre: Optional[torch.Tensor] = None, emit_sg: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-`refine` rows of an argmax-packed slab i32[B, NG] → (cand
    i32[B, refine] row positions, sel_s f32[B, refine]; -inf = invalid).
    Two levels where NG allows (every top group's supergroup maximum beats
    the refine-th best group, and at most `refine` supergroups can): the
    top supergroups by key, then their children, by one stable sort of the
    packed keys (l2="sort") or of the unshifted scores (l2="approx", the
    reference's approx_max_k, exact here). Level 1 folds K4's emitted tier
    `sgmax_pre` of `emit_sg`-wide maxima (`_fold_emitted_sgmax`, in an
    `rdf.sgtier` span) where it is given and divides `sg`, else reduces the
    slab. Otherwise one select over all groups by score."""
    b, ng = packed.shape
    shift = group.bit_length() - 1
    rg = min(refine, ng)
    sg = select_sg if select_sg is not None else _default_select_sg("argpack")
    if _two_level(ng, sg, rg):
        nsg = ng // sg
        p3 = packed.view(b, nsg, sg)
        if sgmax_pre is not None and sg % emit_sg == 0:
            with span("rdf.sgtier"):
                sgmax = _fold_emitted_sgmax(sgmax_pre, p3, n, group, sg, emit_sg)
        else:
            sgmax = p3.amax(dim=2)                                  # [B, NSG]
        sgi = torch.sort(sgmax, dim=1, descending=True, stable=True)[1][:, :rg]
        cg = torch.gather(p3, 1, sgi[:, :, None].expand(b, rg, sg)).reshape(b, rg * sg)
        child = (sgi[:, :, None] * sg + torch.arange(sg, device=packed.device)).reshape(b, rg * sg)
        if l2 == "sort":
            li = torch.sort(cg, dim=1, descending=True, stable=True)[1][:, :rg]
        else:
            li = top_sorted((cg >> shift).to(torch.float32), rg)[1]
        gidx = torch.gather(child, 1, li)
        gpk = torch.gather(cg, 1, li)
    else:
        gidx = top_sorted((packed >> shift).to(torch.float32), rg)[1]
        gpk = torch.gather(packed, 1, gidx)
    cand = (gidx * group + (gpk & (group - 1))).to(torch.int32)
    sel_s = (gpk >> shift).to(torch.float32)
    sel_s = torch.where((gpk > _I32_DEAD) & (cand < n), sel_s, NEG_INF)
    if rg < refine:
        cand = torch.nn.functional.pad(cand, (0, refine - rg))
        sel_s = torch.nn.functional.pad(sel_s, (0, refine - rg), value=NEG_INF)
    return cand, sel_s


def _argpack_candidates(sketch: torch.Tensor, queries: torch.Tensor, refine: int, group: int,
                        select_sg: Optional[int] = None, n_live: Optional[int] = None,
                        l2: str = _ARGPACK_L2, emit_sg: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax-packed grouped preselection: K4 emits each group's packed key
    `score << log2 group | member`, so the top-`refine` groups by key name
    their best rows directly (no window re-score). Any global sketch-top-
    `refine` row that is its group's argmax is captured; only non-argmax
    rows of multiply-hit groups are traded for the next groups' argmaxes.
    K4 also emits the maxima of every `emit_sg` adjacent keys, the select's
    level 1: with `emit_sg` None, at the select's own width where its
    two-level branch will read them (a width K4 takes: a power of two), and
    none elsewhere; 0 asks for none, a width for that width.
    → (cand i32[B, refine] row positions, sel_s f32[B, refine])."""
    if sketch.dtype != torch.int8:
        raise ValueError("argpack needs the int8 sketch")
    nrows, _ = sketch.shape
    n = nrows if n_live is None else n_live
    sk = _pad_rows(sketch, _round_up(nrows, _NPAD_MULTIPLE))
    if emit_sg is None:
        ng = sk.shape[0] // group
        sg = select_sg if select_sg is not None else _default_select_sg("argpack")
        emit_sg = sg if _two_level(ng, sg, min(refine, ng)) and not sg & (sg - 1) else 0
    with span("rdf.score"):
        q_lp = _quantize_queries(queries, sk)
        res = flat_groupmax_kernel(sk, q_lp, group, pack_arg=True, emit_sg=emit_sg)
        packed, sgmax_pre = res if emit_sg else (res, None)
        packed[:, -(-n // group):] = _I32_DEAD    # live groups are a prefix
    with span("rdf.select"):
        return select_packed_rows(packed, group=group, refine=refine, n=n,
                                  select_sg=select_sg, l2=l2, sgmax_pre=sgmax_pre,
                                  emit_sg=emit_sg)


def _grouped_candidates(sketch: torch.Tensor, queries: torch.Tensor, refine: int,
                        r_groups: int, group: int, select_mode: str = "exact2",
                        select_sg: Optional[int] = None, n_live: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped preselection: K4 group maxima → the top `r_groups` groups
    (exact two-level select where NG allows, else one select) → every row
    of those groups re-scored against the bf16 query through K2b's aligned
    64-row windows → the top `refine` rows. → (cand i32[B, refine] row
    positions, sel_s f32[B, refine] sketch scores; -inf = invalid). The
    sketch may arrive row-padded; `n_live` is then its live row count."""
    if select_mode in ("auto", "argpack"):
        select_mode = "exact2"
    nrows, d = sketch.shape
    n = nrows if n_live is None else n_live
    b = queries.shape[0]
    dev = sketch.device
    npad = _round_up(nrows, _NPAD_MULTIPLE)
    sk = _pad_rows(sketch, npad)
    with span("rdf.score"):
        gmax = flat_groupmax_kernel(sk, _quantize_queries(queries, sk), group)  # [B, NG] f32
        gmax[:, -(-n // group):] = NEG_INF    # all-padding groups; live ones are a prefix
    ng = npad // group
    with span("rdf.select"):
        rg = min(r_groups, ng)
        sg = select_sg if select_sg is not None else _default_select_sg(select_mode)
        if select_mode == "exact2" and ng % sg == 0 and ng // sg >= 4 * rg:
            # any top-rg group's supergroup maximum is >= the rg-th best
            # group maximum, and at most rg supergroups can be: the top-rg
            # supergroups hold every top-rg group
            nsg = ng // sg
            g3 = gmax.view(b, nsg, sg)
            sgi = top_sorted(g3.amax(dim=2), rg)[1]                 # [B, RG]
            cg = torch.gather(g3, 1, sgi[:, :, None].expand(b, rg, sg)).reshape(b, rg * sg)
            child = (sgi[:, :, None] * sg + torch.arange(sg, device=dev)).reshape(b, rg * sg)
            gidx = torch.gather(child, 1, top_sorted(cg, rg)[1])
        else:   # "topk" and "approx": both exact here
            gidx = top_sorted(gmax, rg)[1]

        # row-wise re-score of every selected group's rows in 64-row
        # windows; K2b takes the sketch as a one-table tier, every window
        # live, and writes -inf for rows past n itself
        win = min(group, 64)
        wpg = group // win
        blk_start = ((gidx * group)[:, :, None] + (torch.arange(wpg, device=dev) * win)
                     [None, None, :]).reshape(b, rg * wpg)
        blk_start = blk_start.to(torch.int32).contiguous()
        zeros = torch.zeros_like(blk_start)
        q_low = _pad_cols(queries.to(torch.bfloat16), d).contiguous()
        w_scores = coarse_window_scores_kernel(
            sk[None], q_low, zeros, blk_start, zeros, torch.full_like(blk_start, n),
            torch.ones_like(blk_start, dtype=torch.bool), win)      # [B, RG*wpg, win]
        m = rg * group
        pos = (blk_start[:, :, None] + torch.arange(win, device=dev)).reshape(b, m)
        w_scores = w_scores.reshape(b, m)
        sel_s, sel = top_sorted(w_scores, min(refine, m))
        cand = torch.gather(pos, 1, sel).to(torch.int32)
        sel_s = torch.where(cand < n, sel_s, NEG_INF)
        return cand, sel_s


def flat_topk_grouped(sketch: torch.Tensor, corpus: torch.Tensor, row_ids: torch.Tensor,
                      queries: torch.Tensor, query_ids: torch.Tensor, k: int,
                      refine: int = 128, r_groups: int = 32, group: int = _GROUP,
                      exclude_self: bool = True, select_mode: str = "auto",
                      select_sg: Optional[int] = None, argpack_l2: str = _ARGPACK_L2,
                      gmax_emit_sg: Optional[int] = None, n_live: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped flat scan → (ids i32[B, k], scores f32[B, k]): K4 group
    maxima (never the [B, N] scores), then the exact2 or argpack candidate
    stage (`_resolve_select_mode`), then the exact f32 re-score of the top
    `refine` rows. Group-max preselection with r_groups >= 3k cannot drop a
    true top-k row; recall is bound by the sketch, as in `flat_topk`.
    `gmax_emit_sg` is the width of the argpack select's level-1 tier that
    K4 emits (`_argpack_candidates`: None, the select's own where it reads
    one; 0, none); the answers are the same bit for bit at every width.
    Rows from `n_live` on are scanned but never results, as in `flat_topk`."""
    n = row_ids.shape[0]
    mode = _resolve_select_mode(select_mode, sketch.dtype, n, sketch.shape[1])
    if mode == "argpack":
        cand, sel_s = _argpack_candidates(sketch, queries, refine, group, select_sg=select_sg,
                                          n_live=n, l2=argpack_l2, emit_sg=gmax_emit_sg)
    else:
        cand, sel_s = _grouped_candidates(sketch, queries, refine, r_groups, group, mode,
                                          select_sg, n_live=n)
    with span("rdf.rerank"):
        return _exact_refine(corpus, row_ids, queries, cand, torch.isfinite(sel_s), query_ids,
                             k, exclude_self, n_live)


class FlatIndex:
    """Host orchestrator for the quantized-flat engine (same query surface
    as `RDFForest`). Its tensors live on `device` (default: the first CUDA
    card; `device="cpu"` for the CPU). The sketch is stored row-padded to a
    multiple of 8192 (the grouped paths' group numbering), so no query pads
    it again; the exact tier keeps the corpus's own width."""

    def __init__(self, sketch_dtype: str = "int8", refine: int = 128, block: int = 1 << 20,
                 query_batch: int = 1024, mode: str = "grouped", r_groups: int = 24,
                 corpus_dtype: str = "float32", device: Device = None):
        self.sketch_dtype = sketch_dtype
        self.refine = refine
        self.block = block
        self.query_batch = query_batch
        self.mode = mode            # "grouped" (K4) | "scan"
        self.r_groups = r_groups
        self.corpus_dtype = corpus_dtype
        self.device = resolve_device(device)
        self.corpus: Optional[torch.Tensor] = None
        self.sketch: Optional[torch.Tensor] = None
        self.scale = 1.0
        self.row_ids: Optional[torch.Tensor] = None

    def set_state(self, sketch: torch.Tensor, scale: float, corpus: torch.Tensor,
                  row_ids: torch.Tensor) -> "FlatIndex":
        """Adopt a fitted state: sketch [N or Npad, D32], its scale, the exact
        tier [N, D] and the user ids i32[N]."""
        n = row_ids.shape[0]
        self.sketch = _pad_rows(sketch.to(self.device), _round_up(n, _NPAD_MULTIPLE)).contiguous()
        self.scale = scale
        self.corpus = corpus.to(self.device)
        if self.corpus_dtype == "bfloat16":
            self.corpus = self.corpus.to(torch.bfloat16)
        self.row_ids = row_ids.to(self.device, torch.int32)
        return self

    def fit(self, batch: DenseBatch) -> "FlatIndex":
        """batch: vectors.DenseBatch (numpy values or a tensor)."""
        corpus = torch.as_tensor(batch.values, dtype=torch.float32).to(self.device)
        sketch, scale = build_flat_sketch(corpus, self.sketch_dtype)
        ids = torch.as_tensor(batch.ids, dtype=torch.int32)
        return self.set_state(sketch, scale, corpus, ids)

    def query(self, queries, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; an
        unfitted index answers -1 ids and -inf scores."""
        if self.corpus is None:
            print("need to fit the data first")
            return (np.full((len(queries), k), -1, np.int32),
                    np.full((len(queries), k), -np.inf, np.float32))
        with span("rdf.query"):
            ids, scores = self.query_device(queries, k, query_ids, exclude_self)
            with span("rdf.sync.answers"):
                ids = ids.cpu().numpy()
            with span("rdf.sync.answers"):
                scores = scores.cpu().numpy()
        return ids, scores

    def query_device(self, queries, k: int = 10, query_ids=None, exclude_self: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the index's device,
        taken `effective_query_batch` queries at a time, each chunk padded
        to that batch."""
        if self.corpus is None:
            raise RuntimeError("need to fit the data first")
        with span("rdf.sync.upload"):
            q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        nq = q.shape[0]
        qids = None
        if query_ids is not None:
            with span("rdf.sync.upload"):
                qids = torch.as_tensor(query_ids, dtype=torch.int32).to(self.device)
        bsz = effective_query_batch(nq, self.query_batch)
        # no-drop guideline for the group preselection: at least 3k groups
        rg = max(self.r_groups, 3 * k)
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            qc = _pad_rows(q[s0:s1], bsz)
            qi = None if qids is None else torch.nn.functional.pad(qids[s0:s1], (0, bsz - (s1 - s0)))
            with span("rdf.chunk"):
                if self.mode == "grouped":
                    ids, scores = flat_topk_grouped(self.sketch, self.corpus, self.row_ids, qc,
                                                    qi, k, refine=self.refine, r_groups=rg,
                                                    exclude_self=exclude_self)
                else:
                    ids, scores = flat_topk(self.sketch, self.corpus, self.row_ids, qc, qi, k,
                                            refine=self.refine, block=self.block,
                                            exclude_self=exclude_self)
            out_i.append(ids[:s1 - s0])
            out_s.append(scores[:s1 - s0])
        return torch.cat(out_i), torch.cat(out_s)

    def bytes_per_vector(self) -> dict:
        """Device bytes per live vector of the sketch, the exact tier and
        the ids."""
        if self.corpus is None:
            raise RuntimeError("need to fit the data first")
        n = max(1, self.row_ids.shape[0])
        return {name: t.numel() * t.element_size() / n
                for name, t in (("sketch", self.sketch), ("corpus", self.corpus),
                                ("ids", self.row_ids))}


# ---------------------------------------------------------------------------
# Sparse flat engine: densified int8 sketch scan + exact sparse-merge refine
# ---------------------------------------------------------------------------


def build_flat_sketch_sparse(indices: torch.Tensor, values: torch.Tensor, size: int,
                             chunk: int = _DENSIFY_CHUNK, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, float]:
    """(sketch int8[N, ceil(size/32)*32], scale) of a padded-COO corpus: the
    rows densified `chunk` at a time (so the f32 intermediate never exceeds
    chunk x width), times one global scale 127 / max|values| (or the
    `scale` given), rounded half to even and clipped to ±127. 1M x 4096
    dims cost 4.1 GB, affordable where the f32 densification (16 GB) is
    not."""
    n = indices.shape[0]
    width = _round_up(size, _SKETCH_COLS)
    if scale is None:
        scale = sketch_scale(float(values.abs().max()) if values.numel() else 0.0)
    sketch = torch.empty((n, width), dtype=torch.int8, device=values.device)
    for c0 in range(0, n, chunk):
        rows = densify(indices[c0:c0 + chunk], values[c0:c0 + chunk], width)
        sketch[c0:c0 + chunk] = quantize_sketch_rows(rows, scale)
    return sketch, scale


def flat_topk_sparse(sketch: torch.Tensor, corpus_indices: torch.Tensor,
                     corpus_values: torch.Tensor, row_ids: torch.Tensor,
                     q_indices: torch.Tensor, q_values: torch.Tensor,
                     query_ids: Optional[torch.Tensor], k: int, refine: int = 128,
                     r_groups: int = 24, group: int = _GROUP, exclude_self: bool = True,
                     select_mode: str = "auto", n_live: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse flat search → (ids i32[B, k] user ids, scores f32[B, k]; -1
    ids and -inf scores pad): the queries densify to the sketch's width, the
    grouped scan (K4, then exact2's K2b re-score or argpack) preselects
    `refine` rows, and the sort-merge sparse dot re-scores them exactly. The
    sketch may carry padding rows past the n = len(row_ids) live ones. A
    result is present where its score is finite, so any user id, negative
    ones too, can be returned (the JAX package drops ids below 0); with
    `exclude_self`, a query's own id (`query_ids`, None for none) is not.
    Rows from `n_live` on are scanned but never results (a shard's
    padding, whose zero rows score 0)."""
    n = row_ids.shape[0]
    qd = densify(q_indices, q_values, sketch.shape[1])
    mode = _resolve_select_mode(select_mode, sketch.dtype, n, sketch.shape[1])
    if mode == "argpack":
        cand, sel_s = _argpack_candidates(sketch, qd, refine, group, n_live=n)
    else:
        cand, sel_s = _grouped_candidates(sketch, qd, refine, r_groups, group, mode, n_live=n)
    pre = torch.isfinite(sel_s)
    with span("rdf.rerank"):
        exact = sparse_merge_scores(corpus_indices, corpus_values, torch.where(pre, cand, -1),
                                    q_indices, q_values)
        uid = row_ids[cand.clamp(0, n - 1).to(torch.int64)]
        valid = pre & torch.isfinite(exact)
        if n_live is not None:
            valid &= cand < n_live
        if exclude_self and query_ids is not None:
            valid &= uid != query_ids[:, None]
        top_s, ti = top_sorted(torch.where(valid, exact, NEG_INF), k)
        top_u = torch.gather(uid, 1, ti)
        return torch.where(torch.isfinite(top_s), top_u, -1), top_s


class SparseFlatIndex:
    """Host orchestrator for the sparse flat engine (the query surface of
    `SparseRDFForest`; every row is scored, so there are no steps). Its
    tensors live on `device` (default: the first CUDA card; `device="cpu"`
    for the CPU); the sketch is stored row-padded to a multiple of 8192, as
    `FlatIndex`'s is."""

    def __init__(self, refine: int = 128, r_groups: int = 24, query_batch: int = 1024,
                 device: Device = None):
        self.refine = refine
        self.r_groups = r_groups
        self.query_batch = query_batch
        self.device = resolve_device(device)
        self.sketch: Optional[torch.Tensor] = None
        self.scale = 1.0
        self.size = 0
        self.c_idx = self.c_val = self.row_ids = None

    def set_state(self, sketch: torch.Tensor, scale: float, c_idx: torch.Tensor,
                  c_val: torch.Tensor, row_ids: torch.Tensor, size: int) -> "SparseFlatIndex":
        """Adopt a fitted state: the sketch [N or Npad, ceil(size/32)*32], its
        scale, the sparse exact tier i32/f32[N, NNZ], the user ids i32[N]."""
        n = row_ids.shape[0]
        self.sketch = _pad_rows(sketch.to(self.device), _round_up(n, _NPAD_MULTIPLE)).contiguous()
        self.scale = scale
        self.c_idx = c_idx.to(self.device, torch.int32).contiguous()
        self.c_val = c_val.to(self.device, torch.float32).contiguous()
        self.row_ids = row_ids.to(self.device, torch.int32)
        self.size = int(size)
        return self

    def fit(self, batch: SparseBatch) -> "SparseFlatIndex":
        """batch: vectors.SparseBatch (numpy rows or tensors)."""
        check_sparse_size_for_merge(int(batch.size))
        c_idx = torch.as_tensor(batch.indices).to(self.device, torch.int32)
        c_val = torch.as_tensor(batch.values).to(self.device, torch.float32)
        sketch, scale = build_flat_sketch_sparse(c_idx, c_val, int(batch.size))
        return self.set_state(sketch, scale, c_idx, c_val,
                              torch.as_tensor(np.asarray(batch.ids, dtype=np.int32)),
                              batch.size)

    def query(self, q_indices, q_values, k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query → (ids [Q, k], scores [Q, k]) as numpy arrays; an
        unfitted index prints the reference's message and answers -1 ids and
        -inf scores."""
        if self.sketch is None:
            print("need to fit the data first")
            return (np.full((len(q_indices), k), -1, np.int32),
                    np.full((len(q_indices), k), -np.inf, np.float32))
        ids, scores = self.query_device(q_indices, q_values, k, query_ids, exclude_self)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def query_device(self, q_indices, q_values, k: int = 10, query_ids=None,
                     exclude_self: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """`query` without the host transfer: tensors on the index's device,
        `effective_query_batch` queries at a time, each chunk padded to that
        batch."""
        if self.sketch is None:
            raise RuntimeError("need to fit the data first")
        qi = torch.as_tensor(q_indices).to(self.device, torch.int32)
        qv = torch.as_tensor(q_values).to(self.device, torch.float32)
        nq = qi.shape[0]
        qids = (None if query_ids is None else
                torch.as_tensor(np.asarray(query_ids), dtype=torch.int32).to(self.device))
        bsz = effective_query_batch(nq, self.query_batch)
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            pad = bsz - (s1 - s0)
            ids, scores = flat_topk_sparse(
                self.sketch, self.c_idx, self.c_val, self.row_ids, _pad_rows(qi[s0:s1], bsz),
                _pad_rows(qv[s0:s1], bsz),
                None if qids is None else torch.nn.functional.pad(qids[s0:s1], (0, pad)), k,
                refine=self.refine, r_groups=self.groups_kept(k), exclude_self=exclude_self)
            out_i.append(ids[:s1 - s0])
            out_s.append(scores[:s1 - s0])
        return torch.cat(out_i), torch.cat(out_s)

    def groups_kept(self, k: int) -> int:
        """The groups a query of `k` results keeps from the scan:
        max(r_groups, 3k), as the JAX package's `SparseFlatIndex` sets it."""
        return max(self.r_groups, 3 * k)

    def bytes_per_vector(self) -> dict:
        """Device bytes per live vector of the sketch, the sparse exact tier
        and the ids."""
        if self.sketch is None:
            raise RuntimeError("need to fit the data first")
        n = max(1, self.row_ids.shape[0])
        return {name: t.numel() * t.element_size() / n
                for name, t in (("sketch", self.sketch), ("indices", self.c_idx),
                                ("values", self.c_val), ("ids", self.row_ids))}
