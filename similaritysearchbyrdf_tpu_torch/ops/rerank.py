"""Exact top-k re-ranking of candidate sets.

Counterpart of `similaritysearchbyrdf_tpu/ops/rerank.py` (the reference's
`argsort(dataMatrix * queryVec)` re-rank, `DensevectorRDFInit.scala:487-490`):
gather, dot, select, narrow dedup, top-k, with inner-product scores, and
its two-stage form over a bf16 copy of the corpus. Every selection is a
stable sort, so ties fall as on the reference's CPU sorts (input order
first). Scores are full f32, whatever the caller's TF32 setting
(`ops/precision.py`).

A bf16 score is the JAX package's bf16 x bf16 product with f32 output
(`preferred_element_type=float32`), computed by `precision.matmul_f32`:
exact products, so only the summation order differs from the reference.

The sparse re-ranks score a padded-COO corpus (`vectors.SparseBatch`
rows): `rerank_sparse` gathers a densified query at each candidate's
indices, `rerank_sparse_merge` (the one the sparse forest uses) sorts both
sides' (index, value) pairs together and multiplies adjacent matches.
Both compute the true sparse dot, not the reference's positional zip
(`SimilarityCalculator.scala:40-49`), which pairs the i-th non-zero of one
vector with the i-th of the other whatever their indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels.topk_select import topk_select_f32
from .precision import matmul_f32

NEG_INF = float("-inf")
_SENTINEL = 2**31 - 1

# Largest sparse feature-space size the sort-merge re-rank takes: keys pack
# as index*2 (+1 on the query side) in int32 beside the pad keys 2**31-2 and
# 2**31-1, so every real index must keep index*2+1 < 2**31-2.
MAX_MERGE_FEATURE_SIZE = 2**30 - 1
_MERGE_PAD = 2**31 - 2


def check_sparse_size_for_merge(size: int) -> None:
    """Refuse (at fit time) a feature space whose indices could reach the
    sort-merge's pad keys."""
    if size > MAX_MERGE_FEATURE_SIZE:
        raise ValueError(f"sparse feature-space size {size} exceeds the sort-merge "
                         f"re-rank limit {MAX_MERGE_FEATURE_SIZE} (int32 key packing)")


def score_candidates(corpus: torch.Tensor, cand: torch.Tensor, queries: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Masked inner-product scores f32[B, M] of candidate rows (-1 = -inf):
    rows and queries rounded to `compute_dtype` (f32 or bf16), then their
    products and sums in full f32."""
    valid = cand >= 0
    vecs = corpus[cand.clamp(min=0).to(torch.int64)]                      # [B, M, D]
    scores = matmul_f32(vecs, queries[:, :, None], compute_dtype)[..., 0]
    return torch.where(valid, scores, NEG_INF)


def top_sorted(scores: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-m scores descending, their indices) with ties in index order —
    what the reference's top_k and its sorts on the CPU give. On the card
    one launch of the top-k kernel's f32 form returns that prefix bit for
    bit (`ops/kernels/topk_select.topk_select_f32`); on the CPU, the stable
    sort's."""
    return topk_select_f32(scores, m)


def dedup_topk(cand: torch.Tensor, scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (id, score) pairs with duplicate ids collapsed: copies of
    one id carry equal scores, so keeping any one is exact."""
    key = torch.where(cand >= 0, cand, _SENTINEL)
    ids_s, order = torch.sort(key, dim=1, stable=True)
    sc_s = torch.gather(scores, 1, order)
    dup = torch.cat([torch.zeros_like(ids_s[:, :1], dtype=torch.bool),
                     ids_s[:, 1:] == ids_s[:, :-1]], dim=1)
    sc_s = torch.where(dup | (ids_s == _SENTINEL), NEG_INF, sc_s)
    top_scores, ti = top_sorted(sc_s, k)
    top_ids = torch.gather(ids_s, 1, ti)
    return torch.where(top_scores > NEG_INF, top_ids, -1), top_scores


def _dedup_width(m: int, k: int, dup_bound: int) -> int:
    """Each id appears at most `dup_bound` times (once per table after
    bucket-range dedup), so the unique top-k lies within the top
    (k+1)*dup_bound scored slots."""
    return min(m, (k + 1) * max(1, dup_bound))


def _select_top(scores: torch.Tensor, cand: torch.Tensor, m2: int):
    """(top-m2 scores, their candidate ids)."""
    s2, idx = top_sorted(scores, m2)
    return s2, torch.gather(cand, 1, idx)


def rerank_dense(corpus: torch.Tensor, cand: torch.Tensor, queries: torch.Tensor,
                 k: int, dup_bound: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids i32[B, k] with -1 padding, scores f32[B, k]): the whole buffer is
    scored once, only the top slice is dedup-sorted."""
    scores = score_candidates(corpus, cand, queries)
    s2, c2 = _select_top(scores, cand, _dedup_width(cand.shape[1], k, dup_bound))
    return dedup_topk(c2, s2, k)


def rerank_dense_two_stage(corpus_lp: torch.Tensor, corpus: torch.Tensor, cand: torch.Tensor,
                           queries: torch.Tensor, k: int, dup_bound: int = 1,
                           refine: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage rerank → (ids i32[B, k], scores f32[B, k]): bf16 scores of
    every candidate from the bf16 copy `corpus_lp` (half the gathered
    bytes), then the exact f32 re-score and dedup of the best max(dedup
    width, min(refine, M)). Exact while the true unique top-k lies within
    that slice (bf16 keeps about 0.4% relative error)."""
    m2 = max(_dedup_width(cand.shape[1], k, dup_bound), min(refine, cand.shape[1]))
    coarse = score_candidates(corpus_lp, cand, queries, torch.bfloat16)
    _, c2 = _select_top(coarse, cand, m2)
    return dedup_topk(c2, score_candidates(corpus, c2, queries), k)


def _gather_rows(corpus_indices: torch.Tensor, corpus_values: torch.Tensor,
                 cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidates' (indices, values) rows, [B, M, NNZ] each."""
    safe = cand.clamp(min=0).to(torch.int64)
    return corpus_indices[safe], corpus_values[safe]


def rerank_sparse(corpus_indices: torch.Tensor, corpus_values: torch.Tensor,
                  cand: torch.Tensor, query_dense: torch.Tensor, k: int,
                  dup_bound: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse-corpus re-rank over densified queries f32[B, D] → (ids i32[B,
    k] row positions with -1 padding, scores f32[B, k]): each candidate's
    value times the query's value at its index, summed over its non-zeros."""
    c_idx, c_val = _gather_rows(corpus_indices, corpus_values, cand)       # [B, M, NNZ]
    b, m, nnz = c_idx.shape
    q_gather = torch.gather(query_dense[:, None, :].expand(b, m, -1), 2, c_idx.to(torch.int64))
    scores = torch.where(cand >= 0, (c_val * q_gather).sum(dim=-1), NEG_INF)
    s2, c2 = _select_top(scores, cand, _dedup_width(m, k, dup_bound))
    return dedup_topk(c2, s2, k)


def sparse_merge_scores(corpus_indices: torch.Tensor, corpus_values: torch.Tensor,
                        cand: torch.Tensor, q_indices: torch.Tensor,
                        q_values: torch.Tensor) -> torch.Tensor:
    """Exact sparse·sparse scores f32[B, M] (-inf for cand -1) by sort-merge.
    Per candidate, the corpus keys idx*2 and the query keys idx*2+1 sort
    together (zero values, padding included, go to the pad keys 2**31-2 and
    2**31-1); an index on both sides becomes an adjacent (corpus, query)
    pair whose keys agree after `>> 1`, and the dot sums those pairs'
    products. Indices are unique within a row, as the reference's
    `SparseVector` keeps them (`Vector.scala:374-417`); callers bound the
    feature space with `check_sparse_size_for_merge`."""
    c_idx, c_val = _gather_rows(corpus_indices, corpus_values, cand)       # [B, M, NNZ]
    b, m, _ = c_idx.shape
    nnzq = q_indices.shape[1]
    kc = torch.where(c_val != 0.0, c_idx.to(torch.int32) * 2, _MERGE_PAD)
    kq = torch.where(q_values != 0.0, q_indices.to(torch.int32) * 2 + 1, _MERGE_PAD + 1)
    keys = torch.cat([kc, kq[:, None, :].expand(b, m, nnzq)], dim=-1)    # [B, M, NNZ+NNZq]
    vals = torch.cat([c_val, q_values[:, None, :].to(c_val.dtype).expand(b, m, nnzq)], dim=-1)
    keys_s, order = torch.sort(keys, dim=-1, stable=True)
    vals_s = torch.gather(vals, -1, order)
    is_c = (keys_s & 1) == 0
    match = ((keys_s[..., 1:] >> 1) == (keys_s[..., :-1] >> 1)) & is_c[..., :-1] & ~is_c[..., 1:]
    scores = torch.where(match, vals_s[..., 1:] * vals_s[..., :-1], 0.0).sum(dim=-1)
    return torch.where(cand >= 0, scores, NEG_INF)


def rerank_sparse_merge(corpus_indices: torch.Tensor, corpus_values: torch.Tensor,
                        cand: torch.Tensor, q_indices: torch.Tensor, q_values: torch.Tensor,
                        k: int, dup_bound: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse·sparse re-rank by sort-merge (`sparse_merge_scores`) → (ids
    i32[B, k] row positions with -1 padding, scores f32[B, k]); only the top
    (k+1)*dup_bound slots are dedup-sorted."""
    scores = sparse_merge_scores(corpus_indices, corpus_values, cand, q_indices, q_values)
    s2, c2 = _select_top(scores, cand, _dedup_width(cand.shape[1], k, dup_bound))
    return dedup_topk(c2, s2, k)


def dedup_sorted(cand: torch.Tensor, sentinel: int = _SENTINEL) -> torch.Tensor:
    """Candidate ids sorted per row, duplicates and invalid entries -1 (the
    reference unions per-table lists into a Set,
    `DensevectorRDFInit.scala:426-429`). No query path uses it."""
    x, _ = torch.sort(torch.where(cand >= 0, cand, sentinel), dim=-1)
    dup = torch.cat([torch.zeros_like(x[..., :1], dtype=torch.bool),
                     x[..., 1:] == x[..., :-1]], dim=-1)
    return torch.where((x == sentinel) | dup, -1, x)
