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
"""

from __future__ import annotations

from typing import Tuple

import torch

from .precision import matmul_f32

NEG_INF = float("-inf")
_SENTINEL = 2**31 - 1


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
    what the reference's top_k and its sorts on the CPU give."""
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :m], idx[:, :m]


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
