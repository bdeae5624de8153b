"""Exact (brute-force) inner-product search: the ground truth.

Counterpart of `similaritysearchbyrdf_tpu/ops/exact.py`: the corpus is
streamed in chunks with a running top-k, so peak memory is chunk x B scores.
A full-f32 `torch.matmul` (TF32 off for the product, `ops/precision.py`)
and a stable top-k. `exact_topk_sparse` is the same over a padded-COO
corpus, the sparse path's ground truth.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.families import Device, resolve_device
from .precision import full_f32
from .rerank import top_sorted


def _streamed_topk(scores_of, n: int, b: int, k: int, chunk: int, dev,
                   exclude_diag_offset: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running stable top-k over corpus rows [c0, c0 + chunk) at a time,
    `scores_of(c0, c1)` giving their f32[B, c1 - c0] scores: ties keep the
    lower row id, as `lax.top_k` over [best, chunk] does. → (ids int64[B,
    k], scores f32[B, k])."""
    best_s = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    qidx = torch.arange(b, device=dev)[:, None]
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        scores = scores_of(c0, c1)
        ids = torch.arange(c0, c1, device=dev)[None, :]
        if exclude_diag_offset is not None:
            scores = torch.where(ids == qidx + exclude_diag_offset, float("-inf"), scores)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_s, ti = top_sorted(cat_s, k)
        best_i = torch.gather(cat_i, 1, ti)
    return best_i, best_s


def exact_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
               chunk: int = 65536, exclude_diag_offset: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int64[B, k], scores f32[B, k]). `exclude_diag_offset=j` masks
    corpus row j+i for query i (queries that are corpus rows from j on)."""
    q = queries.to(corpus.dtype)

    def scores_of(c0, c1):
        with full_f32():
            return (q @ corpus[c0:c1].T).to(torch.float32)          # [B, chunk]

    return _streamed_topk(scores_of, corpus.shape[0], queries.shape[0], k, chunk,
                          corpus.device, exclude_diag_offset)


def exact_topk_sparse(corpus_indices: torch.Tensor, corpus_values: torch.Tensor,
                      query_dense: torch.Tensor, k: int, chunk: int = 4096,
                      exclude_diag_offset: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact top-k over a sparse corpus i32/f32[N, NNZ] (padding
    values 0) for densified queries f32[B, D] → (ids int64[B, k], scores
    f32[B, k]): per chunk of rows, the queries' values at each row's
    indices times the row's values, summed over its non-zeros in full f32.
    `exclude_diag_offset=j` masks corpus row j+i for query i."""
    def scores_of(c0, c1):
        qg = query_dense[:, corpus_indices[c0:c1].to(torch.int64)]   # [B, chunk, NNZ]
        with full_f32():
            return torch.einsum("bcn,cn->bc", qg, corpus_values[c0:c1].to(torch.float32))

    return _streamed_topk(scores_of, corpus_indices.shape[0], query_dense.shape[0], k, chunk,
                          query_dense.device, exclude_diag_offset)


def exact_search(corpus, queries, k: int, batch: int = 1024,
                 exclude_self: bool = False, device: Device = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing exact search over query batches; corpus and queries are
    numpy arrays or tensors, searched on `device` (default: a tensor
    corpus's own device, else the first CUDA card)."""
    if device is None and isinstance(corpus, torch.Tensor):
        device = corpus.device
    device = resolve_device(device)
    corpus_d = torch.as_tensor(corpus, dtype=torch.float32, device=device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    out_i, out_s = [], []
    for s0 in range(0, len(q), batch):
        ids, scores = exact_topk(corpus_d, q[s0:s0 + batch], k,
                                 exclude_diag_offset=s0 if exclude_self else None)
        out_i.append(ids.cpu().numpy())
        out_s.append(scores.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_s)
