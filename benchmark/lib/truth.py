"""Exact ground truth and recall, in plain torch.

The arithmetic of the port's `experiments/harness.py` (`exact_ground_truth`,
`recall_at_k`), rewritten here: the corpus is streamed in row chunks with a
running top-k of full-f32 inner products (TF32 off), and recall counts, over
every answer, the returned ids that are among the true top-k.
"""

from __future__ import annotations

import torch

GT_CHUNK = 1 << 17     # corpus rows scored at once: [Q, chunk] f32 scores


def f32_matmuls() -> None:
    """Full f32 for every float32 product of this process (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
               chunk: int = GT_CHUNK) -> torch.Tensor:
    """Row indices int64[Q, k] of each query's k largest inner products."""
    f32_matmuls()
    q = queries.to(torch.float32)
    best_s = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for c0 in range(0, corpus.shape[0], chunk):
        s = q @ corpus[c0:c0 + chunk].to(torch.float32).T
        top_s, top_i = torch.topk(s, min(k, s.shape[1]), dim=1)
        cat_s = torch.cat([best_s, top_s], 1)
        cat_i = torch.cat([best_i, top_i + c0], 1)
        best_s, j = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, j)
    return best_i


def recall(ids: torch.Tensor, gt: torch.Tensor) -> float:
    """Share of the true top-k ids, over all answers, that the answers hold:
    ids int[A, k'] returned (-1 none), gt int[A, k]."""
    if gt.numel() == 0:
        return float("nan")
    hits = (ids.to(torch.int64)[:, :, None] == gt.to(torch.int64)[:, None, :]).any(dim=1)
    return float(hits.sum()) / gt.numel()
