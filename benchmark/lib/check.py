"""The comparison that decides `correct`.

A sample of the answers the window produced, drawn from the seed, is
compared with the plain reference's answers to the same queries (the
reference builds its own index from the same corpus after the program's
state is freed). Two numbers, each with its limit from the configuration
(`check_limits`), and the failed answers:

  missing_share  share of the reference's top-k ids, over the sample, that
                 the program's answer lacks (a candidate set, a select or
                 a rerank that differs shows here);
  score_err      the largest gap, over every id the program returned,
                 between its score and the exact inner product of the
                 query and that row in float64 (a score computed in a lower
                 precision, or paired with the wrong id, shows here; an id
                 outside the corpus, or a -1 with a finite score, reads
                 inf);
  failed         answers that never came (a call that raised or returned
                 the wrong shape): limit 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sample(n_answers: int, size: int, seed: int) -> np.ndarray:
    """Indices of the answers to check: `size` of them (all where fewer),
    drawn without replacement from the seed, ascending."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    if n_answers <= size:
        return np.arange(n_answers)
    return np.sort(rng.choice(n_answers, size=size, replace=False))


def missing_share(ids: torch.Tensor, ref_ids: torch.Tensor) -> float:
    ref = ref_ids.to(torch.int64)
    want = ref >= 0
    have = (ids.to(torch.int64)[:, None, :] == ref[:, :, None]).any(dim=2)
    n = int(want.sum())
    return float((want & ~have).sum()) / n if n else 0.0


def score_err(ids: torch.Tensor, scores: torch.Tensor, corpus: torch.Tensor,
              queries: torch.Tensor) -> float:
    """Largest |score - exact f64 inner product| over the returned ids."""
    ids = ids.to(torch.int64)
    scores = scores.to(torch.float64)
    n = corpus.shape[0]
    ok = (ids >= 0) & (ids < n)
    bad = ((ids >= n) | (ids < -1)).any() | ((ids == -1) & torch.isfinite(scores)).any()
    if bool(bad) or bool(~torch.isfinite(scores[ok]).all()):
        return float("inf")
    rows = corpus[ids.clamp(0, n - 1)].to(torch.float64)
    exact = (rows * queries.to(torch.float64)[:, None, :]).sum(-1)
    gap = torch.where(ok, (scores - exact).abs(), 0.0)
    return float(gap.max()) if gap.numel() else 0.0


def numbers(ids, scores, ref_ids, corpus, queries) -> Dict[str, float]:
    """The compared numbers of a sample: the program's ids and scores [S, k],
    the reference's ids [S, k], the corpus and the S queries."""
    return {"missing_share": missing_share(ids, ref_ids),
            "score_err": score_err(ids, scores, corpus, queries)}


def judged(values: Dict[str, float], limits: Dict[str, float], failed: int) -> dict:
    """{name: {"value", "limit"}} with the failed answers first; correct
    when every value is at most its limit."""
    out = {"failed_answers": {"value": failed, "limit": 0}}
    for name, v in values.items():
        out[name] = {"value": v, "limit": limits[name]}
    return out


def correct(table: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in table.values())
