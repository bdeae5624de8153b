"""The measured window: one client in a closed loop.

Call i sends the traffic's `queries_per_call` consecutive queries of the
pool of held-out queries (in the order the seed gives them) from position
i * queries_per_call, wrapping round, and waits for its answer (ids and
scores on the host) before the next call. A call's time runs from the
call to its answer. Calls start until `seconds` have passed since the
first; the window ends when the last returns, so its length covers all
the work done in it.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np


def pool_slice(pos: int, size: int, pool: int) -> np.ndarray:
    return (pos + np.arange(size)) % pool


def run(call: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]], queries: np.ndarray,
        per_call: int, k: int, seconds: float, start: int = 0) -> dict:
    """→ {"latencies_s": [per call, inf where it failed], "qidx" i64[A],
    "ids" [A, k], "scores" [A, k] (answered queries), "attempted",
    "failed", "answered", "window_s", "next": pool position after the
    window}."""
    pool = queries.shape[0]
    lat, qidx, ids, scores = [], [], [], []
    attempted = failed = 0
    pos = start
    t_first = time.perf_counter()
    t_end = t_first
    while time.perf_counter() - t_first < seconds:
        idx = pool_slice(pos, per_call, pool)
        q = queries[idx]
        pos += per_call
        attempted += per_call
        t0 = time.perf_counter()
        try:
            got_i, got_s = call(q)
            ok = (np.shape(got_i) == (per_call, k) and np.shape(got_s) == (per_call, k))
        except Exception as exc:             # an answer that never comes
            got_i = got_s = None
            ok = False
            err = exc
        t_end = time.perf_counter()
        if not ok:
            failed += per_call
            lat.append(float("inf"))
            if failed == per_call:           # say why once
                import sys
                print(f"window: a call failed: {err if got_i is None else 'wrong shape'}",
                      file=sys.stderr)
            continue
        lat.append(t_end - t0)
        qidx.append(idx)
        ids.append(np.asarray(got_i))
        scores.append(np.asarray(got_s))
    cat = (lambda parts, shape, dt: np.concatenate(parts) if parts
           else np.zeros(shape, dt))
    return {"latencies_s": lat, "qidx": cat(qidx, (0,), np.int64),
            "ids": cat(ids, (0, k), np.int64), "scores": cat(scores, (0, k), np.float32),
            "attempted": attempted, "failed": failed,
            "answered": attempted - failed, "window_s": t_end - t_first, "next": pos}
