"""The port's IVF-Flat engine (`IVFFlatIndex`) as the system under test.

`build` makes the index from the configuration's `index` (the
constructor's keywords), `fit` builds it on the corpus (ids are row
numbers), `query` is the served call: host queries in, ids and scores on
the host out. The reference is `benchmark/reference/ivf.py`.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import ivf as reference  # noqa: F401  (the engine's reference)

REF_BATCH = 1024     # queries the reference answers at once


def build(cfg: dict, device):
    from similaritysearchbyrdf_tpu_torch import IVFFlatIndex

    return IVFFlatIndex(**cfg["index"], device=device)


def fit(engine, corpus) -> None:
    from similaritysearchbyrdf_tpu_torch import DenseBatch

    engine.fit(DenseBatch(np.arange(corpus.shape[0], dtype=np.int32), corpus))


def query(engine, cfg: dict, queries: np.ndarray):
    return engine.query(queries, k=cfg["k"], **cfg["query"])
