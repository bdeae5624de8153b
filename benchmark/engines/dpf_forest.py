"""The port's Dynamic Partition Forest (`RDFForest`) as the system under test.

`build` makes the forest from the configuration's `index` (an `RDFConfig`),
`fit` fits it on the corpus (ids are row numbers), `query` is the served
call: host queries in, ids and scores on the host out, with the
configuration's `query` keywords. The reference is
`benchmark/reference/forest.py`.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import forest as reference  # noqa: F401  (the engine's reference)

REF_BATCH = 128      # queries the reference answers at once


def build(cfg: dict, device):
    from similaritysearchbyrdf_tpu_torch import RDFConfig, RDFForest, TableConfig

    ix = dict(cfg["index"])
    ix["lsh_table"] = TableConfig(**ix["lsh_table"])
    return RDFForest(RDFConfig(**ix), device=device)


def fit(engine, corpus) -> None:
    from similaritysearchbyrdf_tpu_torch import DenseBatch

    engine.fit(DenseBatch(np.arange(corpus.shape[0], dtype=np.int32), corpus))


def query(engine, cfg: dict, queries: np.ndarray):
    return engine.query(queries, k=cfg["k"], **cfg["query"])
