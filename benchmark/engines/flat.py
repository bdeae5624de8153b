"""The port's quantized-flat engine (`FlatIndex`) as the system under test.

`build` makes the index from the configuration's `index` (the
constructor's keywords); `fit` and `query` are the IVF engine's
(`engines/ivf_flat.py`): ids are row numbers, host queries in, ids and
scores on the host out. The reference is `benchmark/reference/flat.py`.
"""

from __future__ import annotations

from benchmark.engines.ivf_flat import fit, query  # noqa: F401
from benchmark.reference import flat as reference  # noqa: F401  (the engine's reference)

REF_BATCH = 1024     # queries the reference answers at once


def build(cfg: dict, device):
    from similaritysearchbyrdf_tpu_torch import FlatIndex

    return FlatIndex(**cfg["index"], device=device)
