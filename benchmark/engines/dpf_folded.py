"""The port's Dynamic Partition Forest (`RDFForest`) on its folded tier as
the system under test.

The forest engine's `build`, `fit` and `query` (`engines/dpf_forest.py`):
the folded options come from the configuration's `index`. The reference
is `benchmark/reference/forest_folded.py`.
"""

from __future__ import annotations

from benchmark.engines.dpf_forest import REF_BATCH, build, fit, query  # noqa: F401
from benchmark.reference import forest_folded as reference  # noqa: F401  (the engine's reference)
