"""similaritysearchbyrdf_tpu_torch — the Dynamic Partition Forest on PyTorch.

The port of `similaritysearchbyrdf_tpu` (JAX + Pallas on a TPU, kept as the
reference) to PyTorch and hand-written CUDA kernels for an NVIDIA H100. It
never imports jax. This slice covers the dense forest's main path in block
mode: fit (K1 hash kernel, bucket tables, int8 coarse tier) and query
(margin or reference probes, bucket lookup, K2 coarse gather-score kernel,
exact rerank). The CUDA kernels are built on first use, never at import.
"""

from .config import RDFConfig, TableConfig
from .index.forest import ForestState, RDFForest, fit_dense, query_dense_many
from .interop import from_jax_state
from .vectors import DenseBatch

__version__ = "0.1.0"

__all__ = [
    "RDFConfig",
    "TableConfig",
    "DenseBatch",
    "ForestState",
    "RDFForest",
    "fit_dense",
    "query_dense_many",
    "from_jax_state",
]
