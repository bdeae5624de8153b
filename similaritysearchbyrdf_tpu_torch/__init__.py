"""similaritysearchbyrdf_tpu_torch — the Dynamic Partition Forest on PyTorch.

The port of `similaritysearchbyrdf_tpu` (JAX + Pallas on a TPU, kept as the
reference) to PyTorch and hand-written CUDA kernels for an NVIDIA H100. It
never imports jax. It covers the dense forest (fit with the K1 hash kernel,
bucket tables and a coarse tier; query in block mode with K2, window
mode with K2b, or the folded tier with K3; int8 or bf16 coarse tiers on a
random or PCA basis, and the bf16 two-stage rerank), the dense flat engine
(`FlatIndex`, `flat_topk`, `flat_topk_grouped` with the K4 group-max
kernel) and the clustered-flat IVF engine (`IVFFlatIndex`, k-means and K2b
window scores). Entry points run on the first CUDA card unless given
`device="cpu"`. The CUDA kernels are built on first use, never at import.
"""

from .config import RDFConfig, TableConfig
from .index.forest import ForestState, RDFForest, fit_dense, query_dense_many
from .interop import from_jax_flat, from_jax_ivf, from_jax_state
from .ops.flat import FlatIndex, flat_topk, flat_topk_grouped
from .ops.ivf import IVFFlatIndex, tune_nprobe
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
    "from_jax_flat",
    "from_jax_ivf",
    "FlatIndex",
    "flat_topk",
    "flat_topk_grouped",
    "IVFFlatIndex",
    "tune_nprobe",
]
