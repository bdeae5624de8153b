"""similaritysearchbyrdf_tpu_torch — the Dynamic Partition Forest on PyTorch.

The port of `similaritysearchbyrdf_tpu` (JAX + Pallas on a TPU, kept as the
reference) to PyTorch and hand-written CUDA kernels for an NVIDIA H100. It
never imports jax. It covers the dense forest (fit with the K1 hash kernel,
bucket tables and a coarse tier; query in block mode with K2, window
mode with K2b, or the folded tier with K3; int8 or bf16 coarse tiers on a
random or PCA basis, and the bf16 two-stage rerank), the dense flat engine
(`FlatIndex`, `flat_topk`, `flat_topk_grouped` with the K4 group-max
kernel), the clustered-flat IVF engine (`IVFFlatIndex`, k-means and K2b
window scores), the dense front ends (`DenseRDFInit`, `MultiFeatureRDFInit`,
the `RDFMap` map surface), the mutable index (`DynamicForest`,
`RDFForest.add`), hash-model and partition files, tracing spans (the
query paths' `rdf.*` stages and host waits, recorded while any
`torch.profiler` session records, or inside `utils.timing.torch_profile`;
names in `utils.timing`), the experiment harness (`experiments.harness`), persistence (`save_forest` /
`load_forest`, `save_flat` / `load_flat`, `save_ivf` / `load_ivf`, writing
the JAX package's files; the tiered `GenerationStore` and `TieredForest`),
the CLI (`cli`), the dataset generators (`utils.datasets`), the native
host parser (`native`), and the sparse path: the sparse forest
(`SparseRDFForest`: sparse hashing through K1, the sort-merge rerank), the
sparse flat engine (`SparseFlatIndex`, `flat_topk_sparse`) and the sparse
front end (`SparseRDFInit`), and distribution (`parallel`: the sharded
forest, dense and sparse, the sharded flat, sparse flat and IVF engines on
a `ForestMesh` of shards, one process or several over `torch.distributed`,
and their save/load). Entry points run on the first CUDA card unless
given `device="cpu"` (a mesh: `devices=["cpu"] * n`). The CUDA kernels and the native parser are built on
first use, never at import.
"""

from .config import PStableConfig, RDFConfig, TableConfig, from_hocon_dict, from_hocon_file
from .deploy.dense import DenseRDFInit
from .deploy.map_api import RDFMap
from .deploy.multi_feature import MultiFeatureRDFInit
from .deploy.sparse import SparseRDFInit
from .index.bucket_table import BucketTables, KeyLayout
from .index.dynamic import DynamicForest
from .index.forest import ForestState, RDFForest, fit_dense, query_dense, query_dense_many
from .index.sparse_forest import SparseRDFForest
from .interop import from_jax_flat, from_jax_ivf, from_jax_state
from .models.families import HashModel, generate_model, load_model_file, save_model_file
from .ops.exact import exact_search
from .ops.flat import (FlatIndex, SparseFlatIndex, build_flat_sketch, flat_topk,
                       flat_topk_grouped, flat_topk_sparse)
from .ops.ivf import IVFFlatIndex, tune_nprobe
from .storage.persist import (GenerationStore, TieredForest, load_flat, load_forest,
                              load_ivf, load_sharded_flat, load_sharded_ivf, save_flat,
                              save_forest, save_ivf, save_sharded_flat, save_sharded_ivf)
from .vectors import (DenseBatch, SparseBatch, load_dense_file, load_ground_truth,
                      load_sparse_file, sparse_batch_from_rows)

__version__ = "0.1.0"

__all__ = [
    "RDFConfig",
    "TableConfig",
    "PStableConfig",
    "from_hocon_dict",
    "from_hocon_file",
    "DenseBatch",
    "SparseBatch",
    "load_dense_file",
    "load_sparse_file",
    "load_ground_truth",
    "sparse_batch_from_rows",
    "HashModel",
    "generate_model",
    "save_model_file",
    "load_model_file",
    "ForestState",
    "RDFForest",
    "SparseRDFForest",
    "fit_dense",
    "query_dense",
    "query_dense_many",
    "KeyLayout",
    "BucketTables",
    "exact_search",
    "DynamicForest",
    "DenseRDFInit",
    "MultiFeatureRDFInit",
    "SparseRDFInit",
    "RDFMap",
    "from_jax_state",
    "from_jax_flat",
    "from_jax_ivf",
    "FlatIndex",
    "flat_topk",
    "flat_topk_grouped",
    "build_flat_sketch",
    "SparseFlatIndex",
    "flat_topk_sparse",
    "IVFFlatIndex",
    "tune_nprobe",
    "save_forest",
    "load_forest",
    "save_flat",
    "load_flat",
    "save_ivf",
    "load_ivf",
    "save_sharded_flat",
    "load_sharded_flat",
    "save_sharded_ivf",
    "load_sharded_ivf",
    "TieredForest",
    "GenerationStore",
]


def sharded_forest(*args, **kwargs):
    """Lazy accessor for :class:`parallel.sharded_forest.ShardedRDFForest`
    (the JAX package's `sharded_forest()`), imported on demand."""
    from .parallel.sharded_forest import ShardedRDFForest

    return ShardedRDFForest(*args, **kwargs)
