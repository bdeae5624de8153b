"""The PyTorch port stands alone: no jax, no JAX package, no build at import."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "similaritysearchbyrdf_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "similaritysearchbyrdf_tpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'similaritysearchbyrdf_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import similaritysearchbyrdf_tpu_torch as p\n"
        "import similaritysearchbyrdf_tpu_torch.interop\n"
        "import similaritysearchbyrdf_tpu_torch.ops.exact\n"
        "import similaritysearchbyrdf_tpu_torch.ops.flat\n"
        "import similaritysearchbyrdf_tpu_torch.ops.ivf\n"
        "import similaritysearchbyrdf_tpu_torch.deploy.dense\n"
        "import similaritysearchbyrdf_tpu_torch.deploy.map_api\n"
        "import similaritysearchbyrdf_tpu_torch.deploy.multi_feature\n"
        "import similaritysearchbyrdf_tpu_torch.deploy.server\n"
        "import similaritysearchbyrdf_tpu_torch.deploy.sparse\n"
        "import similaritysearchbyrdf_tpu_torch.index.sparse_forest\n"
        "import similaritysearchbyrdf_tpu_torch.experiments.harness\n"
        "import similaritysearchbyrdf_tpu_torch.index.dynamic\n"
        "import similaritysearchbyrdf_tpu_torch.utils.timing\n"
        "import similaritysearchbyrdf_tpu_torch.utils.datasets\n"
        "import similaritysearchbyrdf_tpu_torch.storage.persist\n"
        "import similaritysearchbyrdf_tpu_torch.storage.serializers\n"
        "import similaritysearchbyrdf_tpu_torch.storage.crypto\n"
        "import similaritysearchbyrdf_tpu_torch.storage.bloom\n"
        "import similaritysearchbyrdf_tpu_torch.cli\n"
        "import similaritysearchbyrdf_tpu_torch.parallel.mesh\n"
        "import similaritysearchbyrdf_tpu_torch.parallel.sharded_forest\n"
        "import similaritysearchbyrdf_tpu_torch.parallel.sharded_flat\n"
        "import similaritysearchbyrdf_tpu_torch.parallel.sharded_ivf\n"
        "assert callable(p.sharded_forest)\n"
        "from similaritysearchbyrdf_tpu_torch.native import loader\n"
        "from similaritysearchbyrdf_tpu_torch.ops.kernels import build\n"
        "assert build._lib is None, 'kernels were built at import'\n"
        "assert loader._lib is None and not loader.built, 'the native library was built at import'\n"
        "assert 'triton' not in sys.modules\n"
        "print(','.join(sorted(p.__all__)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(out.stdout.strip().split(",")) == {
        "RDFConfig", "TableConfig", "DenseBatch", "ForestState", "RDFForest",
        "fit_dense", "query_dense_many", "from_jax_state", "from_jax_flat", "from_jax_ivf",
        "FlatIndex", "flat_topk", "flat_topk_grouped", "IVFFlatIndex", "tune_nprobe",
        "DenseRDFInit", "MultiFeatureRDFInit", "HashModel", "generate_model",
        "save_model_file", "load_model_file", "query_dense", "KeyLayout", "BucketTables",
        "exact_search", "load_dense_file", "load_ground_truth", "from_hocon_dict",
        "from_hocon_file", "RDFMap", "DynamicForest", "PStableConfig", "build_flat_sketch",
        "save_forest", "load_forest", "save_flat", "load_flat", "save_ivf", "load_ivf",
        "TieredForest", "GenerationStore", "SparseBatch", "load_sparse_file",
        "sparse_batch_from_rows", "SparseRDFForest", "SparseFlatIndex", "flat_topk_sparse",
        "SparseRDFInit", "save_sharded_flat", "load_sharded_flat", "save_sharded_ivf",
        "load_sharded_ivf"}


def test_kernel_sources_are_package_data():
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = conf["tool"]["setuptools"]["package-data"]["similaritysearchbyrdf_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "coarse_fold.cu", "coarse_gather.cu", "flat_groupmax.cu", "hash_kernel.cu",
        "topk_select.cu"]


def test_native_sources_are_package_data():
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = conf["tool"]["setuptools"]["package-data"]["similaritysearchbyrdf_tpu_torch"]
    assert "native/*.cc" in data
    assert sorted(p.name for p in (PORT / "native").glob("*.cc")) == [
        "rdf_codec.cc", "rdf_loader.cc"]
    # the reference's package keeps its own Makefile build; the port builds
    # with its loader, outside the package
    assert not list((PORT / "native").glob("*.so"))
