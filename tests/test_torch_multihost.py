"""Multi-process sharded engines of the port: two `torch.distributed` ranks
over gloo on the CPU, four shards each, every rank supplying only its half
of the rows (`fit_sharded_distributed`, `fit_flat_sharded_distributed`,
`fit_sparse_flat_sharded_distributed`, `fit_ivf_sharded_distributed`).

As in `test_multihost.py`, the 8-shard answers must be the one-process
8-shard fit's: every engine's ids equal the port's one-process result and
the JAX package's 8-device result (IVF at full probe with a refine covering
every row, where its answer is exact; at nprobe 2 the port's two ranks
equal its one process bit for bit, centroids included, because both draw
the same initial rows and add integer sums). Both ranks must return the
same merged lists, and the forest's live count spans both.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import sys
import numpy as np
import torch

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.modules["jax"] = None          # the port runs without jax

from similaritysearchbyrdf_tpu_torch.parallel.mesh import init_distributed, make_forest_mesh
init_distributed(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
init_distributed(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")

from similaritysearchbyrdf_tpu_torch import DenseBatch, SparseBatch
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI
sys.path.insert(0, "tests")
from test_torch_multihost import conf, corpus, sparse_corpus

mesh = make_forest_mesh(devices=["cpu"] * 4)
assert mesh.n_shards == 8 and mesh.first_shard == 4 * rank and mesh.process_count == 2
x, ids = corpus()
lo, hi = rank * 512, (rank + 1) * 512
local = DenseBatch(ids[lo:hi], x[lo:hi])
q, qids = torch.as_tensor(x[:32]), torch.as_tensor(ids[:32])
res = {}

tc = conf()
layout = KeyLayout.from_config(tc, tc.lsh_table)
st, _ = SF.fit_sharded_distributed(tc, local, mesh)
fn = SF.make_query_fn(mesh, layout, steps=1, m_cap=512, k=5)
res["ids"], res["sc"], res["total"] = (t.numpy() for t in fn(st, q, qids))
forest = SF.ShardedRDFForest(tc, mesh)
forest.state = st
res["size"] = np.asarray([forest.size()])
cst, _ = SF.fit_sharded_distributed(conf(coarse_dim=16, coarse_refine=64), local, mesh)
cfn = SF.make_query_fn(mesh, layout, steps=0, m_cap=512, k=5, coarse_refine=64)
res["cids"] = cfn(cst, q, qids)[0].numpy()

fst, _ = SFL.fit_flat_sharded_distributed(x[lo:hi], ids[lo:hi], mesh)
res["fids"] = SFL.make_flat_query_fn(mesh, k=5, refine=32, block=64)(fst, q, qids)[0].numpy()
res["gids"] = SFL.make_flat_query_fn(mesh, k=5, mode="grouped")(fst, q, qids)[0].numpy()

sb = sparse_corpus()
half = SparseBatch(sb.ids[rank * 256:(rank + 1) * 256], sb.size,
                   sb.indices[rank * 256:(rank + 1) * 256],
                   sb.values[rank * 256:(rank + 1) * 256], sb.lengths[rank * 256:(rank + 1) * 256])
sst, _ = SFL.fit_sparse_flat_sharded_distributed(half, mesh)
res["sfids"] = SFL.make_sparse_flat_query_fn(mesh, k=5, refine=32)(
    sst, torch.as_tensor(sb.indices[:16]), torch.as_tensor(sb.values[:16]),
    torch.arange(16, dtype=torch.int32))[0].numpy()

ist, _ = SI.fit_ivf_sharded_distributed(x[lo:hi], ids[lo:hi], mesh, target_cluster=32, iters=3)
kc = int(ist.centroids.shape[0])
res["iids"] = SI.make_ivf_query_fn(mesh, k=5, nprobe=kc, win=8, refine=512)(ist, q, qids)[0].numpy()
wb = SI.ivf_window_budget_sharded(ist, 2, 8, mesh=mesh)
res["iids2"] = SI.make_ivf_query_fn(mesh, k=5, nprobe=2, win=8, wb=wb)(ist, q, qids)[0].numpy()
res["centroids"] = ist.centroids.float().numpy()
np.savez(f"{out}.{rank}.npz", **res)
print("WORKER", rank, "OK", flush=True)
"""


def conf(**kw):
    from similaritysearchbyrdf_tpu_torch.config import RDFConfig, TableConfig

    base = dict(vector_dim=16, table_num=3, permutation_num=1, family_size=20, partition_bits=2,
                lsh_table=TableConfig(chain_length=12, bucket_overflow=16), query_batch_size=16,
                max_candidates=512, top_k=5, seed=77)
    base.update(kw)
    return RDFConfig(**base)


def corpus():
    """`test_multihost.py`'s corpus, with ids drawn from a 100M id space."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16))
    x = centers[rng.integers(0, 16, 1024)] + 0.1 * rng.normal(size=(1024, 16))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    ids = np.sort(np.random.default_rng(5).choice(100_000_000, 1024, replace=False))
    return x, ids.astype(np.int32)


def sparse_corpus():
    from similaritysearchbyrdf_tpu_torch.vectors import SparseBatch

    srng = np.random.default_rng(9)
    n_sp, dim_sp, nnz = 512, 128, 6
    sidx = np.stack([srng.choice(dim_sp, size=nnz, replace=False)
                     for _ in range(n_sp)]).astype(np.int32)
    sval = (1.0 + 0.1 * srng.normal(size=(n_sp, nnz))).astype(np.float32)
    return SparseBatch(np.arange(n_sp, dtype=np.int32), dim_sp, sidx, sval,
                       np.full(n_sp, nnz, np.int32))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh") / "res")
    port = str(_free_port())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, out], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(f"{out}.{r}.npz")) for r in (0, 1)]


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process 8-shard fits of the same rows."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch
    from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh

    mesh = make_forest_mesh(devices=["cpu"] * 8)
    x, ids = corpus()
    batch = DenseBatch(ids, x)
    q, qids = torch.as_tensor(x[:32]), torch.as_tensor(ids[:32])
    tc = conf()
    layout = KeyLayout.from_config(tc, tc.lsh_table)
    res = {}
    st, _ = SF.fit_sharded(tc, batch, mesh)
    res["ids"], res["sc"], res["total"] = (
        t.numpy() for t in SF.make_query_fn(mesh, layout, steps=1, m_cap=512, k=5)(st, q, qids))
    cst, _ = SF.fit_sharded(conf(coarse_dim=16, coarse_refine=64), batch, mesh)
    res["cids"] = SF.make_query_fn(mesh, layout, steps=0, m_cap=512, k=5,
                                   coarse_refine=64)(cst, q, qids)[0].numpy()
    fst, _ = SFL.fit_flat_sharded(x, ids, mesh)
    res["fids"] = SFL.make_flat_query_fn(mesh, k=5, refine=32, block=64)(fst, q, qids)[0].numpy()
    res["gids"] = SFL.make_flat_query_fn(mesh, k=5, mode="grouped")(fst, q, qids)[0].numpy()
    sb = sparse_corpus()
    sst, _ = SFL.fit_sparse_flat_sharded(sb, mesh)
    res["sfids"] = SFL.make_sparse_flat_query_fn(mesh, k=5, refine=32)(
        sst, torch.as_tensor(sb.indices[:16]), torch.as_tensor(sb.values[:16]),
        torch.arange(16, dtype=torch.int32))[0].numpy()
    ist, _ = SI.fit_ivf_sharded(x, ids, mesh, target_cluster=32, iters=3)
    kc = int(ist.centroids.shape[0])
    res["iids"] = SI.make_ivf_query_fn(mesh, k=5, nprobe=kc, win=8, refine=512)(
        ist, q, qids)[0].numpy()
    wb = SI.ivf_window_budget_sharded(ist, 2, 8)
    res["iids2"] = SI.make_ivf_query_fn(mesh, k=5, nprobe=2, win=8, wb=wb)(
        ist, q, qids)[0].numpy()
    res["centroids"] = ist.centroids.float().numpy()
    return res


@pytest.fixture(scope="module")
def jax_8_devices():
    """The JAX package's one-process 8-device fits of the same rows."""
    import jax.numpy as jnp

    import similaritysearchbyrdf_tpu.config as jcfg
    from similaritysearchbyrdf_tpu.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu.parallel import sharded_flat as JFL
    from similaritysearchbyrdf_tpu.parallel import sharded_forest as JF
    from similaritysearchbyrdf_tpu.parallel import sharded_ivf as JI
    from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh
    from similaritysearchbyrdf_tpu.vectors import DenseBatch, SparseBatch

    def jconf(**kw):
        base = dict(vector_dim=16, table_num=3, permutation_num=1, family_size=20,
                    partition_bits=2, lsh_table=jcfg.TableConfig(chain_length=12,
                                                                 bucket_overflow=16),
                    query_batch_size=16, max_candidates=512, top_k=5, seed=77)
        base.update(kw)
        return jcfg.RDFConfig(**base)

    mesh = make_forest_mesh(8)
    x, ids = corpus()
    batch = DenseBatch(ids, x)
    q, qids = jnp.asarray(x[:32]), jnp.asarray(ids[:32])
    layout = KeyLayout.from_config(jconf(), jconf().lsh_table)
    res = {}
    st, _ = JF.fit_sharded(jconf(), batch, mesh)
    res["ids"] = np.asarray(JF.make_query_fn(mesh, layout, steps=1, m_cap=512, k=5)(
        st, q, qids)[0])
    cst, _ = JF.fit_sharded(jconf(coarse_dim=16, coarse_refine=64), batch, mesh)
    res["cids"] = np.asarray(JF.make_query_fn(mesh, layout, steps=0, m_cap=512, k=5,
                                              has_coarse=True, coarse_refine=64)(
        cst, q, qids)[0])
    fst, _ = JFL.fit_flat_sharded(x, ids, mesh)
    res["fids"] = np.asarray(JFL.make_flat_query_fn(mesh, k=5, refine=32, block=64)(
        fst, q, qids)[0])
    sb = sparse_corpus()
    jsb = SparseBatch(ids=sb.ids, size=sb.size, indices=sb.indices, values=sb.values,
                      lengths=sb.lengths)
    sst, _ = JFL.fit_sparse_flat_sharded(jsb, mesh)
    res["sfids"] = np.asarray(JFL.make_sparse_flat_query_fn(mesh, k=5, refine=32)(
        sst, jnp.asarray(sb.indices[:16]), jnp.asarray(sb.values[:16]),
        jnp.arange(16, dtype=jnp.int32))[0])
    ist, _ = JI.fit_ivf_sharded(x, ids, mesh, target_cluster=32, iters=3)
    kc = int(ist.centroids.shape[0])
    res["iids"] = np.asarray(JI.make_ivf_query_fn(mesh, k=5, nprobe=kc, win=8, refine=512)(
        ist, q, qids)[0])
    return res


@pytest.mark.parametrize("name", ["ids", "cids", "fids", "gids", "sfids", "iids", "iids2"])
def test_two_ranks_equal_one_process(ranks, one_process, name):
    """Both ranks return the one-process 8-shard fit's ids, bit for bit."""
    for r in ranks:
        np.testing.assert_array_equal(r[name], one_process[name])


@pytest.mark.parametrize("name", ["ids", "cids", "fids", "sfids", "iids"])
def test_two_ranks_equal_jax_8_devices(ranks, jax_8_devices, name):
    np.testing.assert_array_equal(ranks[0][name], jax_8_devices[name])


def test_two_ranks_merge_scores_totals_and_size(ranks, one_process):
    """The merged scores and the candidate totals summed over both ranks'
    shards equal the one-process fit's; the live count spans both ranks;
    the IVF centroids are the one-process fit's, bit for bit."""
    for r in ranks:
        np.testing.assert_array_equal(r["sc"], one_process["sc"])
        np.testing.assert_array_equal(r["total"], one_process["total"])
        np.testing.assert_array_equal(r["centroids"], one_process["centroids"])
        assert int(r["size"][0]) == 1024
    assert (ranks[0]["total"] > 0).all()
    x, ids = corpus()
    assert ids.max() > 10_000_000 and set(ranks[0]["ids"].ravel()) <= set(ids) | {-1}
