"""Port vs JAX package on the sharded sparse forest: one padded-COO corpus
fitted by the JAX package on its 8 virtual CPU devices and by the port on
`make_forest_mesh(devices=["cpu"] * n)`, 8 and 4 shards. Each shard's
tables are equal bit for bit, so the classic sparse path (no multi-probe,
the sort-merge rerank) must give equal ids on every query, equal summed
candidate totals, and scores within D * 2^-22; the JAX state carried over
by `interop.from_jax_sharded_state` answers alike."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index.bucket_table import KeyLayout as JLayout
from similaritysearchbyrdf_tpu.parallel import sharded_forest as JSF
from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh as jax_mesh
from similaritysearchbyrdf_tpu.vectors import SparseBatch as JSparse
from similaritysearchbyrdf_tpu_torch import SparseBatch
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.interop import from_jax_sharded_state
from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as TSF

from test_torch_sharded import _conf, _jax_arrays, _mesh, _same


def _sparse(n=800, dim=128, nnz=12, seed=11):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(dim, size=nnz, replace=False) for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return idx, val


@pytest.mark.parametrize("shards,steps", [(8, 1), (8, 0), (4, 1)])
def test_sparse_matches_jax(shards, steps):
    idx, val = _sparse()
    n, nq = len(idx), 32
    ids = np.arange(n, dtype=np.int32)
    lengths = np.full(n, idx.shape[1], np.int32)
    jc, tc = _conf(jcfg, vector_dim=128), _conf(tcfg, vector_dim=128)
    jstate, jm = JSF.fit_sparse_sharded(jc, JSparse(ids=ids, size=128, indices=idx, values=val,
                                                    lengths=lengths), jax_mesh(shards))
    tstate, tm = TSF.fit_sparse_sharded(tc, SparseBatch(ids, 128, idx, val, lengths),
                                        _mesh(shards))
    for s, st in enumerate(tstate.shards):
        np.testing.assert_array_equal(st.tables.sorted_ids.numpy(),
                                      np.asarray(jstate.sorted_ids)[s])
    jfn = JSF.make_sparse_query_fn(jm, JLayout.from_config(jc, jc.lsh_table), dim=128,
                                   steps=steps, m_cap=jc.max_candidates, k=10)
    tfn = TSF.make_sparse_query_fn(tm, KeyLayout.from_config(tc, tc.lsh_table), dim=128,
                                   steps=steps, m_cap=tc.max_candidates, k=10)
    ji, js, jt = (np.asarray(a) for a in jfn(jstate, idx[:nq], val[:nq],
                                             np.arange(nq, dtype=np.int32)))
    ti, ts, tt = (a.numpy() for a in tfn(tstate, torch.as_tensor(idx[:nq]),
                                         torch.as_tensor(val[:nq]),
                                         torch.arange(nq, dtype=torch.int32), chunk=8))
    _same(ji, js, ti, ts, True)
    np.testing.assert_array_equal(tt, jt)
    # the sparse state carried over from the JAX package answers alike
    port = from_jax_sharded_state(_jax_arrays(jstate), tc, tm)
    pi, _, _ = tfn(port, torch.as_tensor(idx[:nq]), torch.as_tensor(val[:nq]),
                   torch.arange(nq, dtype=torch.int32))
    np.testing.assert_array_equal(pi.numpy(), ji)
