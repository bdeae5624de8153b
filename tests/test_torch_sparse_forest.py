"""Port vs JAX package on a small sparse forest: the fit's arrays, then
queries on one identical index (`interop.sparse_from_jax_state`) in block
mode, window mode, the classic path without a coarse tier, steps 0 and 1,
with and without self-exclusion and under a similarity threshold.

The corpus is `scripts/bench_sparse_1m.py`'s recipe at a small size:
support-clustered rows (every row of a cluster shares its indices), values
0.8 + 0.2·U normalised. What differs between the packages on one index is
only float summation order, so top-k ids must be equal on >= 99% of
queries and recall@10 within 0.005, as `test_torch_forest.py` states it;
every other query must be equal up to near-ties (`equal_up_to_ties`,
1e-6): two rows whose scores differ in the last bits can swap.
The coarse tier's int8 entries are each a sum of NNZ products rounded once,
in another order in each package: at most 0.1% may differ, by 1."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import sparse_forest as jsf
from similaritysearchbyrdf_tpu.vectors import SparseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import SparseBatch as TBatch
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.index import sparse_forest as tsf
from similaritysearchbyrdf_tpu_torch.interop import sparse_from_jax_state, unpack_lane_tier
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_topk_sparse
from similaritysearchbyrdf_tpu_torch.ops.hashing import densify

N, D, NNZ, NQ, K = 3000, 512, 16, 128, 10


def confs(coarse: bool = True, **kw):
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=4096, top_k=K,
                seed=31, feature_data_format="sparse", is_orthogonal=False)
    if coarse:
        base.update(coarse_dim=64, coarse_dtype="int8", coarse_refine=256)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=48)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=48)))


def corpus():
    rng = np.random.default_rng(3)
    supports = np.stack([rng.choice(D, size=NNZ, replace=False) for _ in range(150)])
    idx = supports[rng.integers(0, 150, N)].astype(np.int32)
    val = (0.8 + 0.2 * rng.random((N, NNZ))).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return idx, val


def batches(idx, val):
    ids, lengths = np.arange(len(idx), dtype=np.int32), np.full(len(idx), NNZ, np.int32)
    return JBatch(ids, D, idx, val, lengths), TBatch(ids, D, idx, val, lengths)


def jax_state_arrays(state):
    """A JAX SparseForestState's fields as numpy arrays, keyed for
    sparse_from_jax_state."""
    t = state.tables
    out = {"model.proj": state.model.proj, "model.perm": state.model.perm,
           "model.b": state.model.b, "model.sampling_perm": state.model.sampling_perm,
           "part_proj": state.part_proj, "tables.sorted_keys": t.sorted_keys,
           "tables.sorted_ids": t.sorted_ids, "tables.bucket_keys": t.bucket_keys,
           "tables.bucket_starts": t.bucket_starts, "tables.bucket_shifts": t.bucket_shifts,
           "corpus_indices": state.corpus_indices, "corpus_values": state.corpus_values,
           "row_ids": state.row_ids}
    if state.coarse_by_table is not None:
        out.update({"coarse_proj": state.coarse_proj, "coarse_by_table": state.coarse_by_table})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def world():
    idx, val = corpus()
    jb, tb = batches(idx, val)
    qd = densify(torch.from_numpy(idx[:NQ]), torch.from_numpy(val[:NQ]), D)
    gt, _ = exact_topk_sparse(torch.from_numpy(idx), torch.from_numpy(val), qd, K,
                              exclude_diag_offset=0)
    out = {"idx": idx, "val": val, "jb": jb, "tb": tb, "gt": gt.numpy()}
    for coarse in (True, False):
        jc, tc = confs(coarse)
        jf = jsf.SparseRDFForest(jc).fit(jb)
        tf = tsf.SparseRDFForest(tc, device="cpu").fit(tb)
        out[coarse] = (jc, tc, jf, tf)
    return out


def recall(gt, got):
    return sum(len(set(gt[i].tolist()) & set(int(v) for v in got[i] if v >= 0))
               for i in range(len(gt))) / gt.size


@pytest.mark.parametrize("coarse", [True, False])
def test_fit_matches_jax(world, coarse):
    jc, tc, jf, tf = world[coarse]
    js, ts = jf.state, tf.state
    for name in ("sorted_keys", "bucket_keys"):
        np.testing.assert_array_equal(from_key(getattr(ts.tables, name)).numpy(),
                                      np.asarray(getattr(js.tables, name)))
    for name in ("sorted_ids", "bucket_starts", "bucket_shifts"):
        np.testing.assert_array_equal(getattr(ts.tables, name).numpy(),
                                      np.asarray(getattr(js.tables, name)))
    np.testing.assert_array_equal(ts.row_ids.numpy(), np.asarray(js.row_ids))
    np.testing.assert_array_equal(ts.corpus_indices.numpy(), np.asarray(js.corpus_indices))
    np.testing.assert_array_equal(ts.corpus_values.numpy(), np.asarray(js.corpus_values))
    assert tf.size() == jf.size() == N
    np.testing.assert_array_equal(tf.sub_index_distribution(), jf.sub_index_distribution())
    if coarse:
        np.testing.assert_array_equal(ts.coarse_proj.numpy(), np.asarray(js.coarse_proj))
        assert ts.coarse_proj.shape == (D, 64)
        want = unpack_lane_tier(np.asarray(js.coarse_by_table), ts.tables.num_tables, 64)
        assert np.asarray(js.coarse_by_table).shape[2] == 128       # 2 tables a lane row
        diff = np.abs(ts.coarse_tier.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        assert ts.coarse_tier is None and js.coarse_by_table is None


def test_sub_index_distribution_unflips_keys(world):
    """The sub-index is read from the unsigned key: with 3 partition bits,
    the flipped int32 key's sign would fold partitions 4-7 onto 0-3."""
    _, _, jf, tf = world[True]
    dist = tf.sub_index_distribution()
    assert dist[:, 4:].sum() > 0
    np.testing.assert_array_equal(dist.sum(axis=1), N)


def test_fit_from_tensor_rows(world):
    """Rows given as tensors (rows already on the device) fit the same
    forest as numpy rows."""
    _, tc, _, tf = world[True]
    ids = np.arange(N, dtype=np.int32)
    tb = TBatch(ids, D, torch.from_numpy(world["idx"]), torch.from_numpy(world["val"]),
                np.full(N, NNZ))
    st = tsf.fit_sparse(tc, tb, model=tf.model, part_proj=tf.part_proj)
    assert st.device.type == "cpu"
    for name in ("sorted_keys", "sorted_ids", "bucket_keys", "bucket_starts"):
        assert torch.equal(getattr(st.tables, name), getattr(tf.state.tables, name))
    assert torch.equal(st.coarse_tier, tf.state.coarse_tier)


def _port_on_jax_index(world, coarse, **conf_kw):
    jc, tc, jf, _ = world[coarse]
    jc, tc = jc.replace(**conf_kw), tc.replace(**conf_kw)
    jq = jsf.SparseRDFForest(jc, model=jf.model)
    jq.state, jq.dim = jf.state, D
    tq = tsf.SparseRDFForest(tc, device="cpu")
    tq.state, tq.dim = sparse_from_jax_state(jax_state_arrays(jf.state), tc, "cpu"), D
    return jq, tq


MODES = {
    "block": (True, {}, 0),
    "block_steps1": (True, {}, 1),
    "window": (True, dict(max_candidates=32768, coarse_refine=512), 0),
    "classic": (False, {}, 0),
    "classic_steps1": (False, {}, 1),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("exclude", [True, False])
def test_queries_match_jax(world, mode, exclude):
    coarse, kw, steps = MODES[mode]
    jq, tq = _port_on_jax_index(world, coarse, **kw)
    jb, tb = world["jb"].slice(0, NQ), world["tb"].slice(0, NQ)
    qids = np.arange(NQ) if exclude else None
    j_ids, j_sc = jq.query(jb, steps=steps, query_ids=qids)
    t_ids, t_sc = tq.query(tb, steps=steps, query_ids=qids)
    assert t_ids.shape == (NQ, K) and t_ids.dtype == np.int32
    assert (t_ids == j_ids).all(axis=1).mean() >= 0.99
    assert all(equal_up_to_ties(t_ids[i], t_sc[i], j_ids[i], j_sc[i], 1e-6)
               for i in range(NQ))
    fin = np.isfinite(j_sc)
    np.testing.assert_array_equal(np.isfinite(t_sc), fin)
    np.testing.assert_allclose(t_sc[fin], j_sc[fin], rtol=1e-5)
    if exclude:
        assert not (t_ids == np.arange(NQ)[:, None]).any()
        assert abs(recall(world["gt"], t_ids) - recall(world["gt"], j_ids)) <= 0.005
    else:
        assert (t_ids[:, 0] == np.arange(NQ)).mean() > 0.9     # a row finds itself first


def test_window_mode_runs_windows(world, monkeypatch):
    """m_cap 32768 takes 64-slot windows (K2b's plain version), as the dense
    rule does; m_cap 4096 block mode (K2's)."""
    from similaritysearchbyrdf_tpu_torch.index import forest as tforest

    seen = []
    real = tforest.gather_blocks

    def spy(*a, **kw):
        seen.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(tsf, "gather_blocks", spy)
    for m_cap in (4096, 32768):
        _, tq = _port_on_jax_index(world, True, max_candidates=m_cap)
        tq.query(world["tb"].slice(0, 8))
    assert seen == [0, 64]


def test_similarity_threshold_matches_jax(world):
    base_j, base_t = _port_on_jax_index(world, True)
    jb, tb = world["jb"].slice(0, NQ), world["tb"].slice(0, NQ)
    _, sc0 = base_t.query(tb, query_ids=np.arange(NQ))
    thr = float(np.median(sc0[np.isfinite(sc0)]))
    jq, tq = _port_on_jax_index(world, True, similarity_threshold=thr)
    j_ids, j_sc = jq.query(jb, query_ids=np.arange(NQ))
    t_ids, t_sc = tq.query(tb, query_ids=np.arange(NQ))
    assert (t_ids == j_ids).all(axis=1).mean() >= 0.99
    assert (t_sc[t_ids < 0] == -np.inf).all() and (t_sc[t_ids >= 0] >= thr).all()
    assert (t_ids < 0).any() and (t_ids >= 0).any()


def test_query_before_fit():
    _, tc = confs()
    with pytest.raises(RuntimeError, match="fit the data first"):
        tsf.SparseRDFForest(tc, device="cpu").query(TBatch([0], D, [[1]], [[1.0]], [1]))
