"""Port vs JAX package on the sparse front end (`SparseRDFInit`): a fit
from a written sparse file, key queries (unknown and repeated keys),
vector queries, precision scoring and the distributions, each against the
JAX front end on one identical index (`interop.sparse_from_jax_state`).

A repeated id resolves as in the reference: `query_single_key` takes its
first row, `query_batch` its last. Ids must be equal on >= 99% of queries
and every query equal up to near-ties (1e-6), as in
`test_torch_sparse_forest.py`. The ids include negative ones: the JAX front
end takes those for the -1 padding and drops them from its key-query
lists, precision and dataTable distribution; the port keeps them, and the
tests state both."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.deploy.sparse import SparseRDFInit as JInit
from similaritysearchbyrdf_tpu_torch import SparseRDFInit
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.interop import sparse_from_jax_state
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key

from test_torch_sparse_forest import jax_state_arrays

N, D, NNZ, K = 1200, 256, 12, 10
REPEATED = 7          # row 900 carries id 7 again


def confs():
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=4096, top_k=K,
                seed=41, feature_data_format="sparse", is_orthogonal=False, coarse_dim=32,
                coarse_dtype="int8", coarse_refine=256, num_data_partitions=3,
                sparse_nnz_pad=NNZ)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=40)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=40)))


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """Both front ends fitted from one sparse file in the reference's text
    format (ids: row numbers, negative for every fifth row, one repeated);
    the port's then queries the JAX front end's index."""
    rng = np.random.default_rng(9)
    supports = [rng.choice(D, size=NNZ, replace=False) for _ in range(60)]
    ids = np.where(np.arange(N) % 5 == 4, -np.arange(N), np.arange(N))
    ids[900] = REPEATED
    lines = []
    for i in range(N):
        idx = np.sort(supports[rng.integers(0, 60)])
        val = 0.8 + 0.2 * rng.random(NNZ)
        lines.append(f"({ids[i]},{D},[{','.join(map(str, idx))}],"
                     f"[{','.join(repr(float(v)) for v in val / np.linalg.norm(val))}])")
    path = tmp_path_factory.mktemp("sparse") / "vectors.txt"
    path.write_text("\n".join(lines))
    jc, tc = confs()
    jf, tf = JInit(), SparseRDFInit(device="cpu")
    jf.initialize_rdf_hash_map(jc)
    tf.initializeRDFHashMap(tc)
    jb, tb = jf.new_fast_fit(str(path)), tf.newFastFit(str(path))
    fitted = tf.forest.state
    # from here on, the port queries the JAX front end's index
    tf.forest.state = sparse_from_jax_state(jax_state_arrays(jf.forest.state), tc, "cpu")
    return jf, tf, jb, tb, tc, fitted


def test_fit_from_file_matches_jax(fronts):
    jf, _, jb, tb, _, ts = fronts
    np.testing.assert_array_equal(tb.ids, jb.ids)
    np.testing.assert_array_equal(tb.indices, jb.indices)
    np.testing.assert_array_equal(tb.values, jb.values)
    js = jf.forest.state
    np.testing.assert_array_equal(from_key(ts.tables.sorted_keys).numpy(),
                                  np.asarray(js.tables.sorted_keys))
    np.testing.assert_array_equal(ts.tables.sorted_ids.numpy(), np.asarray(js.tables.sorted_ids))


def _listed(jf, jb, row, key, steps=0):
    """What a key query of `row` (id `key`) should list: the JAX front
    end's forest result, every id with a finite score."""
    ids, sc = jf.forest.query(jb.slice(row, row + 1), steps=steps, query_ids=[key])
    return [int(i) for i, s in zip(ids[0], sc[0]) if np.isfinite(s)]


def test_key_queries_match_jax(fronts):
    jf, tf, jb, _, _, _ = fronts
    keys = [0, 1, REPEATED, 123456, 8, -4, REPEATED, 77777, 898]
    row_of = {0: 0, 1: 1, REPEATED: 900, 8: 8, -4: 4, 898: 898}      # the last row of an id
    for steps in (0, 1):
        want = [_listed(jf, jb, row_of[k], k, steps) if k in row_of else [] for k in keys]
        assert tf.query_batch(keys, steps=steps) == want
        # the JAX front end drops negative ids from its lists (not copied)
        assert jf.query_batch(keys, steps=steps) == [[i for i in w if i >= 0] for w in want]
        assert tf.queryBatch(keys, steps=steps) == want
    for key, first_row in ((0, 0), (REPEATED, REPEATED), (-4, 4)):
        want = _listed(jf, jb, first_row, key)
        assert tf.query_single_key(key) == tf.querySingleKey(key) == want
        assert jf.query_single_key(key) == [i for i in want if i >= 0]
    assert tf.query_single_key(123456) is None and jf.query_single_key(123456) is None
    assert tf.query_batch([123456, 654321]) == [[], []]
    # a repeated id: the first row for one key, the last for a batch
    assert _listed(jf, jb, REPEATED, REPEATED) != _listed(jf, jb, 900, REPEATED)
    assert any(i < 0 for w in tf.query_batch(keys) for i in w)


def test_vector_queries_and_precision_match_jax(fronts):
    jf, tf, jb, tb, tc, _ = fronts
    q = 200
    t_ids, t_sc = tf.new_multi_thread_query_batch(tb.ids[:q], tb.slice(0, q), steps=1)
    j_ids, j_sc = jf.new_multi_thread_query_batch(jb.ids[:q], jb.slice(0, q), steps=1)
    j_ids, j_sc = np.asarray(j_ids), np.asarray(j_sc)
    assert (t_ids == j_ids).all(axis=1).mean() >= 0.99
    assert all(equal_up_to_ties(t_ids[i], t_sc[i], j_ids[i], j_sc[i], 1e-6) for i in range(q))
    gt = [set(int(x) for x, s in zip(j_ids[i], j_sc[i]) if np.isfinite(s)) for i in range(50)]
    ti, tp, tms = tf.topKAndPrecisionScore(tb, gt, tc, steps=1)
    _, jp, _ = jf.top_k_and_precision_score(jb, gt, steps=1)
    assert ti.shape == (50, K) and tms > 0
    # the JAX front end counts no negative id as found (not copied)
    negatives = sum(sum(1 for x in g if x < 0) for g in gt) / (50 * K)
    assert tp >= 0.98 and abs(jp - (tp - negatives)) <= 0.02 and negatives > 0


def test_distributions_match_jax(fronts):
    jf, tf, jb, _, _, _ = fronts
    dt, ht = tf.get_dt_and_ht_num_distribution()
    jdt, jht = jf.get_dt_and_ht_num_distribution()
    np.testing.assert_allclose(ht, jht)
    assert dt.shape == (3,) and dt.sum() == N and ht.sum() == N
    np.testing.assert_array_equal(dt, np.bincount(np.abs(jb.ids) % 3, minlength=3))
    # the JAX front end leaves out the rows of negative ids (not copied)
    np.testing.assert_array_equal(jdt, np.bincount(np.abs(jb.ids[jb.ids >= 0]) % 3, minlength=3))
    assert tf.forest.size() == N
    dt2, _ = tf.getDtAndHtNumDistribution()
    np.testing.assert_array_equal(dt, dt2)


def test_unfitted_and_cleared(capsys):
    _, tc = confs()
    front = SparseRDFInit(device="cpu")
    with pytest.raises(RuntimeError):
        front.query_single_key(0)
    front.initialize_rdf_hash_map(tc)
    assert front.query_single_key(0) is None
    assert front.query_batch([1, 2]) == [[], []]
    assert "need to fit the data first" in capsys.readouterr().out
    front.clearAndClose()
    assert front.forest is None


def test_entry_points_refuse_without_cuda(monkeypatch):
    """With no device named and no CUDA, every sparse entry point raises
    rather than run on the CPU."""
    from similaritysearchbyrdf_tpu_torch import SparseBatch, SparseFlatIndex, SparseRDFForest
    from similaritysearchbyrdf_tpu_torch.index.sparse_forest import fit_sparse
    from similaritysearchbyrdf_tpu_torch.interop import from_jax_sparse_flat

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = confs()
    batch = SparseBatch([0, 1], D, [[1, 2], [3, 0]], [[1.0, 2.0], [1.0, 0.0]], [2, 1])
    for make in (SparseRDFInit, lambda: SparseRDFForest(tc), SparseFlatIndex,
                 lambda: fit_sparse(tc, batch), lambda: sparse_from_jax_state({}, tc),
                 lambda: from_jax_sparse_flat({}, D)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
