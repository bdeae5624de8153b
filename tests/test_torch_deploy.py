"""Port vs JAX package: the dense front ends. Every `DenseRDFInit` method
(and its camelCase aliases) on the forest and on the flat engine,
`MultiFeatureRDFInit` and `LSHServer`, fed the same seeded rows: ids must
be equal, scores within the f32 bound of two summation orders of a D-term
dot of unit rows (2 * D * 2^-24; three times that for the sum of three
families)."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.deploy.dense import DenseRDFInit as JFront
from similaritysearchbyrdf_tpu.deploy.multi_feature import MultiFeatureRDFInit as JMulti
from similaritysearchbyrdf_tpu.deploy.server import LSHServer as JServer
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import (DenseBatch, DenseRDFInit, DynamicForest,
                                             MultiFeatureRDFInit, RDFMap)
from similaritysearchbyrdf_tpu_torch.deploy import server as tserver
from similaritysearchbyrdf_tpu_torch.experiments.harness import exact_ground_truth

D = 16
TOL = 2 * D * 2.0 ** -24


def confs(**kw):
    """The JAX package's front-end test config (tests/test_deploy.py)."""
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=30,
                partition_bits=2, query_batch_size=16, max_candidates=1024, top_k=5,
                seed=21)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)))


def data(seed, n=300, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(10, d))
    x = centers[rng.integers(0, 10, n)] + 0.1 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def write_dense_file(tmp_path, x, ids):
    path = tmp_path / "dense.txt"
    path.write_text("\n".join(f"[{i},[{','.join(repr(float(v)) for v in row)}]]"
                              for i, row in zip(ids, x)))
    return str(path)


def assert_same(got, want, tol=TOL):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol)


def test_every_jax_method_name_exists():
    public = {n for n in dir(JFront) if not n.startswith("_")}
    assert public <= {n for n in dir(DenseRDFInit) if not n.startswith("_")}
    public = {n for n in dir(JMulti) if not n.startswith("_")}
    assert public <= {n for n in dir(MultiFeatureRDFInit) if not n.startswith("_")}


def test_dense_front_end_matches_jax(tmp_path):
    """File fit, key and vector queries, ground truth, precision,
    distributions and teardown, with ids that are not row numbers."""
    jc, tc = confs()
    x = data(0)
    ids = (np.arange(300, dtype=np.int32) * 7 + 11)[::-1].copy()
    path = write_dense_file(tmp_path, x, ids)
    jf, tf = JFront(), DenseRDFInit(device="cpu")
    jf.initialize_rdf_hash_map(jc)
    tf.initializeRDFHashMap(tc)
    jb, tb = jf.new_fast_fit(path), tf.newFastFit(path)
    assert np.array_equal(tb.ids, jb.ids) and np.array_equal(tb.values, jb.values)
    for key in (int(ids[5]), int(ids[299]), 12345):
        assert tf.querySingleKey(key, steps=1) == jf.query_single_key(key, steps=1)
    assert tf.query_single_key(12345) is None
    keys = [int(ids[3]), 999999, int(ids[17]), int(ids[3]), -4, int(ids[250])]
    got = tf.queryBatch(keys, steps=1)
    assert got == jf.query_batch(keys, steps=1) and got[1] == [] and got[4] == []
    assert got == [tf.query_single_key(k, steps=1) or [] for k in keys]
    assert tf.query_batch([999999]) == [[]]
    for kw in (dict(steps=1), dict(steps=0, k=8)):
        assert_same(tf.NewMultiThreadQueryBatch(ids[:20], x[:20], **kw),
                    jf.new_multi_thread_query_batch(ids[:20], x[:20], **kw))
    assert_same(tf.query(ids[:20], x[:20], steps=1), jf.query(ids[:20], x[:20], steps=1))
    gt_rows = exact_ground_truth(x, x[:20], 5, device="cpu")
    gt_path = tmp_path / "gt.txt"
    gt_path.write_text("\n".join(str(ids[r].tolist()) for r in gt_rows))
    gt = tf.getTopKGroundTruth(str(gt_path), 5)
    assert gt == jf.get_top_k_ground_truth(str(gt_path), 5)
    t_ids, t_prec, t_ms = tf.topKAndPrecisionScore(tb, gt, tc, steps=1)
    j_ids, j_prec, _ = jf.top_k_and_precision_score(jb, gt, jc, steps=1)
    assert np.array_equal(t_ids, j_ids) and t_prec == j_prec and t_prec > 0.4 and t_ms > 0
    t_dt, t_ht = tf.getDtAndHtNumDistribution()
    j_dt, j_ht = jf.get_dt_and_ht_num_distribution()
    assert np.array_equal(t_dt, j_dt) and np.array_equal(t_ht, j_ht)
    assert t_dt.sum() == 300 and t_ht.dtype == np.float64
    tf.clearAndClose()
    assert tf.forest is None
    with pytest.raises(RuntimeError, match="initializeRDFHashMap"):
        tf.query_batch([1])


def test_fits_and_tensor_batches(tmp_path):
    """newMultiThreadFit equals newFastFit; a batch of tensors (ids and
    values) answers as its numpy twin, and an unfitted front end answers
    every key with []."""
    _, tc = confs()
    x = data(1)
    ids = np.arange(300, dtype=np.int32)
    path = write_dense_file(tmp_path, x, ids)
    a, b, c = (DenseRDFInit(device="cpu") for _ in range(3))
    for f in (a, b, c):
        f.initialize_rdf_hash_map(tc)
    assert c.query_batch([1, 2]) == [[], []] and c.query_single_key(1) is None
    a.new_fast_fit(path, limit=300)
    b.newMultiThreadFit(path)
    c.fit_batch(DenseBatch(torch.from_numpy(ids), torch.from_numpy(x)))
    want = a.new_multi_thread_query_batch(ids[:10], x[:10], steps=0)
    for f in (b, c):
        assert_same(f.new_multi_thread_query_batch(ids[:10], x[:10], steps=0), want, tol=0)
    assert c.query_batch([4, 400, 9], steps=1) == a.query_batch([4, 400, 9], steps=1)


def test_flat_engine_front_end_matches_jax():
    jc, tc = confs(engine="flat")
    x = data(2, n=400)
    ids = np.arange(400, dtype=np.int32)
    jf, tf = JFront(), DenseRDFInit(device="cpu")
    jf.initialize_rdf_hash_map(jc)
    tf.initialize_rdf_hash_map(tc)
    jf.fit_batch(JBatch(ids, x))
    tf.fit_batch(DenseBatch(ids, x))
    assert tf.forest.size() == jf.forest.size() == 400
    assert_same(tf.new_multi_thread_query_batch(ids[:32], x[:32], steps=2),
                jf.new_multi_thread_query_batch(ids[:32], x[:32], steps=2))
    keys = [5, 777, 31]
    assert tf.query_batch(keys) == jf.query_batch(keys)
    for f in (tf, jf):
        with pytest.raises(RuntimeError, match="forest concept"):
            f.get_dt_and_ht_num_distribution()


def test_multi_feature_matches_jax():
    jc, tc = confs(top_k=5)
    dims = {"blue": 12, "green": 16, "red": 8}
    rng_seeds = {"blue": 3, "green": 4, "red": 5}
    xs = {n: data(rng_seeds[n], n=300, d=d) for n, d in dims.items()}
    ids = np.arange(300, dtype=np.int32)
    jm, tm = JMulti(), MultiFeatureRDFInit(device="cpu")
    jm.initialize_multiple({n: jc.replace(vector_dim=d) for n, d in dims.items()})
    tm.initializeMapDBHashMultiple({n: tc.replace(vector_dim=d) for n, d in dims.items()})
    jm.new_multi_fast_fit({n: JBatch(ids, x) for n, x in xs.items()})
    tm.newMultiFastFit({n: DenseBatch(ids, x) for n, x in xs.items()})
    q = {n: x[:12] for n, x in xs.items()}
    for kw in (dict(steps=1, k=5, query_ids=ids[:12]),
               dict(steps=0, k=7, weights={"blue": 0.5, "green": 2.0, "red": 1.0})):
        assert_same(tm.multiFeatureSingleQuery(q, **kw), jm.multi_feature_query(q, **kw),
                    tol=3 * TOL)
    assert_same(tm.multi_feature_batch_query(q, 1, 5), jm.multi_feature_batch_query(q, 1, 5),
                tol=3 * TOL)
    tm.clearAndClose()
    assert not tm.forests


def test_lsh_server_matches_jax():
    jc, tc = confs()
    js, ts = JServer(), tserver.LSHServer(device="cpu")
    jm, tm = js.init_engine(jc), ts.init_engine(tc)
    assert np.array_equal(tm.proj.numpy(), np.asarray(jm.proj))
    assert np.array_equal(tm.perm.numpy(), np.asarray(jm.perm))
    assert ts.is_use_dense and ts.conf is tc and ts.lsh_engine is tm
    ts.init_engine(tc.replace(feature_data_format="sparse"))
    assert not ts.is_use_dense
    assert tserver.default_server.lsh_engine is None        # made without a card


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device named they take the first CUDA card, so without one
    they raise rather than run on the CPU."""
    _, tc = confs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DenseRDFInit, MultiFeatureRDFInit, lambda: RDFMap(tc),
                 lambda: DynamicForest(tc), lambda: tserver.LSHServer().init_engine(tc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
