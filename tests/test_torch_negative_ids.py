"""Negative user ids on the dense surfaces, port vs JAX package.

The JAX package takes the -1 that pads a result or a row for "no id": a
negative user id (the reference's ids are any Long) drops out of the dense
forest's `size()`, the flat and IVF engines' exact refine,
`DenseRDFInit`'s key-query lists, precision and dataTable distribution,
and `DynamicForest`'s size and compaction; and without query ids, the -1
each query gets excludes a user whose id is -1. The port knows padding by
position (the rows the tables or the layout hold, a live count) and a
result by its finite score, as its sparse front end does.

Each test states both packages' results on the same rows: the port under
negative ids answers as it does under non-negative ids (the same rows,
other ids), each id mapped back; under non-negative ids it answers as the
JAX package; the JAX package drops the negative ids where it reads them as
padding.
"""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu as J
import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.deploy.dense import DenseRDFInit as JFront
from similaritysearchbyrdf_tpu.index.dynamic import DynamicForest as JDynamic
from similaritysearchbyrdf_tpu_torch import (DenseBatch, DenseRDFInit, DynamicForest, FlatIndex,
                                             IVFFlatIndex, RDFForest, tune_nprobe)
from similaritysearchbyrdf_tpu_torch.index.partitioner import hash_partition

D, N = 16, 600


def confs(**kw):
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=30, partition_bits=2,
                query_batch_size=16, max_candidates=1024, top_k=5, seed=21,
                num_data_partitions=3)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)))


def data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D))
    x = centers[rng.integers(0, 12, n)] + 0.1 * rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


# every third row's id below 0 (row 0: -1); `shift` gives the same rows ids >= 0
POS = np.arange(N, dtype=np.int32)
NEG = np.where(POS % 3 == 0, -POS - 1, POS).astype(np.int32)
SHIFT = np.where(POS % 3 == 0, POS + 10_000, POS).astype(np.int32)
BACK = {**dict(zip(SHIFT.tolist(), NEG.tolist())), -1: -1}


def relabel(ids):
    return np.vectorize(BACK.get)(np.asarray(ids))


def test_forest_size_and_results():
    x = data()
    _, tc = confs()
    neg = RDFForest(tc, device="cpu").fit(DenseBatch(NEG, x))
    shift = RDFForest(tc, model=neg.model, device="cpu").fit(DenseBatch(SHIFT, x))
    jc, _ = confs()
    jneg = J.RDFForest(jc).fit(J.DenseBatch(NEG, x))
    assert neg.size() == N and jneg.size() == N - int((NEG < 0).sum())
    np.testing.assert_array_equal(neg.live_ids().numpy(), NEG)
    ni, ns = neg.query(x[:40], steps=1, query_ids=NEG[:40])
    si, ss = shift.query(x[:40], steps=1, query_ids=SHIFT[:40])
    np.testing.assert_array_equal(ni, relabel(si))
    np.testing.assert_array_equal(ns, ss)
    assert (ni < -1).any()
    # the JAX forest's fit and query know padding by position too: only its
    # size (and the surfaces built on it) drops the negative ids
    ji, _ = jneg.query(x[:40], steps=1, query_ids=NEG[:40])
    np.testing.assert_array_equal(np.asarray(ji), ni)


@pytest.mark.parametrize("engine", ["forest", "flat"])
def test_dense_front_end(engine):
    """Key-query lists, precision, the dataTable distribution and the size
    of `DenseRDFInit`, on the forest and on the flat engine."""
    x = data(1)
    jc, tc = confs(engine=engine)
    fronts = {}
    for name, ids in (("neg", NEG), ("shift", SHIFT)):
        fronts[name] = DenseRDFInit(device="cpu")
        fronts[name].initialize_rdf_hash_map(tc)
        fronts[name].fit_batch(DenseBatch(ids, x))
    jshift, jneg = JFront(), JFront()
    for front, ids in ((jshift, SHIFT), (jneg, NEG)):
        front.initialize_rdf_hash_map(jc)
        front.fit_batch(J.DenseBatch(ids, x))
    rows = [0, 1, 3, 5, 6, 9]
    lists = fronts["neg"].query_batch(NEG[rows].tolist())
    shifted = fronts["shift"].query_batch(SHIFT[rows].tolist())
    assert lists == [relabel(s).tolist() for s in shifted]
    assert shifted == jshift.query_batch(SHIFT[rows].tolist())
    assert any(i < -1 for w in lists for i in w)
    assert fronts["neg"].query_single_key(int(NEG[3])) == lists[2]
    assert not any(i < 0 for w in jneg.query_batch(NEG[rows].tolist()) for i in w)
    # precision against the exact top-k of the same rows, in each id space
    gt_rows = J.exact_search(x, x[:30], 5, exclude_self=True)[0]
    gt_neg = [set(NEG[r].tolist()) for r in gt_rows]
    _, p_neg, _ = fronts["neg"].top_k_and_precision_score(DenseBatch(NEG, x), gt_neg)
    _, p_shift, _ = fronts["shift"].top_k_and_precision_score(
        DenseBatch(SHIFT, x), [set(SHIFT[r].tolist()) for r in gt_rows])
    _, jp_neg, _ = jneg.top_k_and_precision_score(J.DenseBatch(NEG, x), gt_neg)
    assert p_neg == p_shift and p_neg > 0.8 and jp_neg < p_neg
    assert fronts["neg"].forest.size() == N
    if engine == "forest":     # the flat engine has no sub-index distribution
        dt, _ = fronts["neg"].get_dt_and_ht_num_distribution()
        want = np.bincount(hash_partition(torch.as_tensor(NEG), 3).numpy(), minlength=3)
        np.testing.assert_array_equal(dt, want)
        assert dt.sum() == N
        jdt, _ = jneg.get_dt_and_ht_num_distribution()
        assert jdt.sum() == int((NEG >= 0).sum())


@pytest.mark.parametrize("mode", ["grouped", "scan"])
def test_flat_index(mode):
    """The flat engine's exact refine (`flat_topk`, `flat_topk_grouped`);
    without query ids nothing is excluded, so the user of id -1 (row 0)
    is its own query's best hit."""
    x = data(2)
    neg = FlatIndex(mode=mode, device="cpu").fit(DenseBatch(NEG, x))
    shift = FlatIndex(mode=mode, device="cpu").fit(DenseBatch(SHIFT, x))
    jshift = J.FlatIndex(mode=mode).fit(J.DenseBatch(SHIFT, x))
    jneg = J.FlatIndex(mode=mode).fit(J.DenseBatch(NEG, x))
    ni, ns = neg.query(x[:32], k=10, query_ids=NEG[:32])
    si, ss = shift.query(x[:32], k=10, query_ids=SHIFT[:32])
    np.testing.assert_array_equal(ni, relabel(si))
    np.testing.assert_array_equal(ns, ss)
    np.testing.assert_array_equal(si, np.asarray(jshift.query(x[:32], k=10,
                                                               query_ids=SHIFT[:32])[0]))
    assert (ni < -1).any()
    ji, _ = jneg.query(x[:32], k=10, query_ids=NEG[:32])
    assert not (np.asarray(ji) < -1).any()
    ni, ns = neg.query(x[:1], k=3)
    assert ni[0, 0] == -1 and np.isfinite(ns[0, 0])
    ji, _ = jneg.query(x[:1], k=3)
    assert -1 not in np.asarray(ji)[0].tolist()[:1]


def test_ivf_index_heads_and_tune_nprobe():
    """IVF: negative-id rows are results, feed the head tier (the layout's
    rows), and count in `tune_nprobe`'s reference sets."""
    x = data(3, n=N)
    kw = dict(target_cluster=32, nprobe=4, win=16, refine=128, iters=4, head_pool=8, keep=6)
    neg = IVFFlatIndex(device="cpu", **kw).fit(DenseBatch(NEG, x))
    shift = IVFFlatIndex(device="cpu", **kw).fit(DenseBatch(SHIFT, x))
    jshift = J.IVFFlatIndex(**kw).fit(J.DenseBatch(SHIFT, x))
    jneg = J.IVFFlatIndex(**kw).fit(J.DenseBatch(NEG, x))
    assert torch.equal(neg.state.heads, shift.state.heads)
    ni, ns = neg.query(x[:32], k=10, query_ids=NEG[:32])
    si, ss = shift.query(x[:32], k=10, query_ids=SHIFT[:32])
    np.testing.assert_array_equal(ni, relabel(si))
    np.testing.assert_array_equal(ns, ss)
    np.testing.assert_array_equal(si, np.asarray(jshift.query(x[:32], k=10,
                                                               query_ids=SHIFT[:32])[0]))
    assert (ni < -1).any()
    assert not (np.asarray(jneg.query(x[:32], k=10, query_ids=NEG[:32])[0]) < -1).any()
    assert tune_nprobe(neg, x[:24], target_recall=0.95, k=5) == tune_nprobe(
        shift, x[:24], target_recall=0.95, k=5)
    ni, ns = neg.query(x[:1], k=3, nprobe=32)
    assert ni[0, 0] == -1 and np.isfinite(ns[0, 0])


def test_dynamic_forest_size_and_compaction():
    """`DynamicForest` counts negative-id rows and keeps them through a
    compaction; the JAX package's count and compaction leave them out."""
    x = data(4)
    jc, tc = confs()
    dyn = DynamicForest(tc, device="cpu")
    dyn.fit(DenseBatch(NEG[:500], x[:500]))
    dyn.add(DenseBatch(NEG[500:], x[500:]))
    dyn.remove(int(NEG[3]))
    assert dyn.size() == N - 1
    dyn.compact()
    assert dyn.size() == N - 1 and dyn.main.size() == N - 1
    assert sorted(dyn.main.live_ids().tolist()) == sorted(set(NEG.tolist()) - {int(NEG[3])})
    jdyn = JDynamic(jc)
    jdyn.fit(J.DenseBatch(NEG[:500], x[:500]))
    jdyn.add(J.DenseBatch(NEG[500:], x[500:]))
    jdyn.remove(int(NEG[3]))
    jdyn.compact()
    assert jdyn.size() == int((NEG >= 0).sum())
