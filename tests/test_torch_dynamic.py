"""Port vs JAX package: the mutable index. `DynamicForest` through one
sequence of inserts, removals, an automatic compaction and a compaction
past the tombstone limit, compared after every step; the tier merge alone
on the JAX package's own tier results; `RDFMap`; `RDFForest.add`; and
`sub_index_distribution`, with partition ids that set the key's top bit.

Both packages fit the same seeded rows into bit-equal tables, so what can
differ is float summation order in the exact rerank: ids must be equal,
scores within the f32 bound of two summation orders of a D-term dot of
unit rows (2 * D * 2^-24)."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.deploy.map_api import RDFMap as JMap
from similaritysearchbyrdf_tpu.index.dynamic import DynamicForest as JDynamic
from similaritysearchbyrdf_tpu.index.forest import RDFForest as JForest
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import DynamicForest, RDFForest, RDFMap
from similaritysearchbyrdf_tpu_torch.index.dynamic import merge_tiers
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.interop import dynamic_from_jax
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key

from test_torch_forest import jax_state_arrays

D = 16
TOL = 2 * D * 2.0 ** -24


def confs(**kw):
    """The JAX package's DynamicForest test config (tests/test_dynamic.py)."""
    base = dict(vector_dim=D, table_num=3, permutation_num=1, family_size=20,
                partition_bits=2, query_batch_size=16, max_candidates=1024, top_k=5,
                seed=41)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=16)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=16)))


def data(seed, n, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(10, d))
    x = centers[rng.integers(0, 10, n)] + 0.1 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def assert_same(got, want):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)


def test_dynamic_sequence_matches_jax():
    """fit, add (delta), query, remove from main and from the delta, add
    past the merge threshold (compaction), remove past TOMBSTONE_LIMIT
    (compaction): each step's state and answers equal the JAX package's."""
    jc, tc = confs()
    x = data(0, 700)
    ids = np.arange(700, dtype=np.int32)
    jd = JDynamic(jc, merge_threshold=0.5)
    td = DynamicForest(tc, merge_threshold=0.5, device="cpu")
    q, qid = x[280:312], ids[280:312]

    def check(step):
        for kw in (dict(steps=1, query_ids=qid), dict(steps=0, k=8)):
            assert_same(td.query(q, **kw), jd.query(q, **kw))
        assert td.size() == jd.size(), step
        assert td.main.size() == jd.main.size(), step
        assert (td.delta is None) == (jd.delta is None), step
        assert td._tombstones == jd._tombstones, step

    for dyn, batch in ((jd, JBatch), (td, TBatch)):
        dyn.fit(batch(ids[:300], x[:300]))
        dyn.add(batch(ids[300:400], x[300:400]))           # 100 <= 0.5 * 300
    assert td._delta_dirty and jd._delta_dirty
    check("add")
    assert td.delta.size() == 100
    for victim in (3, 305, 999):                           # main, delta, unknown
        jd.remove(victim)
        td.remove(victim)
    check("remove")
    assert 3 not in td.query(q, steps=1)[0] and 305 not in td.query(q, steps=1)[0]
    for dyn, batch in ((jd, JBatch), (td, TBatch)):
        dyn.add(batch(ids[400:460], x[400:460]))           # 159 > 0.5 * 300: compact
    assert td.delta is None and td.main.size() == 460 - 2        # 3 and 305 dropped
    check("auto-compaction")
    for victim in range(0, 130, 2):                        # 65 removals: past the limit
        jd.remove(victim)
        td.remove(victim)
    assert not td._tombstones and td.main.size() == 458 - 65
    check("limit compaction")
    for dyn, batch in ((jd, JBatch), (td, TBatch)):
        dyn.add(batch(ids[460:700:3], x[460:700:3]))
    check("add after compaction")


def test_compaction_equals_a_fresh_fit():
    """After compaction the tiers answer as one forest fitted on the
    surviving rows in the same order with the same model and chains."""
    _, tc = confs()
    x = data(2, 400)
    ids = np.arange(400, dtype=np.int32)
    dyn = DynamicForest(tc, merge_threshold=10.0, device="cpu")
    dyn.fit(TBatch(ids[:300], x[:300]))
    dyn.add(TBatch(ids[300:], x[300:]))
    for victim in (1, 2, 350):
        dyn.remove(victim)
    dyn.compact()
    keep = ~np.isin(ids, [1, 2, 350])
    fresh = RDFForest(tc, model=dyn.main.model, device="cpu")
    fresh.part_proj = dyn.main.part_proj
    fresh.fit(TBatch(ids[keep], x[keep]))
    assert_same(dyn.query(x[:40], steps=1, query_ids=ids[:40]),
                fresh.query(x[:40], steps=1, query_ids=ids[:40]))


@pytest.mark.parametrize("tombs", [(), (3, 17, 305), tuple(range(0, 40, 2))])
def test_merge_matches_jax_on_its_own_tiers(tombs):
    """The merge alone: the port's `merge_tiers` on the JAX package's two
    tiers' own (k + over-fetch) results gives the JAX package's merged
    answer bit for bit; and a port DynamicForest carried over from the JAX
    one (`dynamic_from_jax`) answers as it does."""
    jc, tc = confs()
    x = data(3, 420)
    ids = np.arange(420, dtype=np.int32)
    jd = JDynamic(jc, merge_threshold=10.0)
    jd.fit(JBatch(ids[:320], x[:320]))
    jd.add(JBatch(ids[320:], x[320:]))
    for t in tombs:
        jd.remove(t)
    q, qid = np.concatenate([x[:16], x[330:346]]), np.concatenate([ids[:16], ids[330:346]])
    want = jd.query(q, steps=1, query_ids=qid)             # rebuilds the delta
    extra = next(b for b in JDynamic.OVERFETCH_BUCKETS if b >= len(tombs))
    tiers = [tuple(torch.from_numpy(np.array(a)) for a in
                   t.query_device(q, steps=1, query_ids=qid, k=5 + extra))
             for t in (jd.main, jd.delta)]
    tomb_t = torch.tensor(sorted(jd._tombstones), dtype=torch.int32)
    got = merge_tiers(tiers, tomb_t, 5)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    port = dynamic_from_jax(tc, jax_state_arrays(jd.main.state),
                            jax_state_arrays(jd.delta.state), np.asarray(jd._delta_ids),
                            np.stack(jd._delta_vecs), jd._tombstones, merge_threshold=10.0,
                            device="cpu")
    assert port.overfetch() == extra and port.size() == jd.size()
    assert_same(port.query(q, steps=1, query_ids=qid), want)


def test_rdfmap_matches_jax():
    """The map surface and its similarity reads after each kind of
    mutation, against the JAX package's RDFMap."""
    jc, tc = confs()
    x = data(4, 260)
    jm, tm = JMap(jc), RDFMap(tc, device="cpu")
    for m in (jm, tm):
        for i in range(240):
            assert m.put(i, x[i]) is None
        assert np.array_equal(m.put(5, x[5]), x[5])
        assert m.put_if_absent(5, x[7]) is not None and m.putIfAbsent(240, x[240]) is None
        assert m.replace(9999, x[0]) is None and m.replace(6, x[250]) is not None
        assert m.get(241, value_creator=lambda k: x[k]) is not None
        assert m.remove(7) is not None and m.remove(7) is None
    assert tm.keys() == jm.keys() and len(tm) == len(jm) == 241
    assert all(np.array_equal(a, b) for a, b in zip(tm.values(), jm.values()))
    assert 7 not in tm and 6 in tm
    for key in (0, 6, 240, 241, 7):
        assert tm.get_similar(key, steps=1) == jm.get_similar(key, steps=1)
    first_proj = tm._forest.model.proj
    tm.put(300, x[255])
    jm.put(300, x[255])
    assert tm.getSimilarWithStepWiseFaster(x[255], steps=1) == \
        jm.get_similar_by_vector(x[255], steps=1)
    assert tm._forest.model.proj.data_ptr() == first_proj.data_ptr()   # the same functions
    tm.clear()
    with pytest.raises(RuntimeError):
        tm.get_similar(0)


def test_forest_add_matches_jax():
    jc, tc = confs()
    x = data(5, 360)
    ids = np.arange(1000, 1360, dtype=np.int32)
    jf = JForest(jc).fit(JBatch(ids[:300], x[:300]))
    tf = RDFForest(tc, device="cpu").fit(TBatch(ids[:300], x[:300]))
    jf.add(JBatch(ids[300:], x[300:]))
    tf.add(TBatch(ids[300:], x[300:]))
    assert tf.size() == jf.size() == 360
    np.testing.assert_array_equal(tf.state.row_ids.numpy(), np.asarray(jf.state.row_ids))
    np.testing.assert_array_equal(tf.state.tables.sorted_ids.numpy(),
                                  np.asarray(jf.state.tables.sorted_ids))
    assert_same(tf.query(x[290:320], steps=1, query_ids=ids[290:320]),
                jf.query(x[290:320], steps=1, query_ids=ids[290:320]))
    empty = RDFForest(tc, device="cpu").add(TBatch(ids[:10], x[:10]))
    assert empty.size() == 10


@pytest.mark.parametrize("pbits", [2, 3])
def test_sub_index_distribution_matches_jax(pbits):
    """At 3 partition bits the composite key is 32 bits wide, so partition
    ids 4-7 set the key's top bit, which the int32 key stores flipped."""
    jc, tc = confs(partition_bits=pbits, table_num=4)
    x = data(6, 500)
    ids = np.arange(500, dtype=np.int32)
    jf = JForest(jc).fit(JBatch(ids, x))
    tf = RDFForest(tc, device="cpu").fit(TBatch(ids, x))
    got, want = tf.sub_index_distribution(), jf.sub_index_distribution()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 1 << pbits) and (got.sum(axis=1) == 500).all()
    layout = KeyLayout.from_config(tc, tc.lsh_table)
    if pbits == 3:
        assert layout.total_bits == 32
        keys = from_key(tf.state.tables.sorted_keys)
        live = tf.state.tables.sorted_ids[:, :keys.shape[1]] >= 0
        assert bool(((keys >> 31) == 1)[live].any())
        assert got[:, 4:].sum() > 0
