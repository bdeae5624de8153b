"""Port vs JAX package on the sharded dense forest: the same
corpus, model and seed fitted by the JAX package on its 8 virtual CPU
devices (`tests/conftest.py`) and by the port on
`make_forest_mesh(devices=["cpu"] * 8)` (and 4 shards of each).

The per-shard tables are equal bit for bit (`from_key` of the port's keys),
so the classic path and block mode must give equal ids on every query;
window mode with the head tier and the folded tier differ only in f32
summation order, so ids must be equal on >= 99% of queries and every
query equal up to near-ties (1e-6), as in `test_torch_sparse_forest.py`.
Scores agree within D * 2^-22 (unit rows: a dot of D products, each side
rounding once a product and once an add).

Also: the dominance contract of `tests/test_sharded.py` on the port, shards
with no rows, ids from a 100M id space, negative ids (a live row in the
port, padding in the JAX package: both results stated), the unfitted
forest, and `interop.from_jax_sharded_state` answering as the JAX state
does. The sparse forest's are in `test_torch_sharded_sparse.py`.
"""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.parallel import sharded_forest as JSF
from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh as jax_mesh
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFForest, sharded_forest
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.interop import from_jax_sharded_state
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key
from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as TSF
from similaritysearchbyrdf_tpu_torch.parallel.mesh import SHARD_AXIS, make_forest_mesh

D = 24
SCORE_TOL = D * 2.0 ** -22
# (name, config overrides, query keywords, exact ids on every query)
MODES = [
    ("classic", {}, {}, True),
    ("classic_margin", {}, dict(probe_mode="margin", probe_budget=8), True),
    ("block_int8", dict(coarse_dim=16, coarse_refine=256, max_candidates=1024), {}, True),
    ("block_bf16_tier", dict(coarse_dim=16, coarse_dtype="bfloat16", coarse_refine=256,
                             max_candidates=1024), {}, True),
    ("bf16_rerank", dict(rerank_dtype="bfloat16"), {}, True),
    ("window_head", dict(coarse_dim=24, coarse_refine=512, coarse_window=64,
                         coarse_head_pool=8), dict(window_keep=16), False),
    ("folded", dict(coarse_dim=16, coarse_layout="folded", coarse_window=256,
                    coarse_refine=512), {}, False),
    ("folded_rows_keep", dict(coarse_dim=16, coarse_layout="folded", coarse_window=256,
                              coarse_refine=512), dict(rows_keep=2), False),
]


def _conf(m, **kw):
    base = dict(vector_dim=D, table_num=3, permutation_num=2, family_size=30, partition_bits=2,
                lsh_table=m.TableConfig(chain_length=12, bucket_overflow=16),
                query_batch_size=32, max_candidates=8192, seed=7)
    base.update(kw)
    return m.RDFConfig(**base)


def _data(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(30, D))
    x = centers[rng.integers(0, 30, n)] + 0.15 * rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mesh(s):
    return make_forest_mesh(devices=["cpu"] * s)


def _pair(kw, x, ids, shards=8):
    j = JSF.ShardedRDFForest(_conf(jcfg, **kw), mesh=jax_mesh(shards), seed=3)
    j.fit(JBatch(ids, x))
    t = sharded_forest(_conf(tcfg, **kw), mesh=_mesh(shards), seed=3)
    t.fit(DenseBatch(ids, x))
    return j, t


def _same(ji, js, ti, ts, exact):
    """Both packages' answers: equal -inf positions, scores within
    SCORE_TOL, ids equal on every query (exact) or on >= 99% and up to
    near-ties elsewhere."""
    assert (np.isfinite(js) == np.isfinite(ts)).all()
    fin = np.isfinite(js)
    assert (np.abs(js[fin] - ts[fin]) <= SCORE_TOL).all()
    if exact:
        np.testing.assert_array_equal(ti, ji)
        return
    assert (ti == ji).all(axis=1).mean() >= 0.99
    for i in range(len(ji)):
        f = fin[i]
        assert equal_up_to_ties(ti[i][f], ts[i][f], ji[i][f], js[i][f], 1e-6), i


@pytest.mark.parametrize("name,kw,qkw,exact", MODES, ids=[m[0] for m in MODES])
def test_dense_modes_match_jax_8_shards(name, kw, qkw, exact):
    x = _data()
    ids = np.arange(len(x), dtype=np.int32)
    j, t = _pair(kw, x, ids)
    assert t.mesh.shape[SHARD_AXIS] == 8 and len(t.state.shards) == 8
    for steps in ((0, 1) if name == "classic" else (1,)):
        ji, js = j.query(x[:64], steps=steps, query_ids=np.arange(64), **qkw)
        ti, ts = t.query(x[:64], steps=steps, query_ids=np.arange(64), **qkw)
        _same(ji, js, ti, ts, exact)


@pytest.mark.parametrize("name", ["classic", "block_int8", "folded"])
def test_dense_modes_match_jax_4_shards(name):
    _, kw, qkw, exact = next(m for m in MODES if m[0] == name)
    x = _data(700, seed=1)
    ids = np.arange(len(x), dtype=np.int32)
    j, t = _pair(kw, x, ids, shards=4)
    ji, js = j.query(x[:48], steps=1, query_ids=np.arange(48), **qkw)
    ti, ts = t.query(x[:48], steps=1, query_ids=np.arange(48), **qkw)
    _same(ji, js, ti, ts, exact)


def test_shard_tables_bit_equal_to_jax():
    """Every shard's sorted keys and ids, bucket arrays and int8 tier equal
    the JAX shard's (its lane-packed tier, one table a segment)."""
    x = _data()
    ids = np.arange(len(x), dtype=np.int32)
    j, t = _pair(dict(coarse_dim=16, coarse_refine=256), x, ids)
    js = j.state
    for s, st in enumerate(t.state.shards):
        np.testing.assert_array_equal(from_key(st.tables.sorted_keys).numpy(),
                                      np.asarray(js.sorted_keys)[s])
        np.testing.assert_array_equal(st.tables.sorted_ids.numpy(), np.asarray(js.sorted_ids)[s])
        np.testing.assert_array_equal(st.tables.bucket_starts.numpy(),
                                      np.asarray(js.bucket_starts)[s])
        cbt = np.asarray(js.coarse_by_table)[s]                 # [Lg, caprows, G*cs]
        for tab in range(3):
            g, seg = divmod(tab, cbt.shape[2] // 16)
            np.testing.assert_array_equal(st.coarse_tier[tab].numpy(),
                                          cbt[g, :, seg * 16:(seg + 1) * 16])
    assert t.state.nloc == 256 and t.state.n_live == [256, 256, 256, 256, 176, 0, 0, 0]


def test_dominates_single_device():
    """`tests/test_sharded.py:46`'s contract on the port: each shard splits
    shallower than one big index, so the merged scores dominate the
    single-device forest's elementwise."""
    x = _data()
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    conf = _conf(tcfg)
    sharded = sharded_forest(conf, mesh=_mesh(8)).fit(batch)
    single = RDFForest(conf, model=sharded.model, device="cpu")
    single.part_proj = sharded.part_proj
    single.fit(batch)
    for steps in (0, 1):
        _, sc_s = sharded.query(x[:16], steps=steps, query_ids=np.arange(16))
        _, sc_1 = single.query(x[:16], steps=steps, query_ids=np.arange(16))
        fin = np.isfinite(sc_1)
        assert (sc_s[fin] >= sc_1[fin] - 1e-5).all()


def test_empty_shards_and_merge_redone_on_host():
    """300 rows over 8 shards of 128: shards 3-7 hold no row and answer
    nothing; the merge equals one redone on the host from each shard's own
    list (stable by score, ties to the earlier shard), and equals the JAX
    package's."""
    x = _data(300, seed=2)
    ids = np.arange(300, dtype=np.int32)
    j, t = _pair({}, x, ids)
    assert t.state.n_live == [128, 128, 44, 0, 0, 0, 0, 0]
    ji, js = j.query(x[:8], steps=0)
    ti, ts = t.query(x[:8], steps=0)
    _same(ji, js, ti, ts, True)
    layout = KeyLayout.from_config(t.conf, t.conf.lsh_table)
    outs = TSF.query_shards(t.state, torch.as_tensor(x[:8]), None, layout,
                            TSF.QueryOptions(k=10, m_cap=8192, exclude_self=False))
    assert all((o[0] == -1).all() for o in outs[3:])
    flat_i = np.concatenate([o[0].numpy() for o in outs], axis=1)
    flat_s = np.concatenate([o[1].numpy() for o in outs], axis=1)
    order = np.argsort(-flat_s, axis=1, kind="stable")[:, :10]
    want_s = np.take_along_axis(flat_s, order, 1)
    want_i = np.where(want_s > -np.inf, np.take_along_axis(flat_i, order, 1), -1)
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(ts, want_s)


def test_ids_from_a_100m_space():
    x = _data()
    ids = np.sort(np.random.default_rng(4).choice(100_000_000, len(x), replace=False))
    ids = ids.astype(np.int32)
    j, t = _pair(dict(coarse_dim=16, coarse_refine=256, max_candidates=1024), x, ids)
    ji, js = j.query(x[:32], steps=1, query_ids=ids[:32])
    ti, ts = t.query(x[:32], steps=1, query_ids=ids[:32])
    _same(ji, js, ti, ts, True)
    assert set(ti[ti >= 0].tolist()) <= set(ids.tolist())
    assert (ti != ids[:32, None]).all() and (ti >= 0).all()
    assert t.size() == len(x) and torch.equal(t.live_ids(), torch.as_tensor(ids))


def test_negative_ids():
    """Ids below 0 (every third row): the port answers as it does for the
    same rows under non-negative ids, with each id mapped back; the JAX
    package takes them for padding, keys them out of its shards and never
    returns them."""
    x = _data()
    pos = np.arange(len(x), dtype=np.int32)
    neg = np.where(pos % 3 == 0, -pos - 1, pos).astype(np.int32)
    shift = np.where(pos % 3 == 0, pos + 5000, pos).astype(np.int32)    # the same rows, ids >= 0
    back = dict(zip(shift.tolist(), neg.tolist()))
    back[-1] = -1
    kw = dict(coarse_dim=16, coarse_refine=256, max_candidates=1024)
    _, t_neg = _pair(kw, x, neg)
    j_shift, t_shift = _pair(kw, x, shift)
    j_neg = JSF.ShardedRDFForest(_conf(jcfg, **kw), mesh=jax_mesh(8), seed=3)
    j_neg.fit(JBatch(neg, x))
    tn, tns = t_neg.query(x[:48], steps=1, query_ids=neg[:48])
    ts_, tss = t_shift.query(x[:48], steps=1, query_ids=shift[:48])
    js_, jss = j_shift.query(x[:48], steps=1, query_ids=shift[:48])
    np.testing.assert_array_equal(tn, np.vectorize(back.get)(ts_))
    np.testing.assert_array_equal(tns, tss)
    _same(js_, jss, ts_, tss, True)
    assert (tn < -1).any()
    jn, _ = j_neg.query(x[:48], steps=1, query_ids=neg[:48])
    jn = np.asarray(jn)
    assert not (jn < -1).any() and (jn >= 0).any()
    assert t_neg.size() == len(x)
    np.testing.assert_array_equal(np.sort(t_neg.live_ids().numpy()), np.sort(neg))


def test_unfitted_forest_raises():
    t = sharded_forest(_conf(tcfg), mesh=_mesh(2))
    assert t.size() == 0
    with pytest.raises(RuntimeError, match="fit the data first"):
        t.query(_data(4), steps=0)


def _jax_arrays(state):
    out = {f"model.{f}": np.asarray(getattr(state.model, f))
           for f in ("proj", "perm", "b", "sampling_perm")}
    for f in ("part_proj", "sorted_keys", "sorted_ids", "bucket_keys", "bucket_starts",
              "bucket_shifts", "corpus", "row_ids", "corpus_lp", "coarse_proj",
              "coarse_by_table", "coarse_head", "coarse_folded", "ids128",
              "corpus_indices", "corpus_values"):
        a = getattr(state, f, None)
        if a is not None:
            out[f] = np.asarray(a)
    return out


@pytest.mark.parametrize("name", ["classic", "window_head", "folded"])
def test_from_jax_sharded_state(name):
    """The JAX sharded state carried over shard by shard (the lane tier and
    its head tier unpacked, `ids128` dropped) answers as the JAX state."""
    _, kw, qkw, exact = next(m for m in MODES if m[0] == name)
    x = _data()
    ids = np.arange(len(x), dtype=np.int32)
    j, _ = _pair(kw, x, ids)
    tc = _conf(tcfg, **kw)
    port = sharded_forest(tc, mesh=_mesh(8))
    port.state = from_jax_sharded_state(_jax_arrays(j.state), tc, port.mesh)
    ji, js = j.query(x[:32], steps=1, query_ids=np.arange(32), **qkw)
    ti, ts = port.query(x[:32], steps=1, query_ids=np.arange(32), **qkw)
    _same(ji, js, ti, ts, exact)
