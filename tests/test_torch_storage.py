"""Persistence in the port (`similaritysearchbyrdf_tpu_torch/storage/persist.py`)
against the JAX package's, on the CPU: files written by either package load
in the other, and the tiered generation store.

Tolerances: queries of one index in the two packages differ only in float
summation order, so scores agree position by position within 2*D*2^-24
(unit vectors: |x.q| <= 1) and the ids are equal, except that two rows
whose scores lie within that bound may come in either order
(`equal_up_to_ties`; at least 90% of the queries equal outright); a load in
the package that saved gives its fit's ids and scores bit for bit. Integer
arrays, file members and rebuilt tiers are compared exactly.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index.forest import RDFForest as JForest
from similaritysearchbyrdf_tpu.ops.flat import FlatIndex as JFlatIndex
from similaritysearchbyrdf_tpu.ops.ivf import IVFFlatIndex as JIVFIndex
from similaritysearchbyrdf_tpu.storage import persist as JP
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import (DenseBatch, FlatIndex, GenerationStore, IVFFlatIndex,
                                             RDFForest, TieredForest, from_jax_state, load_flat,
                                             load_forest, load_ivf, save_flat, save_forest,
                                             save_ivf)
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.index.bucket_table import ID_PAD
from similaritysearchbyrdf_tpu_torch.storage import persist as P

from test_torch_forest import jax_state_arrays

N, D, NQ = 1500, 24, 16
TOL = 2 * D * 2.0 ** -24

FOREST_CONFS = {
    # int8 lane tier with a head tier, queried in window mode with pruning
    "int8_head": dict(coarse_dim=8, coarse_refine=256, coarse_window=64, coarse_head_pool=8,
                      coarse_keep=16, max_candidates=2048),
    # bf16 tier on a PCA basis with the bf16 two-stage rerank, block mode
    "bf16_pca_lp": dict(coarse_dim=8, coarse_dtype="bfloat16", coarse_proj_mode="pca",
                        rerank_dtype="bfloat16", coarse_refine=256),
    # the slot-folded int8 tier
    "folded": dict(coarse_dim=16, coarse_layout="folded", coarse_refine=2048, coarse_window=64),
    # no coarse tier: the plain path
    "plain": {},
}


def confs(**kw):
    base = dict(vector_dim=D, table_num=3, permutation_num=2, family_size=24,
                partition_bits=2, query_batch_size=16, max_candidates=1024, top_k=5, seed=13)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=16)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=16)))


def clustered(n=N, d=D, seed=1, centers=12, noise=0.1):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + noise * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


X = clustered()
IDS = np.arange(N, dtype=np.int32)
Q, QIDS = X[:NQ], np.arange(NQ)


def assert_same(got, want):
    (gi, gs), (wi, ws) = got, want
    assert gi.shape == wi.shape
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(np.where(fin, 0.0, gs), np.where(fin, 0.0, ws))
    assert (np.abs(gs - ws)[fin] <= TOL).all(), np.abs(gs - ws)[fin].max()
    g0, w0 = np.where(fin, gs, 0.0), np.where(fin, ws, 0.0)
    assert all(equal_up_to_ties(gi[i], g0[i], wi[i], w0[i], TOL) for i in range(len(gi)))
    assert (gi == wi).all(axis=1).mean() >= 0.9


@pytest.fixture(scope="module", params=list(FOREST_CONFS))
def forests(request):
    """(name, jax conf, port conf, the JAX package's fit, the port's fit)."""
    jc, tc = confs(**FOREST_CONFS[request.param])
    jf = JForest(jc).fit(JBatch(IDS, X))
    tf = RDFForest(tc, device="cpu").fit(DenseBatch(IDS, X))
    return request.param, jc, tc, jf, tf


def q(forest):
    return forest.query(Q, steps=1, query_ids=QIDS)


# ---------------------------------------------------------------------------
# forests
# ---------------------------------------------------------------------------


def test_jax_forest_file_loads_in_the_port(forests, tmp_path):
    _, _, _, jf, _ = forests
    JP.save_forest(jf, str(tmp_path / "j"))
    loaded = load_forest(str(tmp_path / "j"), device="cpu")
    assert_same(q(loaded), q(jf))


def test_port_forest_file_loads_in_jax(forests, tmp_path):
    _, _, _, _, tf = forests
    save_forest(tf, str(tmp_path / "p"))
    assert_same(q(JP.load_forest(str(tmp_path / "p"))), q(tf))


@pytest.mark.parametrize("compress", [True, False])
def test_port_forest_roundtrip_is_bit_equal(forests, tmp_path, compress):
    """A load in the port rebuilds the fitted forest: every tensor equal
    (the coarse tier, its head tier and the bf16 rerank copy included), and
    the same ids and scores bit for bit."""
    _, _, _, _, tf = forests
    save_forest(tf, str(tmp_path / "p"), compress=compress)
    loaded = load_forest(str(tmp_path / "p"), device="cpu")
    a, b = tf.state, loaded.state
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or x is None:
            assert (x is None and y is None) or torch.equal(x, y), f.name
    for f in dataclasses.fields(a.tables):
        assert torch.equal(getattr(a.tables, f.name), getattr(b.tables, f.name)), f.name
    for f in ("proj", "perm", "b", "sampling_perm"):
        assert torch.equal(getattr(a.model, f), getattr(b.model, f)), f
    assert a.coarse_layout == b.coarse_layout
    if a.coarse_folded is not None:
        assert torch.equal(a.coarse_folded, b.coarse_folded)
    gi, gs = q(loaded)
    wi, ws = q(tf)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)


def test_port_file_members_equal_jax(forests, tmp_path):
    """The port's save of the JAX package's state (carried over by
    `from_jax_state`) has the JAX package's npz members: names, dtypes,
    shapes and values; the JSON has the same meta."""
    _, jc, tc, jf, _ = forests
    JP.save_forest(jf, str(tmp_path / "j"))
    port = RDFForest(tc, device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    save_forest(port, str(tmp_path / "p"))
    with np.load(str(tmp_path / "j.npz")) as jz, np.load(str(tmp_path / "p.npz")) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        for name in jz.files:
            assert jz[name].dtype == pz[name].dtype, name
            assert jz[name].shape == pz[name].shape, name
            np.testing.assert_array_equal(jz[name], pz[name], err_msg=name)
    import json
    jm = json.load(open(str(tmp_path / "j.json")))
    pm = json.load(open(str(tmp_path / "p.json")))
    assert jm == pm


def test_rebuilt_tier_equals_the_jax_fit(forests, tmp_path):
    """A JAX-saved forest's tier, rebuilt by the port from the saved
    projection, equals the JAX package's fitted tier unpacked per table
    (a forest without one loads without one)."""
    name, _, tc, jf, _ = forests
    JP.save_forest(jf, str(tmp_path / "j"))
    loaded = load_forest(str(tmp_path / "j"), device="cpu").state
    carried = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    if not tc.coarse_dim:
        assert loaded.coarse_proj is None and loaded.coarse_tier is None
        assert loaded.coarse_head is None and loaded.corpus_lp is None
        return
    assert torch.equal(loaded.coarse_proj, carried.coarse_proj)
    if name == "bf16_pca_lp":
        # the port's f32 product may round a bf16 value the other way; the
        # rest of the tier is equal
        diff = loaded.coarse_tier.float() - carried.coarse_tier.float()
        assert (diff != 0).float().mean() < 1e-3
    else:
        assert torch.equal(loaded.coarse_tier, carried.coarse_tier)
    if carried.coarse_head is not None:
        assert loaded.coarse_head is not None
        assert torch.equal(loaded.coarse_head, carried.coarse_head)


def test_model_fingerprint_is_equal_across_packages(forests, tmp_path):
    _, _, _, jf, tf = forests
    fp = P.model_fingerprint(tf.state.model)
    assert len(fp) == 16
    assert fp == JP.model_fingerprint(jf.state.model)
    save_forest(tf, str(tmp_path / "p"))
    assert P.model_fingerprint(load_forest(str(tmp_path / "p"), device="cpu").model) == fp


def test_forest_state_bytes_counts_the_ports_tensors(forests):
    """The JAX package's fields on the port's tensors: the same count less
    the JAX package's 128-lane corpus padding (and its bf16 copy's)."""
    _, _, tc, jf, tf = forests
    st = tf.state
    want = sum(t.numel() * t.element_size() for t in (
        st.corpus, st.row_ids, st.part_proj, st.model.proj, st.model.perm, st.model.b,
        st.model.sampling_perm, *dataclasses.astuple(st.tables)))
    if st.corpus_lp is not None:
        want += st.corpus_lp.numel() * 2
    assert P.forest_state_bytes(st) == want
    pad = st.corpus.shape[0] * (128 - D)
    assert P.forest_state_bytes(st) == JP.forest_state_bytes(jf.state) - pad * (
        4 + (2 if st.corpus_lp is not None else 0))


def test_legacy_forest_files_load(tmp_path):
    """Files from before the `ID_PAD` tail and the 128-lane corpus load
    into the same forest."""
    _, tc = confs(**FOREST_CONFS["int8_head"])
    tf = RDFForest(tc, device="cpu").fit(DenseBatch(IDS, X))
    save_forest(tf, str(tmp_path / "new"))
    with np.load(str(tmp_path / "new.npz")) as z:
        arrays = {name: z[name] for name in z.files}
    arrays["sorted_ids"] = arrays["sorted_ids"][:, :-ID_PAD]
    arrays["corpus"] = arrays["corpus"][:, :D]
    np.savez(str(tmp_path / "old.npz"), **arrays)
    os.replace(str(tmp_path / "new.json"), str(tmp_path / "old.json"))
    loaded = load_forest(str(tmp_path / "old"), device="cpu")
    assert torch.equal(loaded.state.tables.sorted_ids, tf.state.tables.sorted_ids)
    assert torch.equal(loaded.state.coarse_tier, tf.state.coarse_tier)
    np.testing.assert_array_equal(q(loaded)[0], q(tf)[0])


def test_saving_an_unfitted_forest_raises(tmp_path):
    _, tc = confs()
    with pytest.raises(RuntimeError):
        save_forest(RDFForest(tc, device="cpu"), str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# flat and IVF engines
# ---------------------------------------------------------------------------


FLAT_KW = {"int8": dict(sketch_dtype="int8", refine=64, block=1024),
           "bf16": dict(sketch_dtype="bfloat16", refine=64, block=1024),
           "bf16_corpus": dict(sketch_dtype="int8", refine=64, block=1024,
                               corpus_dtype="bfloat16")}


@pytest.mark.parametrize("name", list(FLAT_KW))
def test_flat_files_cross_load(name, tmp_path):
    kw = FLAT_KW[name]
    jf = JFlatIndex(**kw).fit(JBatch(IDS, X))
    tf = FlatIndex(device="cpu", **kw).fit(DenseBatch(IDS, X))
    JP.save_flat(jf, str(tmp_path / "j"))
    save_flat(tf, str(tmp_path / "p"))
    with np.load(str(tmp_path / "j.npz")) as jz, np.load(str(tmp_path / "p.npz")) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        for m in jz.files:
            assert (jz[m].dtype, jz[m].shape) == (pz[m].dtype, pz[m].shape), m
            np.testing.assert_array_equal(jz[m], pz[m], err_msg=m)
    want = jf.query(Q, k=10, query_ids=QIDS)
    from_j = load_flat(str(tmp_path / "j"), device="cpu")
    from_p = load_flat(str(tmp_path / "p"), device="cpu")
    for idx in (from_j, from_p):
        assert idx.corpus.shape == (N, D) and idx.sketch.shape[1] == 32
        assert (idx.sketch_dtype, idx.corpus_dtype) == (tf.sketch_dtype, tf.corpus_dtype)
        assert torch.equal(idx.sketch, tf.sketch) and torch.equal(idx.corpus, tf.corpus)
        assert idx.scale == tf.scale
        assert_same(idx.query(Q, k=10, query_ids=QIDS), want)
    assert_same(JP.load_flat(str(tmp_path / "p")).query(Q, k=10, query_ids=QIDS), want)


IVF_KW = {"plain": dict(target_cluster=32, nprobe=8, refine=64, iters=3, wb=40,
                        train_sample=512),
          "pruned": dict(target_cluster=32, nprobe=8, win=64, refine=64, iters=3,
                         head_pool=16, keep=6)}


@pytest.mark.parametrize("name", list(IVF_KW))
def test_ivf_files_cross_load(name, tmp_path):
    """Each package's IVF file loads in the other and answers as the index
    that saved it; the knobs survive; the head tier is rebuilt."""
    kw = IVF_KW[name]
    jx = JIVFIndex(**kw).fit(JBatch(IDS, X))
    tx = IVFFlatIndex(device="cpu", **kw).fit(DenseBatch(IDS, X))
    JP.save_ivf(jx, str(tmp_path / "j"))
    save_ivf(tx, str(tmp_path / "p"))
    with np.load(str(tmp_path / "j.npz")) as jz, np.load(str(tmp_path / "p.npz")) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        for m in jz.files:
            assert (jz[m].dtype, jz[m].shape[1:]) == (pz[m].dtype, pz[m].shape[1:]), m
    from_j = load_ivf(str(tmp_path / "j"), device="cpu")
    assert_same(from_j.query(Q, k=5, query_ids=QIDS), jx.query(Q, k=5, query_ids=QIDS))
    from_p = load_ivf(str(tmp_path / "p"), device="cpu")
    for f in ("target_cluster", "nprobe", "win", "refine", "iters", "wb", "train_sample",
              "head_pool", "keep"):
        assert getattr(from_p, f) == getattr(tx, f), f
    for a, b in zip(from_p.state, tx.state):
        assert (a is None and b is None) or torch.equal(a, b)
    want = tx.query(Q, k=5, query_ids=QIDS)
    got = from_p.query(Q, k=5, query_ids=QIDS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert_same(JP.load_ivf(str(tmp_path / "p")).query(Q, k=5, query_ids=QIDS), want)


def test_bf16_ivf_corpus_survives_a_roundtrip(tmp_path):
    from similaritysearchbyrdf_tpu_torch.ops.ivf import build_ivf

    tx = IVFFlatIndex(target_cluster=32, nprobe=8, refine=64, iters=3, device="cpu")
    tx.state = build_ivf(torch.as_tensor(X), IDS, target_cluster=32, iters=3,
                         sketch_dtype="bfloat16")
    tx.state = tx.state._replace(corpus=tx.state.corpus.to(torch.bfloat16))
    save_ivf(tx, str(tmp_path / "p"))
    back = load_ivf(str(tmp_path / "p"), device="cpu")
    assert back.state.sketch.dtype == back.state.corpus.dtype == torch.bfloat16
    for a, b in zip(back.state, tx.state):
        assert (a is None and b is None) or torch.equal(a, b)


def test_loads_refuse_another_engines_file(tmp_path):
    tf = FlatIndex(device="cpu").fit(DenseBatch(IDS, X))
    save_flat(tf, str(tmp_path / "f"))
    with pytest.raises(ValueError):
        load_ivf(str(tmp_path / "f"), device="cpu")


# ---------------------------------------------------------------------------
# the tiered store (mirrors tests/test_storage.py, test_tiered_get.py and
# test_tiered_scale.py)
# ---------------------------------------------------------------------------


def small_conf(**kw):
    base = dict(vector_dim=8, table_num=2, permutation_num=1, family_size=10,
                partition_bits=2, lsh_table=tcfg.TableConfig(chain_length=8, bucket_overflow=16),
                query_batch_size=8, max_candidates=256, top_k=3, seed=9)
    base.update(kw)
    return tcfg.RDFConfig(**base)


def store(tmp_path, name="g", **kw):
    return GenerationStore(str(tmp_path), name, device="cpu", **kw)


def unit(rng, n, d):
    x = rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("layout", ["lane", "folded"])
def test_tiered_spill_and_merge(tmp_path, layout):
    """A spilled generation and a fresh device tier: the merge reaches both,
    equals the JAX package's merge of the same tiers' lists (stable,
    earlier tier first on ties), and scores dominate one tier's."""
    kw = dict(coarse_dim=16, coarse_layout="folded", coarse_refine=2048,
              coarse_window=64) if layout == "folded" else {}
    _, conf = confs(**kw)
    x = clustered(n=500, seed=2)
    s = store(tmp_path)
    tiered = TieredForest(conf, s)
    tiered.fit(DenseBatch(np.arange(250, dtype=np.int32), x[:250]))
    stem = tiered.spill()
    assert tiered.device_tier is None and s.generations() == [stem]
    assert s.summary(stem).might_contain(np.arange(250, dtype=np.uint32)).all()
    tiered.fit(DenseBatch(np.arange(250, 500, dtype=np.int32), x[250:]))
    ids, scores = tiered.query(x[:16], steps=1, query_ids=np.arange(16))
    assert (ids[ids >= 0] < 250).any() and (ids[ids >= 0] >= 250).any()
    lists = [t.query(x[:16], steps=1, query_ids=np.arange(16), k=conf.top_k)
             for t in (tiered.device_tier, s.load_generation(stem))]
    cat_i = np.concatenate([a for a, _ in lists], axis=1)
    cat_s = np.concatenate([b for _, b in lists], axis=1)
    order = np.argsort(-cat_s, axis=1, kind="stable")[:, :conf.top_k]
    want_s = np.take_along_axis(cat_s, order, 1)
    want_i = np.where(np.isfinite(want_s), np.take_along_axis(cat_i, order, 1), -1)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(scores, want_s)
    one_i, one_s = lists[1]
    fin = np.isfinite(one_s)
    assert (scores[fin] >= one_s[fin]).all()


def test_merge_orders_ties_as_jax_top_k(tmp_path):
    """Equal scores in two tiers (the same rows spilled twice under other
    ids): the earlier tier's entry comes first, as `lax.top_k` orders them."""
    conf = small_conf()
    x = unit(np.random.default_rng(0), 40, 8)
    s = store(tmp_path)
    tiered = TieredForest(conf, s)
    tiered.fit(DenseBatch(np.arange(40, dtype=np.int32), x))
    tiered.spill()
    tiered.fit(DenseBatch(np.arange(100, 140, dtype=np.int32), x))
    ids, scores = tiered.query(x[:6], steps=1)
    for row_i, row_s in zip(ids, scores):
        for j in range(len(row_s) - 1):
            if row_s[j] == row_s[j + 1] and row_i[j] >= 0:
                assert row_i[j] >= 100 and row_i[j + 1] < 100   # device tier first


def test_empty_tiered_query(tmp_path):
    ids, scores = TieredForest(small_conf(), store(tmp_path)).query(np.zeros((3, 8), np.float32))
    assert ids.shape == (3, 3) and (ids == -1).all() and np.isneginf(scores).all()


def _three_generations(tmp_path, **store_kw):
    conf = small_conf()
    x = unit(np.random.default_rng(3), 90, 8)
    s = store(tmp_path, **store_kw)
    tiered = TieredForest(conf, s)
    for g in range(3):
        tiered.fit(DenseBatch(np.arange(g * 30, (g + 1) * 30, dtype=np.int32),
                              x[g * 30:(g + 1) * 30]))
        tiered.spill()
    return x, s, tiered


def test_resident_generations_zero_disk_reads(tmp_path):
    x, s, tiered = _three_generations(tmp_path)
    ids1, _ = tiered.query(x[:8], steps=1)
    assert s.disk_loads == 3
    ids2, _ = tiered.query(x[:8], steps=1)
    assert s.disk_loads == 3
    np.testing.assert_array_equal(ids1, ids2)


def test_lru_eviction_respects_budget(tmp_path):
    x, s, tiered = _three_generations(tmp_path, cache_bytes=1)
    tiered.query(x[:8])
    assert len(s._cache) == 1
    tiered.query(x[:8])
    assert s.disk_loads >= 4


def test_auto_spill_on_ram_threshold(tmp_path):
    conf = small_conf(ram_threshold=1)
    x = np.random.default_rng(5).normal(size=(60, 8)).astype(np.float32)
    s = store(tmp_path)
    tiered = TieredForest(conf, s)
    tiered.fit(DenseBatch(np.arange(30, dtype=np.int32), x[:30]))
    assert tiered.device_tier is None and len(s.generations()) == 1
    tiered.add(DenseBatch(np.arange(30, 60, dtype=np.int32), x[30:]))
    assert tiered.device_tier is None and len(s.generations()) == 2
    np.testing.assert_array_equal(tiered.get(45), x[45])


def test_add_grows_device_tier(tmp_path):
    x = np.random.default_rng(6).normal(size=(40, 8)).astype(np.float32)
    s = store(tmp_path)
    tiered = TieredForest(small_conf(), s)
    tiered.fit(DenseBatch(np.arange(20, dtype=np.int32), x[:20]))
    tiered.add(DenseBatch(np.arange(20, 40, dtype=np.int32), x[20:]))
    assert tiered.device_tier.size() == 40 and not s.generations()
    assert tiered.device_bytes() == P.forest_state_bytes(tiered.device_tier.state)


def test_get_across_tiers(tmp_path):
    x = np.random.default_rng(0).normal(size=(60, 8)).astype(np.float32)
    s = store(tmp_path)
    tiered = TieredForest(small_conf(), s)
    tiered.fit(DenseBatch(np.arange(30, dtype=np.int32), x[:30]))
    tiered.spill()
    tiered.fit(DenseBatch(np.arange(30, 60, dtype=np.int32), x[30:]))
    np.testing.assert_array_equal(tiered.get(35), x[35])
    assert s.disk_loads == 0                      # a device-tier hit opens nothing
    np.testing.assert_array_equal(tiered.get(5), x[5])
    assert s.disk_loads == 1
    assert tiered.get(9999) is None and tiered.get(2**40) is None


def _gate_world(tmp_path, conf):
    rng = np.random.default_rng(7)
    qv = unit(rng, 1, 16)
    s = store(tmp_path)
    tiered = TieredForest(conf, s)
    xa = (qv + 0.05 * rng.normal(size=(40, 16))).astype(np.float32)
    tiered.fit(DenseBatch(np.arange(40, dtype=np.int32), xa))
    stem_a = tiered.spill()
    # only scaled negations of the query: with the angle family every hash
    # bit is complemented, so no probe can reach these buckets
    xb = (-qv * np.linspace(0.5, 2.0, 40)[:, None]).astype(np.float32)
    tiered.fit(DenseBatch(np.arange(100, 140, dtype=np.int32), xb))
    stem_b = tiered.spill()
    return qv, s, tiered, stem_a, stem_b


def _gate_conf(seed=21):
    return small_conf(vector_dim=16, family_size=20, partition_bits=0, seed=seed,
                      lsh_table=tcfg.TableConfig(chain_length=10, bucket_overflow=4),
                      query_batch_size=4, max_candidates=512)


def test_query_skips_non_matching_generation(tmp_path):
    qv, s, tiered, stem_a, stem_b = _gate_world(tmp_path, _gate_conf())
    ids, _ = tiered.query(qv, steps=0)
    assert stem_a in s._cache and stem_b not in s._cache and s.disk_loads == 1
    ids_b, _ = load_forest(stem_b, device="cpu").query(qv, steps=0)
    assert not np.intersect1d(ids[ids >= 0], ids_b[ids_b >= 0]).size


def test_gate_distrusts_foreign_model(tmp_path):
    qv, s, tiered, _, stem_b = _gate_world(tmp_path, _gate_conf())
    tiered.query(qv, steps=0)
    assert stem_b not in s._cache
    other = TieredForest(_gate_conf(seed=99), store(tmp_path))
    ids, _ = other.query(-qv, steps=1)
    assert stem_b in other.store._cache and (ids >= 100).any()


def test_keysummary_sidecar_roundtrip(tmp_path):
    x, s, tiered = _three_generations(tmp_path)
    stem = s.generations()[0]
    bk, bs, fp = s.key_summary(stem)
    f = load_forest(stem, device="cpu")
    assert bk.dtype == bs.dtype == np.uint32
    from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key
    np.testing.assert_array_equal(bk, from_key(f.state.tables.bucket_keys).numpy())
    np.testing.assert_array_equal(bs, f.state.tables.bucket_shifts.numpy())
    assert fp == P.model_fingerprint(f.state.model)
    os.remove(stem + "-keysummary.npz")
    s._key_summaries.clear()
    assert s.key_summary(stem) is None
    tiered.query(x[:4], steps=0)
    assert stem in s._cache                        # a missing sidecar might match


def test_eight_generations_merge_and_gate(tmp_path):
    """8 generations, one cluster each: the merged query finds neighbours
    in the right generation, the gate loads a strict subset, and the gated
    result equals the ungated one."""
    rng = np.random.default_rng(0)
    d, per_gen, n_gens = 16, 96, 8
    centers = unit(rng, n_gens, d)
    conf = small_conf(vector_dim=16, family_size=20, top_k=5, query_batch_size=16,
                      max_candidates=512,
                      lsh_table=tcfg.TableConfig(chain_length=24, bucket_overflow=16))
    s = store(tmp_path)
    tiered = TieredForest(conf, s)
    parts = []
    for g in range(n_gens):
        x = centers[g] + 0.03 * rng.normal(size=(per_gen, d))
        x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
        parts.append(x)
        tiered.fit(DenseBatch(np.arange(g * per_gen, (g + 1) * per_gen, dtype=np.int32), x))
        tiered.spill()
    assert len(s.generations()) == n_gens
    x_all = np.concatenate(parts)
    qv, qids = parts[5][:8], np.arange(5 * per_gen, 5 * per_gen + 8)
    ids, scores = tiered.query(qv, steps=1, query_ids=qids)
    gt = np.argsort(-(qv @ x_all.T), axis=1)
    hits = 0
    for i in range(8):
        want = [v for v in gt[i] if v != qids[i]][:5]
        hits += len(set(want) & set(int(v) for v in ids[i] if v >= 0))
        got = ids[i][ids[i] >= 0]
        assert ((got >= 5 * per_gen) & (got < 6 * per_gen)).all()
    assert hits / 40 >= 0.7
    assert s.disk_loads < n_gens
    orig = TieredForest._summary_matches
    try:
        TieredForest._summary_matches = staticmethod(lambda *a, **k: True)
        ids_u, scores_u = tiered.query(qv, steps=1, query_ids=qids)
    finally:
        TieredForest._summary_matches = staticmethod(orig)
    np.testing.assert_array_equal(ids, ids_u)
    np.testing.assert_array_equal(scores, scores_u)
    assert s.disk_loads == n_gens


def test_probe_uniques_hoist_matches_inline(tmp_path):
    x, s, tiered = _three_generations(tmp_path)
    keys, table_of = tiered._probe_keys_host(x[:8], steps=1)
    fp = P.model_fingerprint(tiered._prototype().model)
    uniques = TieredForest._probe_uniques(keys, table_of, 2)
    for stem in s.generations():
        summary = s.key_summary(stem)
        assert (TieredForest._summary_matches(summary, keys, table_of, fp)
                == TieredForest._summary_matches(summary, keys, table_of, fp,
                                                 probe_uniques=uniques))


def test_probe_keys_equal_jax(tmp_path):
    """The gate's probe keys (K1's plain version here) equal the JAX
    package's, key for key."""
    jc, tc = confs()
    jt = JP.TieredForest(jc, JP.GenerationStore(str(tmp_path), "j"))
    tt = TieredForest(tc, store(tmp_path, "p"))
    for steps in (0, 1):
        jk, jtab = jt._probe_keys_host(Q, steps)
        tk, ttab = tt._probe_keys_host(Q, steps)
        assert tk.dtype == np.uint32 and ttab.dtype == np.int32
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(ttab, np.asarray(jtab))


def test_two_spills_in_one_millisecond_keep_both(tmp_path, monkeypatch):
    """A frozen clock: the port names the second spill one millisecond
    later and keeps both generations, where the JAX package's second spill
    takes the same name and overwrites the first."""
    jc, tc = confs()
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    s = store(tmp_path, "p")
    tiered = TieredForest(tc, s)
    tiered.fit(DenseBatch(IDS[:700], X[:700]))
    first = tiered.spill()
    tiered.fit(DenseBatch(IDS[700:], X[700:]))
    second = tiered.spill()
    assert int(os.path.basename(second)) == int(os.path.basename(first)) + 1
    assert s.generations() == [first, second]
    assert s.summary(first).might_contain(IDS[:700].astype(np.uint32)).all()
    np.testing.assert_array_equal(tiered.get(5), X[5])
    np.testing.assert_array_equal(tiered.get(1000), X[1000])
    # the JAX package lists and loads both
    assert JP.GenerationStore(str(tmp_path), "p").generations() == [first, second]
    js = JP.GenerationStore(str(tmp_path), "j")
    jt = JP.TieredForest(jc, js)
    jt.fit(JBatch(IDS[:700], X[:700]))
    jt.spill()
    jt.fit(JBatch(IDS[700:], X[700:]))
    jt.spill()
    assert len(js.generations()) == 1           # the first generation was overwritten


def test_port_queries_a_jax_store(tmp_path):
    """A store directory written by the JAX package's TieredForest (three
    generations) queried by the port's: the same generations gated and
    loaded, and the same ids; and the other way round."""
    jc, tc = confs(coarse_dim=8, coarse_refine=256)
    for g, (c0, c1) in enumerate(((0, 500), (500, 1000), (1000, 1500))):
        jt = JP.TieredForest(jc, JP.GenerationStore(str(tmp_path), "j"))
        jt.fit(JBatch(IDS[c0:c1], X[c0:c1]))
        jt.spill()
        tt = TieredForest(tc, store(tmp_path, "p"))
        tt.fit(DenseBatch(IDS[c0:c1], X[c0:c1]))
        tt.spill()
        time.sleep(0.002)
    for name in ("j", "p"):
        js = JP.GenerationStore(str(tmp_path), name)
        ps = store(tmp_path, name)
        want = JP.TieredForest(jc, js).query(Q, steps=1, query_ids=QIDS)
        got = TieredForest(tc, ps).query(Q, steps=1, query_ids=QIDS)
        assert len(ps.generations()) == 3
        assert sorted(ps._cache) == sorted(js._cache)
        assert_same(got, want)
