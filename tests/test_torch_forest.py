"""Port vs JAX package on a small dense forest: fit arrays, candidate
blocks, and end-to-end queries (block mode, coarse tier and plain path,
margin and reference probes).

Queries run on the identical index (`from_jax_state`), so what differs is
only float summation order: top-k ids must be equal on >= 99% of queries
and recall@10 within 0.005."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import forest as jforest
from similaritysearchbyrdf_tpu.ops.hashing import hash_dense_with_margins as j_hash_margins
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import from_jax_state
from similaritysearchbyrdf_tpu_torch.index import forest as tforest
from similaritysearchbyrdf_tpu_torch.interop import unpack_lane_tier
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search

N, D, NQ, K = 4000, 32, 64, 10


def confs(coarse: bool):
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=4096, top_k=K,
                seed=77, use_pallas_hash=True)
    if coarse:
        base.update(coarse_dim=16, coarse_dtype="int8", coarse_refine=64)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=48)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=48)))


def corpus():
    rng = np.random.default_rng(2024)
    centers = rng.normal(size=(96, D))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 96, N)] + 0.08 * rng.normal(size=(N, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def jax_state_arrays(state):
    """A JAX ForestState's fields as numpy arrays, keyed for from_jax_state."""
    t = state.tables
    out = {"model.proj": state.model.proj, "model.perm": state.model.perm,
           "model.b": state.model.b, "model.sampling_perm": state.model.sampling_perm,
           "part_proj": state.part_proj, "tables.sorted_keys": t.sorted_keys,
           "tables.sorted_ids": t.sorted_ids, "tables.bucket_keys": t.bucket_keys,
           "tables.bucket_starts": t.bucket_starts, "tables.bucket_shifts": t.bucket_shifts,
           "corpus": state.corpus, "row_ids": state.row_ids}
    if state.coarse_by_table is not None:
        out.update({"coarse_proj": state.coarse_proj, "coarse_by_table": state.coarse_by_table})
    if state.coarse_head is not None:
        # numpy has no bf16: widen to f32, which is exact
        out["coarse_head"] = np.asarray(state.coarse_head, dtype=np.float32)
    if state.coarse_folded is not None:
        out.update({"coarse_proj": state.coarse_proj, "coarse_folded": state.coarse_folded})
    if state.corpus_lp is not None:                 # bf16: widened to f32, as above
        out["corpus_lp"] = np.asarray(state.corpus_lp, dtype=np.float32)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def world():
    x = corpus()
    ids = np.arange(N, dtype=np.int32)
    gt, _ = exact_search(x, x[:NQ], K, exclude_self=True, device="cpu")
    out = {"x": x, "ids": ids, "gt": gt}
    for coarse in (True, False):
        jc, tc = confs(coarse)
        jf = jforest.RDFForest(jc).fit(JBatch(ids, x))
        tf = tforest.RDFForest(tc, device="cpu").fit(TBatch(ids, x))
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
    np.testing.assert_array_equal(ts.corpus.numpy(), np.asarray(js.corpus)[:, :D])
    assert tf.index_bytes_per_vector() == jf.index_bytes_per_vector()
    if coarse:
        np.testing.assert_array_equal(ts.coarse_proj.numpy(), np.asarray(js.coarse_proj))
        want = unpack_lane_tier(np.asarray(js.coarse_by_table), ts.tables.num_tables,
                                ts.coarse_proj.shape[1])
        diff = np.abs(ts.coarse_tier.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3       # .5 quantization ties
    else:
        assert ts.coarse_tier is None and js.coarse_by_table is None


@pytest.fixture(scope="module")
def bf16_rerank_world(world):
    """The JAX package's forests of `world` fitted again with
    rerank_dtype="bfloat16", so they carry `corpus_lp`."""
    x, ids = world["x"], world["ids"]
    return {coarse: jforest.RDFForest(world[coarse][0].replace(rerank_dtype="bfloat16")).fit(
        JBatch(ids, x)) for coarse in (True, False)}


@pytest.mark.parametrize("port_rerank", ["bfloat16", "float32"])
@pytest.mark.parametrize("coarse", [True, False])
def test_from_jax_state_carries_a_bf16_rerank_state(world, bf16_rerank_world, coarse,
                                                    port_rerank):
    """A JAX state fitted with rerank_dtype="bfloat16" carries `corpus_lp`,
    and the port reranks it in two stages as the JAX package does, whatever
    the port's config says (the option acts at the fit): top-k ids equal on
    >= 99% of queries, recall within 0.005, scores within the exact
    rerank's f32 bound (the final re-score is full f32 on both sides)."""
    _, tc, _, _ = world[coarse]
    jf = bf16_rerank_world[coarse]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    arrays = jax_state_arrays(jf.state)
    assert "corpus_lp" in arrays
    port = tforest.RDFForest(tc.replace(rerank_dtype=port_rerank), device="cpu")
    port.state = from_jax_state(arrays, port.conf, device="cpu")
    assert port.state.corpus_lp.dtype == torch.bfloat16
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16)
    want, want_s = jf.query(x[:NQ], **kw)
    got, got_s = port.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5


@pytest.mark.parametrize("coarse", [True, False])
def test_from_jax_state_gives_the_ports_own_fit(world, coarse):
    jc, tc, jf, tf = world[coarse]
    conv = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    own = tf.state
    for name in ("sorted_keys", "sorted_ids", "bucket_keys", "bucket_starts",
                 "bucket_shifts", "records"):
        assert torch.equal(getattr(conv.tables, name), getattr(own.tables, name)), name
    for name in ("part_proj", "corpus", "row_ids"):
        assert torch.equal(getattr(conv, name), getattr(own, name)), name
    for name in ("proj", "perm", "b", "sampling_perm"):
        assert torch.equal(getattr(conv.model, name), getattr(own.model, name)), name
    assert conv.model.family == own.model.family
    assert (conv.coarse_tier is None) == (own.coarse_tier is None)


@pytest.mark.parametrize("probe_mode,steps", [("margin", 0), ("reference", 1)])
def test_gather_blocks_match_jax(world, probe_mode, steps):
    jc, tc, jf, tf = world[True]
    js = jf.state
    q = jnp.asarray(world["x"][:NQ])
    probes = pvalid = None
    if probe_mode == "margin":
        h, margins = j_hash_margins(js.model, q)
        probes, pvalid = jforest._probe_hashes_margin(h, margins, jf.layout, 16)
    else:
        h = jforest.hash_dense(js.model, q)
    home = jforest.partition_of_hash(h, js.part_proj)
    want = jforest.gather_blocks(js.tables, h, home, jf.layout, steps, 4096, True,
                                 probes=probes, probe_valid=pvalid)
    base, table, _, end, total, bs = (None if a is None else np.asarray(a) for a in want)
    conv = from_jax_state(jax_state_arrays(js), tc, device="cpu")

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a).astype(np.int64))

    got = tforest.gather_blocks(conv.tables, t(h), t(home), tf.layout, steps, 4096, True,
                                t(probes), None if pvalid is None else torch.tensor(
                                    np.asarray(pvalid)))
    assert got[5] == bs == 8 and got[2] is None and want[2] is None
    for g, w in zip(got[:2] + got[3:5], (base, table, end, total)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (total > 0).all()


@pytest.mark.parametrize("coarse,probe_mode,steps", [
    (True, "margin", 0), (True, "reference", 1), (False, "reference", 0),
    (False, "margin", 1)])
def test_query_matches_jax(world, coarse, probe_mode, steps):
    jc, tc, jf, tf = world[coarse]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(steps=steps, query_ids=ids[:NQ], probe_mode=probe_mode, probe_budget=16)
    want, want_s = jf.query(x[:NQ], **kw)
    port = tforest.RDFForest(tc, device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    got, got_s = port.query(x[:NQ], **kw)
    assert got.shape == want.shape == (NQ, K)
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5


def test_own_fit_recall_matches_jax(world):
    """The port's own fit and query (no state carried over) against the JAX
    package's, at the coarse block-mode path with margin probes."""
    jc, tc, jf, tf = world[True]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16)
    want, _ = jf.query(x[:NQ], **kw)
    got, _ = tf.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005


def test_similarity_threshold_matches_jax(world):
    """The exact-score post-filter (`similarity_threshold`) drops the same
    results in both packages."""
    jc, tc, jf, _ = world[False]
    x, ids = world["x"], world["ids"]
    jf_thr = jforest.RDFForest(jc.replace(similarity_threshold=0.8))
    jf_thr.state = jf.state
    want, want_s = jf_thr.query(x[:NQ], query_ids=ids[:NQ])
    port = tforest.RDFForest(tc.replace(similarity_threshold=0.8), device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    got, got_s = port.query(x[:NQ], query_ids=ids[:NQ])
    assert 0 < (want < 0).mean() < 1
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_array_equal(np.isinf(got_s), np.isinf(want_s))


def test_own_bf16_rerank_fit_matches_jax(world, bf16_rerank_world):
    """The port's own fit with rerank_dtype="bfloat16" makes the JAX
    package's `corpus_lp` bit for bit (the corpus rounded to bf16, without
    the 128-lane padding), and its queries answer as the JAX package's."""
    jc, tc, _, _ = world[True]
    jf = bf16_rerank_world[True]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    tf = tforest.RDFForest(tc.replace(rerank_dtype="bfloat16"), device="cpu").fit(
        TBatch(ids, x))
    want_lp = np.asarray(jf.state.corpus_lp, dtype=np.float32)[:, :D]
    np.testing.assert_array_equal(tf.state.corpus_lp.to(torch.float32).numpy(), want_lp)
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16)
    want, _ = jf.query(x[:NQ], **kw)
    got, _ = tf.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005


def test_window_mode_matches_jax(world):
    """m_cap 32768 turns window mode on (64-slot windows) in both packages;
    the port's own fit queries like the JAX package's."""
    jc, tc, jf, tf = world[True]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16, m_cap=32768)
    want, _ = jf.query(x[:NQ], **kw)
    got, _ = tf.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5


def test_folded_fit_matches_jax(world):
    """A folded fit runs in both packages, and the port's own folded fit
    queries like the JAX package's."""
    jc, tc, _, _ = world[True]
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16, rows_keep=0,
              coarse_window=256, coarse_refine=512)
    jf = jforest.RDFForest(jc.replace(coarse_layout="folded")).fit(JBatch(ids, x))
    tf = tforest.RDFForest(tc.replace(coarse_layout="folded"), device="cpu").fit(TBatch(ids, x))
    assert tf.state.coarse_folded is not None
    want, _ = jf.query(x[:NQ], **kw)
    got, _ = tf.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5
