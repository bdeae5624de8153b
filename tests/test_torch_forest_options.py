"""Port vs JAX package: the forest's last three options, the PCA coarse
basis (`coarse_proj_mode="pca"`), the bf16 coarse tier
(`coarse_dtype="bfloat16"`) and the bf16 two-stage rerank
(`rerank_dtype="bfloat16"`).

Tolerances:
  * the PCA basis: both sides form the second moment in f32 (in another
    summation order) and decompose it in float64 on the host, so on a corpus
    whose leading eigenvalues are apart by more than 1% the bases agree to
    1e-4 per entry, with equal signs;
  * a bf16 tier: the f32 projection is summed in another order, so an entry
    may round to the neighbouring bf16 value (at most one bf16 step, on
    under 1% of entries, plus, on a PCA basis, twice what the two bases'
    difference moves the value, |x| . |basis difference|); the head tier
    over one tier sums its bf16 values in f32 in another order, within one
    bf16 step of its value;
  * queries on the identical index differ only by float summation order:
    ids equal on >= 99% of queries, recall@10 within 0.005; the final
    scores are full f32 re-scores on both sides (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import forest as jforest
from similaritysearchbyrdf_tpu.ops import rerank as jrerank
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import from_jax_state
from similaritysearchbyrdf_tpu_torch.index import forest as tforest
from similaritysearchbyrdf_tpu_torch.interop import unpack_lane_tier
from similaritysearchbyrdf_tpu_torch.ops import rerank as trerank
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search

from test_torch_forest import jax_state_arrays, recall

N, D, NQ, K, CD, HP = 6000, 32, 64, 10, 16, 16


def anisotropic(n, d, seed, n_clusters=80):
    """Clustered unit rows whose second moment has well-separated leading
    eigenvalues: cluster centres scaled by 0.85^i along the axes of a
    random rotation."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = 0.85 ** np.arange(d)
    centers = (rng.normal(size=(n_clusters, d)) * scales) @ q.T
    x = centers[rng.integers(0, n_clusters, n)] + 0.02 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def confs(**kw):
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=4096, top_k=K,
                seed=53, use_pallas_hash=True, coarse_dim=CD, coarse_refine=256,
                coarse_head_pool=HP)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)))


def spectral_gap(x, cd):
    """The smallest relative gap between consecutive leading eigenvalues of
    the uncentered second moment (the top cd + 1)."""
    w = np.sort(np.linalg.eigvalsh(x.astype(np.float64).T @ x))[::-1][:cd + 1]
    return float(np.min(-np.diff(w) / w[:-1]))


@pytest.fixture(scope="module")
def world():
    x = anisotropic(N, D, seed=8)
    assert spectral_gap(x, CD) > 0.01
    ids = np.arange(N, dtype=np.int32)
    gt, _ = exact_search(x, x[:NQ], K, exclude_self=True, device="cpu")
    jc, tc = confs(coarse_dtype="bfloat16")
    jf = jforest.RDFForest(jc).fit(JBatch(ids, x))
    port = tforest.RDFForest(tc, device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    return {"x": x, "ids": ids, "gt": gt, "jf": jf, "port": port, "tc": tc}


def bf16_step(v):
    """One bf16 step (8 significant bits) at the magnitude of v."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("n,d,cd", [(3000, 24, 8), (300_000, 16, 12)])
def test_pca_projection_matches_jax(n, d, cd):
    """The PCA basis from the row-padded corpus, the strided sample (stride
    2 at 300k rows) included, with the reference's sign convention."""
    x = anisotropic(n, d, seed=n)
    assert spectral_gap(x[::max(1, n // 131072)], cd) > 0.01
    want = jforest._coarse_projection(jnp.asarray(x), d, cd, seed=5, mode="pca")
    got = tforest._coarse_projection(torch.from_numpy(x), cd, seed=5, mode="pca")
    assert got.dtype == np.float32 and got.shape == (d, cd)
    np.testing.assert_allclose(got, want, atol=1e-4)
    cols = np.arange(cd)
    lead = np.argmax(np.abs(want), axis=0)
    assert (np.sign(got[lead, cols]) == np.sign(want[lead, cols])).all()
    assert (want[lead, cols] > 0).all()


@pytest.mark.parametrize("proj_mode", ["random", "pca"])
def test_bf16_tier_matches_jax(proj_mode):
    """`_build_coarse_tier` with coarse_dtype "bfloat16": the projection
    rounded to bf16, no scale, per table against the JAX package's unpacked
    lane tier; its head tier within one bf16 step."""
    rng = np.random.default_rng(11)
    l, n, cap = 5, 900, 1000
    x = anisotropic(n, D, seed=12)
    si = np.stack([np.where(np.arange(cap) < n, rng.permutation(cap), -1)
                   for _ in range(l)]).astype(np.int32)
    si = np.where(si < n, si, -1).astype(np.int32)
    jproj, packed = jforest._build_coarse_tier(jnp.asarray(x), jnp.asarray(si), CD,
                                               "bfloat16", seed=3, proj_mode=proj_mode)
    assert packed.dtype == jnp.bfloat16
    tproj, tier = tforest._build_coarse_tier(torch.from_numpy(x), torch.from_numpy(si), CD,
                                             "bfloat16", seed=3, proj_mode=proj_mode)
    assert tier.dtype == torch.bfloat16 and tier.shape == (l, cap, CD)
    dproj = np.abs(tproj.numpy() - np.asarray(jproj))
    assert dproj.max() <= 1e-4
    want = unpack_lane_tier(np.asarray(packed, dtype=np.float32), l, CD)
    got = tier.to(torch.float32).numpy()
    # one bf16 step, plus what the two bases' own difference moves a value
    # (|x| . |basis difference|; 0 for the random basis, which is equal)
    moved = (np.abs(x) @ dproj)[np.maximum(si, 0)] * (si >= 0)[..., None]
    diff = np.abs(got - want)
    assert (diff <= bf16_step(want) + 2 * moved).all() and (diff > 0).mean() < 0.01
    assert (got[si < 0] == 0).all()
    g = 128 // CD
    jhead = jforest.build_head_tier(packed, jnp.asarray(si), HP, groups=g)
    whead = unpack_lane_tier(np.asarray(jhead, dtype=np.float32), l, CD)
    ghead = tforest.build_head_tier(torch.from_numpy(want).to(torch.bfloat16),
                                    torch.from_numpy(si), HP).to(torch.float32).numpy()
    assert (np.abs(ghead - whead) <= bf16_step(whead) + 1e-30).all()


def test_bf16_tier_through_from_jax_state(world):
    """A bf16 lane-packed tier carried across is the port's per-table bf16
    tier, value for value."""
    jf, port = world["jf"], world["port"]
    st = port.state
    assert st.coarse_tier.dtype == torch.bfloat16
    want = unpack_lane_tier(np.asarray(jf.state.coarse_by_table, dtype=np.float32),
                            st.tables.num_tables, CD)
    np.testing.assert_array_equal(st.coarse_tier.to(torch.float32).numpy(), want)


@pytest.mark.parametrize("mode", ["block", "window", "window_pruned"])
def test_bf16_tier_query_matches_jax(world, mode):
    """Block mode (K2's plain version), window mode (K2b's) and window mode
    with pruning over a bf16 tier, on the identical index."""
    jf, port, x, ids, gt = (world[k] for k in ("jf", "port", "x", "ids", "gt"))
    kw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16)
    if mode != "block":
        kw.update(m_cap=8192, coarse_window=64, window_keep=32 if mode == "window_pruned" else 0)
    want, want_s = jf.query(x[:NQ], **kw)
    got, got_s = port.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5


@pytest.mark.parametrize("dup_bound,refine", [(1, 128), (4, 16)])
def test_rerank_two_stage_matches_jax(dup_bound, refine):
    """`rerank_dense_two_stage` on random inputs: candidates with -1 gaps and
    ids repeated up to `dup_bound` times."""
    rng = np.random.default_rng(refine)
    n, d, b, m, k = 500, 40, 128, 96, 10
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.integers(0, n, size=(b, m // dup_bound))
    cand = np.tile(cand, (1, dup_bound))[:, rng.permutation(m)]
    cand = np.where(rng.random((b, m)) < 0.1, -1, cand).astype(np.int32)
    corpus_lp = jnp.asarray(corpus).astype(jnp.bfloat16)
    want, want_s = jrerank.rerank_dense_two_stage(
        corpus_lp, jnp.asarray(corpus), jnp.asarray(cand), jnp.asarray(queries), k,
        dup_bound=dup_bound, refine=refine)
    got, got_s = trerank.rerank_dense_two_stage(
        torch.from_numpy(corpus).to(torch.bfloat16), torch.from_numpy(corpus),
        torch.from_numpy(cand), torch.from_numpy(queries), k, dup_bound=dup_bound,
        refine=refine)
    want, want_s = np.asarray(want), np.asarray(want_s)
    assert (got.numpy() == want).all(axis=1).mean() >= 0.99
    same = (got.numpy() == want).all(axis=1)
    np.testing.assert_allclose(got_s.numpy()[same], want_s[same], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["lane", "folded"])
def test_three_options_through_rdfforest(world, layout):
    """The port's own fit and query with the PCA basis and the bf16 rerank
    (and a bf16 tier in the lane layout; the folded tier stays int8) against
    the JAX package's own, each fitting its own basis."""
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(coarse_proj_mode="pca", rerank_dtype="bfloat16", coarse_layout=layout,
              coarse_dtype="bfloat16" if layout == "lane" else "int8")
    jc, tc = confs(**kw)
    jf = jforest.RDFForest(jc).fit(JBatch(ids, x))
    tf = tforest.RDFForest(tc, device="cpu").fit(TBatch(ids, x))
    np.testing.assert_allclose(tf.state.coarse_proj.numpy(), np.asarray(jf.state.coarse_proj),
                               atol=1e-4)
    assert tf.state.corpus_lp is not None
    qkw = dict(query_ids=ids[:NQ], probe_mode="margin", probe_budget=16)
    if layout == "folded":
        qkw.update(rows_keep=0, coarse_window=256, coarse_refine=512)
    want, _ = jf.query(x[:NQ], **qkw)
    got, _ = tf.query(x[:NQ], **qkw)
    assert (got == want).all(axis=1).mean() >= 0.99
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5


def test_folded_bf16_tier_is_refused(world):
    _, tc = confs(coarse_dtype="bfloat16", coarse_layout="folded")
    with pytest.raises(ValueError, match="int8"):
        tforest.fit_dense(tc, TBatch(world["ids"][:500], world["x"][:500]), device="cpu")


def test_state_to_moves_every_tensor(world):
    """`ForestState.to` moves every tensor of the state, its model's and its
    tables' too (here to the meta device), and changes nothing else."""
    import dataclasses

    st = world["port"].state

    def leaves(v):
        if isinstance(v, torch.Tensor):
            return [v]
        if dataclasses.is_dataclass(v):
            return [t for f in dataclasses.fields(v) for t in leaves(getattr(v, f.name))]
        return []

    moved = st.to("meta")
    before, after = leaves(st), leaves(moved)
    assert len(after) == len(before) >= 10
    assert all(t.device.type == "meta" for t in after)
    assert all(t.device.type == "cpu" for t in before)
    assert [(t.shape, t.dtype) for t in after] == [(t.shape, t.dtype) for t in before]
    assert moved.coarse_layout == st.coarse_layout
    assert dataclasses.replace(moved.model, proj=None, perm=None, b=None,
                               sampling_perm=None) == dataclasses.replace(
        st.model, proj=None, perm=None, b=None, sampling_perm=None)
