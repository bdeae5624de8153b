"""Port vs JAX package: the clustered-flat (IVF) engine, on the CPU.

Tolerances:
  * integer outputs (the cluster permutation, the window flatten and budget,
    layouts built from one assignment) are compared bit for bit;
  * one Lloyd step from the same initial centroids: bf16 x bf16 products are
    exact in f32 on both sides and only the summation order differs, so
    assignments may flip on near ties (equal on >= 99.9% of rows); the
    port sums each cluster exactly where the reference rounds its f32 sums,
    so a new centroid entry may round to the neighbouring bf16 value (at
    most one bf16 step);
  * the head tier: sums of int8 values are exact in f32 on both sides, so
    the means agree bit for bit; head scores (bf16 products, f32 sums) may
    reorder near ties: the surviving windows are equal on >= 99% of rows;
  * end-to-end queries on the identical index (`from_jax_ivf`): ids equal on
    >= 99% of queries, scores within f32 summation order (rtol 1e-5); the
    port's own build against the JAX package's: recall@10 within 0.005.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu.ops import ivf as jivf
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import IVFFlatIndex, from_jax_ivf, tune_nprobe
from similaritysearchbyrdf_tpu_torch.ops import ivf as tivf
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search

from test_torch_forest import recall


def _data(n=3000, d=32, seed=0, n_clusters=40):
    """The corpus recipe of `tests/test_ivf.py`."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_clusters, n)] + 0.08 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _arrays(st):
    """A JAX IVFState's arrays for `from_jax_ivf`."""
    return {name: np.asarray(getattr(st, name))
            for name in ("sketch", "corpus", "row_ids", "centroids", "starts", "ends")}


def bf16_step(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.fixture(scope="module")
def world():
    x = _data(n=4000, d=48, seed=21)
    ids = np.arange(len(x), dtype=np.int32)
    kw = dict(target_cluster=64, iters=4, seed=0)
    jst = jivf.build_ivf(x, ids, **kw)
    gt, _ = exact_search(x, x[:64], 10, exclude_self=True, device="cpu")
    return {"x": x, "ids": ids, "kw": kw, "jst": jst, "gt": gt}


@pytest.mark.parametrize("masked", [False, True])
def test_one_lloyd_step_matches_jax(masked):
    x = _data(n=5000, seed=3)
    n, k = x.shape[0], 61
    rng = np.random.default_rng(k)
    valid = rng.random(n) > 0.2 if masked else np.ones(n, bool)
    init = rng.choice(np.flatnonzero(valid), size=k, replace=False)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jc, ja = jivf._kmeans_iter(xb, xb[jnp.asarray(init)], jnp.asarray(valid), 1000)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tc, ta = tivf._kmeans_iter(tx, tx[torch.as_tensor(init)], torch.from_numpy(valid))
    assert tc.dtype == torch.bfloat16 and ta.dtype == torch.int32
    ja = np.asarray(ja)
    np.testing.assert_array_equal(ta.numpy() < 0, ~valid)
    assert (ta.numpy() == ja).mean() >= 0.999
    want = np.asarray(jc, dtype=np.float32)
    got = tc.to(torch.float32).numpy()
    assert (np.abs(got - want) <= bf16_step(want)).all()


def test_kmeans_draws_the_reference_initial_rows():
    """`kmeans` starts from the bf16 rows of the reference's numpy draw
    among the valid rows, so two iterations on it still agrees with the
    reference's run as one step does."""
    x = _data(n=800, seed=4)
    valid = np.ones(800, bool)
    valid[::3] = False
    jc, ja = jivf.kmeans(jnp.asarray(x), jnp.asarray(valid), 24, iters=2, seed=9)
    tc, ta = tivf.kmeans(torch.from_numpy(x), torch.from_numpy(valid), 24, iters=2, seed=9)
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.999
    want = np.asarray(jc, dtype=np.float32)
    assert (np.abs(tc.to(torch.float32).numpy() - want) <= bf16_step(want)).all()


def test_cluster_sums_are_exact_and_order_free():
    """The k-means update's sums: equal to float64 sums of the bf16 rows,
    and bit-identical whatever the order of the rows."""
    x = torch.from_numpy(_data(n=3000, seed=5)).to(torch.bfloat16)
    assign = torch.from_numpy(np.random.default_rng(5).integers(-1, 17, 3000)).to(torch.int32)
    sums, counts = tivf._cluster_sums(x, assign, 17)
    live = assign >= 0
    want = torch.zeros(17, x.shape[1], dtype=torch.float64).index_add_(
        0, assign[live].long(), x[live].double())
    assert torch.allclose(sums, want, rtol=0, atol=1e-12)
    assert torch.equal(counts, torch.bincount(assign[live].long(), minlength=17))
    perm = torch.from_numpy(np.random.default_rng(6).permutation(3000))
    sums2, _ = tivf._cluster_sums(x[perm], assign[perm], 17)
    assert torch.equal(sums, sums2)


@pytest.mark.parametrize("k", [7, 50])
def test_cluster_perm_bit_equal(k):
    rng = np.random.default_rng(k)
    assign = rng.integers(0, k, size=1200).astype(np.int32)
    assign[assign == 3] = 4                        # an empty cluster
    for g, w in zip(tivf._cluster_perm(assign, k), jivf._cluster_perm(assign, k)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shards", [0, 3])
def test_window_budget_bit_equal(shards):
    rng = np.random.default_rng(shards)
    shape = (shards, 41) if shards else (41,)
    counts = rng.integers(0, 300, size=shape[:-1] + (40,))
    starts = np.zeros(shape, np.int64)
    starts[..., 1:] = np.cumsum((counts + 7) // 8 * 8, axis=-1)
    ends = starts[..., :-1] + counts
    for nprobe, win in ((1, 64), (4, 16), (8, 256), (40, 8)):
        assert (tivf.ivf_window_budget(starts, ends, nprobe, win)
                == jivf.ivf_window_budget(starts, ends, nprobe, win))
    assert tivf.ivf_window_budget(torch.from_numpy(starts), torch.from_numpy(ends), 4, 16) == \
        jivf.ivf_window_budget(starts, ends, 4, 16)


@pytest.mark.parametrize("win,wb", [(16, 40), (64, 12)])
def test_flatten_windows_bit_equal(win, wb):
    rng = np.random.default_rng(win)
    b, p = 6, 5
    sel_start = (rng.integers(0, 500, size=(b, p)) * 8).astype(np.int32)
    sel_end = (sel_start + rng.integers(0, 150, size=(b, p))).astype(np.int32)
    want = jivf._flatten_windows(jnp.asarray(sel_start), jnp.asarray(sel_end), win, wb)
    got = tivf._flatten_windows(torch.from_numpy(sel_start), torch.from_numpy(sel_end), win, wb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].float().mean() < 1       # a budget that is met, and one that truncates


def test_build_ivf_heads_bit_equal(world):
    jst = world["jst"]
    want = np.asarray(jivf.build_ivf_heads(jst.sketch, jst.row_ids, 16), dtype=np.float32)
    dp = -(-48 // 32) * 32
    got = tivf.build_ivf_heads(torch.from_numpy(np.array(jst.sketch)[:, :dp]),
                               torch.from_numpy(np.array(jst.row_ids)), 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want[:, :dp])


@pytest.mark.parametrize("keep", [6, 20])
def test_prune_windows_match_jax(keep):
    rng = np.random.default_rng(keep)
    b, wbf, win, hp, h, dp = 64, 32, 64, 16, 200, 32
    heads = jnp.asarray(rng.normal(size=(h, dp))).astype(jnp.bfloat16)
    qb = jnp.asarray(rng.normal(size=(b, dp))).astype(jnp.bfloat16)
    blk = (np.sort(rng.integers(0, (h * hp - 2 * win) // 8, size=(b, wbf)), axis=1) * 8)
    end_b = blk + rng.integers(1, 2 * win, size=(b, wbf))
    live = rng.random((b, wbf)) > 0.15
    want = jivf._ivf_prune_windows(heads, hp, qb, jnp.asarray(blk.astype(np.int32)),
                                   jnp.asarray(end_b.astype(np.int32)), jnp.asarray(live),
                                   win, keep)
    got = tivf._ivf_prune_windows(
        torch.from_numpy(np.asarray(heads, dtype=np.float32)).to(torch.bfloat16), hp,
        torch.from_numpy(np.asarray(qb, dtype=np.float32)).to(torch.bfloat16),
        torch.from_numpy(blk), torch.from_numpy(end_b), torch.from_numpy(live), win, keep)
    same = np.ones(b, bool)
    for g, w in zip(got, want):
        same &= (g.numpy() == np.asarray(w)).all(axis=1)
    assert same.mean() >= 0.99
    assert (np.diff(got[0].numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("train_sample", [None, 1500])
def test_build_ivf_matches_jax(world, train_sample):
    """The layout invariants of `tests/test_ivf.py`, and recall within 0.005
    of the JAX package's own build at a partial probe."""
    x, ids, gt = world["x"], world["ids"], world["gt"]
    kw = dict(world["kw"], train_sample=train_sample)
    st = tivf.build_ivf(torch.from_numpy(x), ids, **kw)
    starts, rid = st.starts.numpy(), st.row_ids.numpy()
    assert (starts % 8 == 0).all() and starts[-1] == rid.shape[0]
    live = rid >= 0
    assert live.sum() == len(x) and len(set(rid[live].tolist())) == len(x)
    np.testing.assert_array_equal(st.corpus.numpy()[live, :48], x[rid[live]])
    assert st.sketch.dtype == torch.int8 and st.sketch.shape[1] == 64
    assert (st.ends.numpy() - starts[:-1] <= np.diff(starts)).all()
    jst = world["jst"] if train_sample is None else jivf.build_ivf(x, ids, **kw)
    qkw = dict(k=10, nprobe=4, win=64, refine=128)
    wb = jivf.ivf_window_budget(jst.starts, jst.ends, 4, 64)
    want, _ = jivf.ivf_topk(jst.sketch, jst.corpus, jst.row_ids, jst.centroids, jst.starts,
                            jst.ends, jnp.asarray(x[:64]), jnp.arange(64, dtype=jnp.int32),
                            wb=wb, **qkw)
    got, _ = tivf.ivf_topk(st.sketch, st.corpus, st.row_ids, st.centroids, st.starts,
                           st.ends, torch.from_numpy(x[:64]), torch.arange(64, dtype=torch.int32),
                           wb=tivf.ivf_window_budget(st.starts, st.ends, 4, 64), **qkw)
    assert abs(recall(gt, got.numpy()) - recall(gt, np.asarray(want))) <= 0.005
    assert recall(gt, np.asarray(want)) > 0.9


@pytest.mark.parametrize("point", ["single", "two_phase", "short_sketch"])
def test_ivf_topk_through_from_jax_ivf(world, point):
    """`IVFFlatIndex` on the JAX package's index carried across: a
    single-phase point, a two-phase point (head tier, keep < wb), and a
    sketch shorter than one window (padded with zero rows before K2b)."""
    x, ids = world["x"], world["ids"]
    ikw = {"single": dict(nprobe=4, win=64, refine=128),
           "two_phase": dict(nprobe=8, win=64, refine=128, head_pool=16, keep=8),
           "short_sketch": dict(nprobe=4, win=256, refine=64)}[point]
    if point == "short_sketch":
        x, ids = x[:60], ids[:60]
        jidx = jivf.IVFFlatIndex(target_cluster=16, iters=3, **ikw).fit(JBatch(ids, x))
    else:
        jidx = jivf.IVFFlatIndex(**world["kw"], **ikw)
        jidx.state = world["jst"]
        jidx.ensure_heads()
    port = from_jax_ivf(_arrays(jidx.state), x.shape[1], device="cpu", **ikw)
    assert port.state.sketch.shape[1] == -(-x.shape[1] // 32) * 32
    if point == "two_phase":
        assert port.state.heads is not None
        assert ikw["keep"] < tivf.ivf_window_budget(port.state.starts, port.state.ends, 8, 64)
    else:
        assert port.state.sketch.shape[0] < ikw["win"] or point == "single"
    q = x[:48]
    want, want_s = jidx.query(q, k=10, query_ids=ids[:48])
    got, got_s = port.query(q, k=10, query_ids=ids[:48])
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16"])
def test_build_ivf_streamed_matches_build_ivf(corpus_dtype):
    """The host-streamed build lays the corpus out as `build_ivf` with the
    same sampled Lloyd does: the same clusters, ids and sketch, the exact
    tier in `corpus_dtype`, and dead rows past the last cluster."""
    x = _data(n=3000, d=40, seed=4)
    ids = np.arange(3000, dtype=np.int32)
    kw = dict(target_cluster=64, iters=3, seed=0)
    ref = tivf.build_ivf(torch.from_numpy(x), ids, train_sample=2000, **kw)
    st = tivf.build_ivf_streamed(x, ids, train_sample=2000, chunk_rows=1024,
                                 corpus_dtype=corpus_dtype, device="cpu", **kw)
    n_total = ref.row_ids.shape[0]
    assert st.row_ids.shape[0] % 1024 == 0 and st.row_ids.shape[0] >= n_total
    assert (st.row_ids[n_total:] == -1).all()
    for name in ("starts", "ends", "centroids"):
        assert torch.equal(getattr(st, name), getattr(ref, name)), name
    assert torch.equal(st.row_ids[:n_total], ref.row_ids)
    assert torch.equal(st.sketch[:n_total], ref.sketch)
    want = ref.corpus.to(torch.bfloat16 if corpus_dtype == "bfloat16" else torch.float32)
    assert st.corpus.dtype == want.dtype and torch.equal(st.corpus[:n_total], want)
    idx = IVFFlatIndex(nprobe=4, win=64, device="cpu")
    idx.state = st
    got, _ = idx.query(x[:32], k=10, query_ids=ids[:32])
    gt, _ = exact_search(x, x[:32], 10, exclude_self=True, device="cpu")
    assert recall(gt, got) > 0.9


def test_tune_nprobe_matches_jax(world):
    x, ids = world["x"], world["ids"]
    jidx = jivf.IVFFlatIndex(nprobe=1, refine=128, win=64)
    jidx.state = world["jst"]
    port = from_jax_ivf(_arrays(world["jst"]), x.shape[1], device="cpu", nprobe=1,
                        refine=128, win=64)
    for target in (0.9, 0.99):
        want = jivf.tune_nprobe(jidx, x[:32], target_recall=target, k=5)
        assert tune_nprobe(port, x[:32], target_recall=target, k=5) == want
        assert port.nprobe == want


def test_ivf_index_needs_cuda_or_the_cpu(monkeypatch):
    """With no device named the index lives on the first CUDA card, and
    raises without one; an unfitted index answers -1 ids."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFFlatIndex()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_ivf({}, 16)
    ids, scores = IVFFlatIndex(device="cpu").query(np.zeros((2, 8), np.float32), k=3)
    assert ids.shape == (2, 3) and (ids == -1).all() and np.isneginf(scores).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert IVFFlatIndex().device == torch.device("cuda", 0)


def test_ivf_index_fit_on_cpu_recall(world):
    """The port's own `IVFFlatIndex` end to end at full probe: recall of
    exact search bound only by the int8 sketch (`tests/test_ivf.py`)."""
    x, ids, gt = world["x"], world["ids"], world["gt"]
    idx = IVFFlatIndex(target_cluster=64, iters=4, win=64, refine=256, device="cpu").fit(
        TBatch(ids, x))
    kc = idx.state.centroids.shape[0]
    got, scores = idx.query(x[:64], k=10, query_ids=ids[:64], nprobe=kc)
    assert recall(gt, got) >= 0.97
    assert all(i not in set(got[i].tolist()) for i in range(64))
