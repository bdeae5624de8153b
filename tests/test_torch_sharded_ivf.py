"""Port vs JAX package on the sharded IVF engine: one corpus fitted by the
JAX package on its 8 virtual CPU devices and by the port on
`make_forest_mesh(devices=["cpu"] * n)`, 8 and 4 shards.

k-means: the port adds exact int64 sums, the JAX package f32 sums of bf16
products merged by `psum`, so a centroid entry may sit one bf16 step away;
here every entry is within one bf16 ulp, and at most 0.5% of them differ
(none on these corpora, where the sums round alike). Full-probe ids, where
the answer does not depend on the layout, must be equal on every query;
ids at small nprobe and under window pruning equal while the centroids are
(these corpora). Also: the layout invariants, `tune_nprobe` on the sharded
index, shards with no rows, ids from a 100M id space, negative ids (both
packages' results stated), `interop.from_jax_sharded_ivf`, and
`save_sharded_ivf` / `load_sharded_ivf` both ways.
"""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu as J
from similaritysearchbyrdf_tpu.parallel import sharded_ivf as JI
from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh as jax_mesh
from similaritysearchbyrdf_tpu_torch import (DenseBatch, exact_search, load_sharded_ivf,
                                             save_sharded_ivf, tune_nprobe)
from similaritysearchbyrdf_tpu_torch.interop import from_jax_sharded_ivf
from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as TI
from similaritysearchbyrdf_tpu_torch.parallel.mesh import SHARD_AXIS, make_forest_mesh

D = 32
SCORE_TOL = D * 2.0 ** -22


def _data(n=3000, seed=0, n_clusters=40):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, D))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_clusters, n)] + 0.1 * rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mesh(s):
    return make_forest_mesh(devices=["cpu"] * s)


def _same(ji, js, ti, ts):
    ji, js = np.asarray(ji), np.asarray(js)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    assert (fin == np.isfinite(ts)).all() and (np.abs(js[fin] - ts[fin]) <= SCORE_TOL).all()


def _pair(x, ids, shards=8, **kw):
    j = JI.ShardedIVFIndex(mesh=jax_mesh(shards), **kw).fit(J.DenseBatch(ids, x))
    t = TI.ShardedIVFIndex(mesh=_mesh(shards), **kw).fit(DenseBatch(ids, x))
    return j, t


def _bf16_ulp(c: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(c), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shards", [8, 4])
def test_matches_jax(shards):
    x = _data(1600)
    ids = np.arange(len(x), dtype=np.int32)
    j, t = _pair(x, ids, shards, target_cluster=64, nprobe=4, refine=512)
    assert t.mesh.shape[SHARD_AXIS] == shards and len(t.state.shards) == shards
    jc = np.asarray(j.state.centroids.astype(np.float32))[:, :D]
    tc = t.state.centroids.float().numpy()[:, :D]
    diff = np.abs(jc - tc)
    assert (diff <= _bf16_ulp(jc)).all() and (diff > 0).mean() <= 0.005
    kc = tc.shape[0]
    _same(*j.query(x[:32], k=10, query_ids=np.arange(32), nprobe=kc),
          *t.query(x[:32], k=10, query_ids=np.arange(32), nprobe=kc))
    if not diff.any():
        _same(*j.query(x[:32], k=10, query_ids=np.arange(32)),
              *t.query(x[:32], k=10, query_ids=np.arange(32)))
    gt, _ = exact_search(x, x[:32], 10, exclude_self=True, device="cpu")
    got, _ = t.query(x[:32], k=10, query_ids=np.arange(32), nprobe=kc)
    np.testing.assert_array_equal(got, gt)


def test_layout_invariants_and_empty_shards():
    """Every live row once over the shards; starts 8-aligned and
    nondecreasing, ends within their ranges; 52 rows over 8 shards of 8
    leave the last shard empty, and both packages still agree."""
    x = _data(1000)
    state, _ = TI.fit_ivf_sharded(x, np.arange(1000, dtype=np.int32), _mesh(8),
                                  target_cluster=64, iters=3)
    seen = np.concatenate([st.row_ids[TI.ivf_live_rows(st.starts, st.ends,
                                                        st.sketch.shape[0])].numpy()
                           for st in state.shards])
    np.testing.assert_array_equal(np.sort(seen), np.arange(1000))
    for st in state.shards:
        s, e = st.starts.numpy(), st.ends.numpy()
        assert (s % 8 == 0).all() and (np.diff(s) >= 0).all()
        assert (e >= s[:-1]).all() and (e <= s[1:]).all()
    x = _data(52, seed=2)
    ids = np.arange(52, dtype=np.int32)
    j, t = _pair(x, ids, target_cluster=8, iters=3, refine=64)
    assert int((t.state.shards[-1].row_ids >= 0).sum()) == 0
    kc = int(t.state.centroids.shape[0])
    _same(*j.query(x[:8], k=5, nprobe=kc), *t.query(x[:8], k=5, nprobe=kc))


def test_tune_nprobe_on_sharded_index():
    """`tune_nprobe` (`tests/test_sharded_ivf.py:76`) on the port's sharded
    index picks the JAX package's nprobe."""
    x = _data(2000, seed=3)
    ids = np.arange(2000, dtype=np.int32)
    j, t = _pair(x, ids, target_cluster=64, refine=256)
    p = tune_nprobe(t, x[:24], target_recall=0.95, k=5)
    assert p == J.tune_nprobe(j, x[:24], target_recall=0.95, k=5) and t.nprobe == p
    assert 1 <= p <= int(t.state.centroids.shape[0])


def test_two_phase_pruning_matches_jax():
    """Shard-local head pruning: keep past every shard's window budget is
    the single-phase path; a real prune equals the JAX package's."""
    x = _data(4000, seed=6)
    ids = np.arange(4000, dtype=np.int32)
    j, t = _pair(x, ids, target_cluster=64, nprobe=12, win=16, refine=256, head_pool=8)
    assert all(st.heads is not None for st in t.state.shards)
    wb = TI.ivf_window_budget_sharded(t.state, 12, 16)
    assert wb == JI.ivf_window_budget_sharded(j.state, 12, 16)
    i0, s0 = t.query(x[:48], k=10, query_ids=np.arange(48))
    i1, s1 = t.query(x[:48], k=10, query_ids=np.arange(48), keep=wb + 3)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)
    keep = max(wb // 2, 1)
    _same(*j.query(x[:48], k=10, query_ids=np.arange(48), keep=keep),
          *t.query(x[:48], k=10, query_ids=np.arange(48), keep=keep))


def test_ids_from_a_100m_space_and_negative_ids():
    """Ids from a 100M id space come back as they are. With ids below 0
    (every third row), the port answers as with the same rows under ids
    >= 0, each id mapped back, and their rows feed the head tier; the JAX
    package drops them."""
    x = _data(1600, seed=4)
    n = len(x)
    big = np.sort(np.random.default_rng(4).choice(100_000_000, n, replace=False)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    neg = np.where(pos % 3 == 0, -pos - 1, big).astype(np.int32)
    back = dict(zip(big.tolist(), neg.tolist()))
    back[-1] = -1
    kw = dict(target_cluster=64, nprobe=6, win=16, refine=128, head_pool=8, keep=6)
    j_big, t_big = _pair(x, big, **kw)
    j_neg, t_neg = _pair(x, neg, **kw)
    tb, tbs = t_big.query(x[:48], k=10, query_ids=big[:48])
    _same(*j_big.query(x[:48], k=10, query_ids=big[:48]), tb, tbs)
    tn, tns = t_neg.query(x[:48], k=10, query_ids=neg[:48])
    np.testing.assert_array_equal(tn, np.vectorize(back.get)(tb))
    np.testing.assert_array_equal(tns, tbs)
    assert (tn < -1).any()
    for a, b in zip(t_neg.state.shards, t_big.state.shards):
        assert torch.equal(a.heads, b.heads)
    jn, _ = j_neg.query(x[:48], k=10, query_ids=neg[:48])
    assert not (np.asarray(jn) < -1).any()


def test_unfitted(capsys):
    ids, sc = TI.ShardedIVFIndex(mesh=_mesh(2)).query(_data(3), k=4)
    assert (ids == -1).all() and np.isneginf(sc).all()
    assert "need to fit the data first" in capsys.readouterr().out


def _jax_ivf_arrays(state):
    return {f: np.asarray(getattr(state, f).astype(np.float32)) if f == "centroids"
            else np.asarray(getattr(state, f))
            for f in ("sketch", "corpus", "row_ids", "centroids", "starts", "ends")}


def test_from_jax_sharded_ivf_and_save_load_both_ways(tmp_path):
    x = _data(1600, seed=5)
    ids = np.arange(len(x), dtype=np.int32)
    kw = dict(target_cluster=64, nprobe=4, win=16, refine=256, head_pool=8, keep=4)
    j, t = _pair(x, ids, **kw)
    want, want_s = j.query(x[:32], k=10, query_ids=np.arange(32))
    port = from_jax_sharded_ivf(_jax_ivf_arrays(j.state), D, _mesh(8), **kw)
    _same(want, want_s, *port.query(x[:32], k=10, query_ids=np.arange(32)))
    J.save_sharded_ivf(j, str(tmp_path / "j"))
    save_sharded_ivf(t, str(tmp_path / "t"))
    for path in ("j", "t"):
        back = load_sharded_ivf(str(tmp_path / path), _mesh(8))
        assert back.keep == 4 and all(st.heads is not None for st in back.state.shards)
        _same(want, want_s, *back.query(x[:32], k=10, query_ids=np.arange(32)))
    jload = J.load_sharded_ivf(str(tmp_path / "t"))
    _same(want, want_s, *jload.query(x[:32], k=10, query_ids=np.arange(32)))
    with np.load(str(tmp_path / "j.npz")) as zj, np.load(str(tmp_path / "t.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zt[f], zj[f])
    with pytest.raises(ValueError, match="shard count"):
        load_sharded_ivf(str(tmp_path / "t"), _mesh(4))
