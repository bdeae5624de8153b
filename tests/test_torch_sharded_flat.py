"""Port vs JAX package on the sharded flat engines, dense and sparse: one
corpus fitted by the JAX package on its 8 virtual CPU devices and by the
port on `make_forest_mesh(devices=["cpu"] * n)`, 8 and 4 shards. The
sketches are equal bit for bit (one global scale), the scans exact on the
CPU, so ids must be equal on every query and scores within D * 2^-22.

Also: shards with no rows, the unfitted engines, ids from a 100M id space,
negative ids (both packages' results stated), `interop.from_jax_sharded_flat`,
and `save_sharded_flat` / `load_sharded_flat` both ways: a JAX file loads
in the port (on 8 shards and on 4) and a port file in the JAX package, with
equal ids.
"""

import numpy as np
import pytest

import similaritysearchbyrdf_tpu as J
from similaritysearchbyrdf_tpu.parallel import sharded_flat as JFL
from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh as jax_mesh
from similaritysearchbyrdf_tpu_torch import (DenseBatch, SparseBatch, load_sharded_flat,
                                             save_sharded_flat)
from similaritysearchbyrdf_tpu_torch.interop import from_jax_sharded_flat
from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as TFL
from similaritysearchbyrdf_tpu_torch.parallel.mesh import SHARD_AXIS, make_forest_mesh

D = 40
SCORE_TOL = D * 2.0 ** -22


def _data(n=3001, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(30, D))
    x = centers[rng.integers(0, 30, n)] + 0.3 * rng.normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mesh(s):
    return make_forest_mesh(devices=["cpu"] * s)


def _same(ji, js, ti, ts):
    ji, js = np.asarray(ji), np.asarray(js)
    np.testing.assert_array_equal(ti, ji)
    assert (np.isfinite(js) == np.isfinite(ts)).all()
    fin = np.isfinite(js)
    assert (np.abs(js[fin] - ts[fin]) <= SCORE_TOL).all()


@pytest.mark.parametrize("shards,mode,dtype", [(8, "grouped", "int8"), (8, "scan", "int8"),
                                               (8, "grouped", "bfloat16"),
                                               (4, "grouped", "int8"), (4, "scan", "int8")])
def test_dense_matches_jax(shards, mode, dtype):
    x = _data()
    ids = np.arange(len(x), dtype=np.int32)
    j = JFL.ShardedFlatIndex(mesh=jax_mesh(shards), mode=mode, sketch_dtype=dtype)
    j.fit(J.DenseBatch(ids, x))
    t = TFL.ShardedFlatIndex(mesh=_mesh(shards), mode=mode, sketch_dtype=dtype)
    t.fit(DenseBatch(ids, x))
    assert t.mesh.shape[SHARD_AXIS] == shards and t.state.nloc == -(-len(x) // shards)
    w = t.state.shards[0].sketch.shape[1]
    for s, sh in enumerate(t.state.shards):
        rows = np.asarray(j.state.sketch.astype(np.float32))[s * t.state.nloc:
                                                             (s + 1) * t.state.nloc, :w]
        np.testing.assert_array_equal(sh.sketch[:t.state.nloc].float().numpy(), rows)
    ji, js = j.query(x[:64], k=10, query_ids=np.arange(64))
    ti, ts = t.query(x[:64], k=10, query_ids=np.arange(64))
    _same(ji, js, ti, ts)
    ji, js = j.query(x[:16], k=5, exclude_self=False)
    ti, ts = t.query(x[:16], k=5, exclude_self=False)
    _same(ji, js, ti, ts)


def test_empty_shards_and_unfitted(capsys):
    """20 rows over 8 shards of 3: the last shard holds none and the one
    before it two; both packages answer alike. Unfitted engines print the
    reference's message and answer -1 / -inf."""
    x = _data(20, seed=3)
    ids = np.arange(20, dtype=np.int32)
    j = JFL.ShardedFlatIndex(mesh=jax_mesh(8)).fit(J.DenseBatch(ids, x))
    t = TFL.ShardedFlatIndex(mesh=_mesh(8)).fit(DenseBatch(ids, x))
    assert [sh.n_live for sh in t.state.shards] == [3, 3, 3, 3, 3, 3, 2, 0]
    _same(*j.query(x[:4], k=5), *t.query(x[:4], k=5))
    for idx in (TFL.ShardedFlatIndex(mesh=_mesh(2)), TFL.ShardedSparseFlatIndex(mesh=_mesh(2))):
        args = (x[:3],) if isinstance(idx, TFL.ShardedFlatIndex) else (
            np.zeros((3, 4), np.int32), np.zeros((3, 4), np.float32))
        ids_, sc = idx.query(*args, k=4)
        assert (ids_ == -1).all() and np.isneginf(sc).all() and ids_.shape == (3, 4)
    assert capsys.readouterr().out.count("need to fit the data first") == 2


def test_ids_from_a_100m_space_and_negative_ids():
    """Ids from a 100M id space come back as they are. With ids below 0
    (every third row), the port answers as with the same rows under ids
    >= 0, each id mapped back; the JAX package drops them."""
    x = _data()
    n = len(x)
    big = np.sort(np.random.default_rng(4).choice(100_000_000, n, replace=False)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    neg = np.where(pos % 3 == 0, -pos - 1, big).astype(np.int32)
    back = dict(zip(big.tolist(), neg.tolist()))
    back[-1] = -1
    j_big = JFL.ShardedFlatIndex(mesh=jax_mesh(8)).fit(J.DenseBatch(big, x))
    t_big = TFL.ShardedFlatIndex(mesh=_mesh(8)).fit(DenseBatch(big, x))
    j_neg = JFL.ShardedFlatIndex(mesh=jax_mesh(8)).fit(J.DenseBatch(neg, x))
    t_neg = TFL.ShardedFlatIndex(mesh=_mesh(8)).fit(DenseBatch(neg, x))
    jb, jbs = j_big.query(x[:48], k=10, query_ids=big[:48])
    tb, tbs = t_big.query(x[:48], k=10, query_ids=big[:48])
    _same(jb, jbs, tb, tbs)
    assert (tb >= 0).all() and (tb != big[:48, None]).all()
    tn, tns = t_neg.query(x[:48], k=10, query_ids=neg[:48])
    np.testing.assert_array_equal(tn, np.vectorize(back.get)(tb))
    np.testing.assert_array_equal(tns, tbs)
    assert (tn < -1).any()
    jn, _ = j_neg.query(x[:48], k=10, query_ids=neg[:48])
    assert not (np.asarray(jn) < -1).any()


def _jax_flat_arrays(state):
    return {"sketch": np.asarray(state.sketch.astype(np.float32)) if state.sketch.dtype != np.int8
            else np.asarray(state.sketch), "corpus": np.asarray(state.corpus),
            "row_ids": np.asarray(state.row_ids)}


def test_from_jax_sharded_flat():
    x = _data()
    ids = np.arange(len(x), dtype=np.int32)
    j = JFL.ShardedFlatIndex(mesh=jax_mesh(8)).fit(J.DenseBatch(ids, x))
    t = from_jax_sharded_flat(_jax_flat_arrays(j.state), D, _mesh(8))
    _same(*j.query(x[:32], k=10, query_ids=np.arange(32)),
          *t.query(x[:32], k=10, query_ids=np.arange(32)))


@pytest.mark.parametrize("dtype,halved", [("int8", False), ("bfloat16", False),
                                          ("int8", True)])
def test_save_load_both_ways(tmp_path, dtype, halved):
    """`halved`: the JAX index keeps the strided sketch copy of its halved
    group-max reduce (a TPU layout); its file loads with the copy not
    rebuilt."""
    x = _data(1001, seed=5)
    ids = np.arange(len(x), dtype=np.int32)
    j = JFL.ShardedFlatIndex(mesh=jax_mesh(8), sketch_dtype=dtype, gmax_halved=halved)
    j.fit(J.DenseBatch(ids, x))
    assert (j.state.sketch_gmax is not None) == halved
    t = TFL.ShardedFlatIndex(mesh=_mesh(8), sketch_dtype=dtype).fit(DenseBatch(ids, x))
    J.save_sharded_flat(j, str(tmp_path / "j"))
    save_sharded_flat(t, str(tmp_path / "t"))
    want, want_s = j.query(x[:32], k=10, query_ids=np.arange(32))
    for mesh in (_mesh(8), _mesh(4)):       # rows are independent: any dividing count
        back = load_sharded_flat(str(tmp_path / "j"), mesh)
        assert back.sketch_dtype == dtype and back.mode == "grouped"
        _same(want, want_s, *back.query(x[:32], k=10, query_ids=np.arange(32)))
    own = load_sharded_flat(str(tmp_path / "t"), _mesh(8))
    _same(want, want_s, *own.query(x[:32], k=10, query_ids=np.arange(32)))
    jload = J.load_sharded_flat(str(tmp_path / "t"))
    _same(want, want_s, *jload.query(x[:32], k=10, query_ids=np.arange(32)))
    with np.load(str(tmp_path / "j.npz")) as zj, np.load(str(tmp_path / "t.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            np.testing.assert_array_equal(zt[f], zj[f])
    with pytest.raises(ValueError, match="not divisible"):
        load_sharded_flat(str(tmp_path / "t"), _mesh(5))


# ---------------------------------------------------------------------------
# the sparse flat engine, sharded
# ---------------------------------------------------------------------------


def _sparse(n=900, dim=256, nnz=8, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(dim, size=nnz, replace=False) for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, nnz)).astype(np.float32)
    return idx, val


@pytest.mark.parametrize("shards", [8, 4])
def test_sparse_matches_jax(shards):
    idx, val = _sparse()
    n = len(idx)
    ids = np.where(np.arange(n) % 5 == 0, np.arange(n) + 1000, np.arange(n)).astype(np.int32)
    lengths = np.full(n, idx.shape[1], np.int32)
    j = JFL.ShardedSparseFlatIndex(mesh=jax_mesh(shards)).fit(
        J.SparseBatch(ids=ids, size=256, indices=idx, values=val, lengths=lengths))
    t = TFL.ShardedSparseFlatIndex(mesh=_mesh(shards)).fit(
        SparseBatch(ids, 256, idx, val, lengths))
    _same(*j.query(idx[:32], val[:32], k=10, query_ids=ids[:32]),
          *t.query(idx[:32], val[:32], k=10, query_ids=ids[:32]))
    _same(*j.query(idx[:16], val[:16], k=5, exclude_self=False),
          *t.query(idx[:16], val[:16], k=5, exclude_self=False))


def test_sparse_negative_ids():
    """The sparse flat engine's padding rows score 0 (zero rows): known by
    position, they never come back, while a negative user id does; the
    JAX package drops both."""
    idx, val = _sparse(901)
    n = len(idx)
    neg = -np.arange(n, dtype=np.int32) - 2
    lengths = np.full(n, idx.shape[1], np.int32)
    t = TFL.ShardedSparseFlatIndex(mesh=_mesh(8)).fit(SparseBatch(neg, 256, idx, val, lengths))
    j = JFL.ShardedSparseFlatIndex(mesh=jax_mesh(8)).fit(
        J.SparseBatch(ids=neg, size=256, indices=idx, values=val, lengths=lengths))
    pos = TFL.ShardedSparseFlatIndex(mesh=_mesh(8)).fit(
        SparseBatch(np.arange(n, dtype=np.int32), 256, idx, val, lengths))
    ti, ts = t.query(idx[:16], val[:16], k=10)
    pi, ps = pos.query(idx[:16], val[:16], k=10)
    np.testing.assert_array_equal(ti, np.where(pi >= 0, -pi - 2, -1))
    np.testing.assert_array_equal(ts, ps)
    assert (ti < -1).all() and t.state.shards[-1].n_live == n - 7 * 113
    ji, js = j.query(idx[:16], val[:16], k=10)
    assert (np.asarray(ji) == -1).all() and np.isneginf(np.asarray(js)).all()
