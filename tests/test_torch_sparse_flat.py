"""Port vs JAX package on the sparse flat engine: the densified int8 sketch
bit for bit, and `flat_topk_sparse` / `SparseFlatIndex` on one identical
index (`interop.from_jax_sparse_flat`) in both select modes.

The sketch pads its columns to a multiple of 32 in the port and of 128 in
the JAX package; its first `size` columns must be equal and the rest 0.
Queries run through K4's and K2b's plain versions here; the exact tail is
the sort-merge sparse dot, so ids must be equal on >= 99% of queries and
every query equal up to near-ties (1e-6)."""

import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.ops.flat as jflat
from similaritysearchbyrdf_tpu.vectors import SparseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import SparseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import SparseFlatIndex, flat_topk_sparse
from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
from similaritysearchbyrdf_tpu_torch.interop import from_jax_sparse_flat
from similaritysearchbyrdf_tpu_torch.ops import flat as tflat
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_topk_sparse
from similaritysearchbyrdf_tpu_torch.ops.hashing import densify

N, NNZ, NQ, K = 3000, 16, 100, 10


def corpus(d, seed=3):
    """`scripts/bench_sparse_1m.py`'s recipe at a small size."""
    rng = np.random.default_rng(seed)
    supports = np.stack([rng.choice(d, size=NNZ, replace=False) for _ in range(150)])
    idx = supports[rng.integers(0, 150, N)].astype(np.int32)
    val = (0.8 + 0.2 * rng.random((N, NNZ))).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return idx, val


def jax_flat_arrays(index):
    return {name: np.asarray(getattr(index, name))
            for name in ("sketch", "scale", "c_idx", "c_val", "row_ids")}


@pytest.mark.parametrize("size,chunk", [(200, 700), (4096, 1024)])
def test_sketch_matches_jax(size, chunk):
    idx, val = corpus(size)
    sk, scale = tflat.build_flat_sketch_sparse(torch.from_numpy(idx), torch.from_numpy(val),
                                               size, chunk=chunk)
    jsk, jscale = jflat.build_flat_sketch_sparse(idx, val, size)
    jsk = np.asarray(jsk)
    assert scale == jscale and sk.dtype == torch.int8
    assert sk.shape == (N, -(-size // 32) * 32) and jsk.shape == (N, -(-size // 128) * 128)
    np.testing.assert_array_equal(sk[:, :size].numpy(), jsk[:, :size])
    assert not sk[:, size:].any() and not jsk[:, size:].any()


@pytest.fixture(scope="module")
def world():
    d = 512
    idx, val = corpus(d)
    ids, lengths = np.arange(N, dtype=np.int32), np.full(N, NNZ, np.int32)
    jidx = jflat.SparseFlatIndex().fit(JBatch(ids, d, idx, val, lengths))
    qd = densify(torch.from_numpy(idx[:NQ]), torch.from_numpy(val[:NQ]), d)
    gt, _ = exact_topk_sparse(torch.from_numpy(idx), torch.from_numpy(val), qd, K,
                              exclude_diag_offset=0)
    return {"d": d, "idx": idx, "val": val, "tb": TBatch(ids, d, idx, val, lengths),
            "jidx": jidx, "gt": gt.numpy()}


def _agree(t_ids, t_sc, j_ids, j_sc):
    assert t_ids.shape == j_ids.shape == (NQ, K)
    assert (t_ids == j_ids).all(axis=1).mean() >= 0.99
    assert all(equal_up_to_ties(t_ids[i], t_sc[i], j_ids[i], j_sc[i], 1e-6) for i in range(NQ))


@pytest.mark.parametrize("exclude", [True, False])
def test_index_matches_jax(world, exclude):
    idx, val = world["idx"], world["val"]
    tidx = from_jax_sparse_flat(jax_flat_arrays(world["jidx"]), world["d"], device="cpu")
    assert tidx.sketch.shape == (8192, world["d"])            # row-padded, 32-col width
    qids = np.arange(NQ)
    j_ids, j_sc = world["jidx"].query(idx[:NQ], val[:NQ], k=K, query_ids=qids,
                                      exclude_self=exclude)
    t_ids, t_sc = tidx.query(idx[:NQ], val[:NQ], k=K, query_ids=qids, exclude_self=exclude)
    _agree(t_ids, t_sc, j_ids, j_sc)
    if exclude:
        assert not (t_ids == qids[:, None]).any()
        hits = sum(len(set(world["gt"][i]) & set(t_ids[i])) for i in range(NQ))
        assert hits / world["gt"].size >= 0.99
    # the port's own fit gives the same index (the sketch is bit-equal)
    own = SparseFlatIndex(device="cpu").fit(world["tb"])
    assert torch.equal(own.sketch, tidx.sketch) and own.scale == tidx.scale
    o_ids, _ = own.query(idx[:NQ], val[:NQ], k=K, query_ids=qids, exclude_self=exclude)
    np.testing.assert_array_equal(o_ids, t_ids)


@pytest.mark.parametrize("mode", ["exact2", "argpack"])
def test_flat_topk_sparse_matches_jax(world, monkeypatch, mode):
    """Both select modes, forced (at 3,000 rows "auto" is exact2). The JAX
    package reads its mode at trace time; `refine` differs per mode so
    each mode traces anew."""
    idx, val, d = world["idx"], world["val"], world["d"]
    refine = {"exact2": 128, "argpack": 96}[mode]
    monkeypatch.setattr(jflat, "_SELECT_MODE", mode)
    jidx = world["jidx"]
    qi, qv = idx[:NQ], val[:NQ]
    qids = np.arange(NQ, dtype=np.int32)
    j_ids, j_sc = jflat.flat_topk_sparse(jidx.sketch, jidx.c_idx, jidx.c_val, jidx.row_ids,
                                         qi, qv, qids, K, refine=refine, r_groups=30)
    tidx = from_jax_sparse_flat(jax_flat_arrays(jidx), d, device="cpu")
    t_ids, t_sc = flat_topk_sparse(tidx.sketch, tidx.c_idx, tidx.c_val, tidx.row_ids,
                                   torch.from_numpy(qi), torch.from_numpy(qv),
                                   torch.from_numpy(qids), K, refine=refine, r_groups=30,
                                   select_mode=mode)
    _agree(t_ids.numpy(), t_sc.numpy(), np.asarray(j_ids), np.asarray(j_sc))


@pytest.mark.parametrize("with_query_ids", [False, True])
def test_negative_ids_are_results(world, with_query_ids):
    """A reference fault not copied: the JAX engine drops every user id
    below 0 (its `uid >= 0`), and without query ids it also excludes id -1
    as if it were each query's own. The port lists every result whose score
    is finite, and excludes a query's own id only when it is given. Ids:
    the row number, negated minus one for every fifth row (row 0 is -1)."""
    idx, val, d = world["idx"], world["val"], world["d"]
    rows = np.arange(N)
    ids = np.where(rows % 5 == 0, -rows - 1, rows).astype(np.int32)
    lengths = np.full(N, NNZ, np.int32)
    jidx = jflat.SparseFlatIndex().fit(JBatch(ids, d, idx, val, lengths))
    tidx = SparseFlatIndex(device="cpu").fit(TBatch(ids, d, idx, val, lengths))
    qids = ids[:NQ] if with_query_ids else None
    j_ids, _ = jidx.query(idx[:NQ], val[:NQ], k=K, query_ids=qids)
    t_ids, t_sc = tidx.query(idx[:NQ], val[:NQ], k=K, query_ids=qids)
    qd = densify(torch.from_numpy(idx[:NQ]), torch.from_numpy(val[:NQ]), d)
    gt_rows, gt_sc = exact_topk_sparse(torch.from_numpy(idx), torch.from_numpy(val), qd, K,
                                       exclude_diag_offset=0 if with_query_ids else None)
    want = ids[gt_rows.numpy()]
    assert np.isfinite(t_sc).all() and (t_ids < 0).any()
    hits = sum(len(set(want[i]) & set(t_ids[i])) for i in range(NQ))
    assert hits / want.size >= 0.99
    if with_query_ids:
        assert not (t_ids == qids[:, None]).any()
    else:
        assert (t_ids[:, 0] == ids[:NQ]).mean() >= 0.99       # each query finds itself
    # the JAX engine returns no negative id; otherwise its lists are the
    # port's with the negative ids taken out
    assert (j_ids >= 0).all()
    kept = [[x for x in t_ids[i] if x >= 0] for i in range(NQ)]
    assert np.mean([list(j_ids[i][:len(kept[i])]) == kept[i] for i in range(NQ)]) >= 0.99


def test_unfitted_query(capsys):
    ids, sc = SparseFlatIndex(device="cpu").query(np.zeros((3, 4), np.int32),
                                                  np.zeros((3, 4), np.float32), k=5)
    assert "need to fit the data first" in capsys.readouterr().out
    assert (ids == -1).all() and (sc == -np.inf).all() and ids.shape == (3, 5)
    with pytest.raises(RuntimeError):
        SparseFlatIndex(device="cpu").query_device(np.zeros((3, 4), np.int32),
                                                   np.zeros((3, 4), np.float32))


def test_bytes_per_vector(world):
    own = SparseFlatIndex(device="cpu").fit(world["tb"])
    bpv = own.bytes_per_vector()
    assert bpv["indices"] == bpv["values"] == 4 * NNZ and bpv["ids"] == 4
    assert bpv["sketch"] == 8192 * world["d"] / N
