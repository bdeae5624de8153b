"""Port vs JAX package on the sparse ops: sparse hashing (densified and by
gathers), the sort-merge and gather re-ranks, `dedup_sorted`, the feature
size guard and the sparse exact search, from numpy inputs made from a seed.

Hash bits are decided by the sign of an f32 dot summed in another order in
each package, so a bit may differ where |dot| < 1e-5 (for p-stable, where
(a.x + b)/w lies within 1e-5 of an integer); such bits are counted and
excluded, every other bit must be equal. Scores agree within the f32
summation bound 2·n·2^-24·Σ|c·q| of an n-term sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.models import families as jfam
from similaritysearchbyrdf_tpu.ops import exact as jexact
from similaritysearchbyrdf_tpu.ops import hashing as jhash
from similaritysearchbyrdf_tpu.ops import rerank as jrr
from similaritysearchbyrdf_tpu_torch import SparseBatch
from similaritysearchbyrdf_tpu_torch.index import sparse_forest as tsf
from similaritysearchbyrdf_tpu_torch.models import families as tfam
from similaritysearchbyrdf_tpu_torch.ops import exact as texact
from similaritysearchbyrdf_tpu_torch.ops import hashing as thash
from similaritysearchbyrdf_tpu_torch.ops import rerank as trr

NEAR = 1e-5
U = 2.0 ** -24


def confs(d, family):
    """The same configuration in both packages; unit-vector angle families
    (no QR of a D x D matrix: model parity is `test_torch_hashing.py`'s)."""
    base = dict(vector_dim=d, table_num=3, permutation_num=2, family_size=40,
                partition_bits=3, seed=9, family_name=family, is_orthogonal=False)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32)))


def sparse_rows(n, d, nnz, seed, positive=False, common=None):
    """Padded-COO rows i32/f32[n, nnz]: 1..nnz unique indices a row (some
    rows hold index 0; with `common`, every row holds that index), the rest
    padding (index 0, value 0.0)."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, nnz), np.int32)
    val = np.zeros((n, nnz), np.float32)
    for i in range(n):
        k = int(rng.integers(1, nnz + 1))
        cols = rng.choice(d, size=k, replace=False)
        if i % 7 == 0 and 0 not in cols:
            cols[-1] = 0
        if common is not None and common not in cols:
            cols[0] = common
        idx[i, :k] = cols
        v = rng.random(k) + 0.1 if positive else rng.normal(size=k)
        val[i, :k] = v
    return idx, val


def densified(idx, val, d):
    out = np.zeros((idx.shape[0], d), np.float64)
    np.add.at(out, (np.arange(idx.shape[0])[:, None], idx), val.astype(np.float64))
    return out


def near_words(x, jm):
    """Per hash word [B, T*P]: the bits (angle) or words (p-stable) whose
    value lies within float noise of a decision boundary."""
    proj = np.asarray(jm.proj, np.float64)
    dots = np.einsum("bd,tcd->btc", x, proj)
    perm = np.asarray(jm.perm).astype(np.int64)
    t, p, c = perm.shape
    if jm.family == "angle":
        near = np.abs(dots) < NEAR
        bits = np.take_along_axis(near[:, :, None, :], perm[None], axis=-1)
        return (bits * np.left_shift(np.int64(1), np.arange(31, 31 - c, -1))).sum(-1).reshape(
            x.shape[0], t * p)
    vals = (dots + np.asarray(jm.b, np.float64)[None]) / jm.w
    near = (np.abs(vals - np.round(vals)) < NEAR).any(-1)                   # [B, T]
    return np.where(np.repeat(near, p, axis=1), np.int64(0xFFFFFFFF), 0)


@pytest.mark.parametrize("family", ["angle", "pStable"])
@pytest.mark.parametrize("d", [64, 4096, 5000])
@pytest.mark.parametrize("fn", ["hash_sparse", "hash_sparse_densify"])
def test_sparse_hashes_match_jax(fn, d, family):
    jc, tc = confs(d, family)
    jm, tm = jfam.generate_model(jc), tfam.generate_model(tc, device="cpu")
    idx, val = sparse_rows(48, d, 24, seed=d)
    got = getattr(thash, fn)(tm, torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    want = np.asarray(getattr(jhash, fn)(jm, jnp.asarray(idx), jnp.asarray(val))).astype(np.int64)
    assert got.shape == want.shape == (48, 3 * jm.perm.shape[1])
    mask = near_words(densified(idx, val, d), jm)
    diff = got ^ want
    assert not (diff & ~mask).any(), f"{np.count_nonzero(diff & ~mask)} words differ"
    flips = int(sum(bin(int(v)).count("1") for v in (diff & mask).ravel()))
    assert flips <= np.count_nonzero(mask) * 32


@pytest.mark.parametrize("d,route", [(64, "hash_sparse_densify"), (4096, "hash_sparse_densify"),
                                     (4097, "hash_sparse")])
def test_forest_hash_route(monkeypatch, d, route):
    """The sparse forest hashes densified up to 4096 dims and by gathers
    above, as the JAX package's `_hash_batch` does."""
    _, tc = confs(d, "angle")
    tm = tfam.generate_model(tc, device="cpu")
    idx, val = sparse_rows(8, d, 6, seed=1)
    taken = []
    for name in ("hash_sparse", "hash_sparse_densify"):
        real = getattr(tsf, name)
        monkeypatch.setattr(tsf, name, lambda *a, _n=name, _f=real: taken.append(_n) or _f(*a))
    tsf._hash_batch(tm, torch.from_numpy(idx), torch.from_numpy(val), d)
    assert taken == [route]


@pytest.fixture(scope="module")
def rerank_case():
    """A corpus of 300 sparse rows over 200 dims, 8 queries, candidates with
    -1 and duplicate ids. Every row and query holds index 5, so every
    score is positive (no ties), except one candidate of query 0 that
    shares no index with any query: its score is exactly 0."""
    n, d, nnz, b, m = 300, 200, 12, 8, 96
    c_idx, c_val = sparse_rows(n, d, nnz, seed=3, positive=True, common=5)
    q_idx, q_val = sparse_rows(b, d - 2, 10, seed=4, positive=True, common=5)
    rng = np.random.default_rng(5)
    cand = rng.integers(0, n, size=(b, m)).astype(np.int32)
    cand[:, ::9] = -1
    cand[:, 1::11] = cand[:, 2::11]                                   # duplicate ids
    lone = cand[0, 3]
    c_idx[lone], c_val[lone] = 0, 0.0
    c_idx[lone, :2], c_val[lone, :2] = [d - 1, d - 2], 1.0
    return c_idx, c_val, q_idx, q_val, cand, d


def _bound(c_idx, c_val, q_idx, q_val, cand, d):
    """Per (query, candidate), the f32 bound of the exact dot's two sums."""
    qd = densified(q_idx, np.abs(q_val), d)
    safe = np.maximum(cand, 0)
    ab = np.einsum("bmn,bmn->bm", np.abs(c_val[safe]),
                   np.take_along_axis(qd[:, None, :], c_idx[safe].astype(np.int64), axis=2))
    return 2 * (c_idx.shape[1] + q_idx.shape[1]) * U * ab


def test_sparse_merge_scores_match_jax(rerank_case):
    c_idx, c_val, q_idx, q_val, cand, d = rerank_case
    got = trr.sparse_merge_scores(*map(torch.from_numpy, (c_idx, c_val, cand, q_idx, q_val)))
    want = np.asarray(jrr.sparse_merge_scores(*map(jnp.asarray, (c_idx, c_val, cand, q_idx,
                                                                 q_val))))
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isneginf(got), cand < 0)
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= _bound(c_idx, c_val, q_idx, q_val, cand, d)[fin]).all()
    assert got[0, 3] == 0.0
    # the true sparse dot, not a positional zip
    qd = densified(q_idx, q_val, d)
    ref = np.einsum("bmn,bmn->bm", c_val[np.maximum(cand, 0)],
                    np.take_along_axis(qd[:, None, :], c_idx[np.maximum(cand, 0)].astype(np.int64),
                                       axis=2))
    assert (np.abs(got[fin] - ref[fin]) <= _bound(c_idx, c_val, q_idx, q_val, cand, d)[fin]).all()


@pytest.mark.parametrize("k,dup_bound", [(5, 4), (10, 1), (3, 32)])
def test_sparse_reranks_match_jax(rerank_case, k, dup_bound):
    c_idx, c_val, q_idx, q_val, cand, d = rerank_case
    t = list(map(torch.from_numpy, (c_idx, c_val, cand, q_idx, q_val)))
    j = list(map(jnp.asarray, (c_idx, c_val, cand, q_idx, q_val)))
    qd = densified(q_idx, q_val, d).astype(np.float32)
    outs = {
        "merge": (trr.rerank_sparse_merge(*t, k, dup_bound=dup_bound),
                  jrr.rerank_sparse_merge(*j, k, dup_bound=dup_bound)),
        "gather": (trr.rerank_sparse(t[0], t[1], t[2], torch.from_numpy(qd), k,
                                     dup_bound=dup_bound),
                   jrr.rerank_sparse(j[0], j[1], j[2], jnp.asarray(qd), k, dup_bound=dup_bound)),
    }
    for name, ((ti, ts), (ji, js)) in outs.items():
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=name)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=4 * 22 * U, atol=1e-30,
                                   err_msg=name)
        rows = ti.numpy()
        assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in rows), name   # deduplicated


def test_merge_size_guard():
    trr.check_sparse_size_for_merge(trr.MAX_MERGE_FEATURE_SIZE)
    with pytest.raises(ValueError):
        trr.check_sparse_size_for_merge(2**30)
    assert trr.MAX_MERGE_FEATURE_SIZE == jrr.MAX_MERGE_FEATURE_SIZE


def test_dedup_sorted_matches_jax():
    cand = np.random.default_rng(8).integers(-1, 40, size=(6, 50)).astype(np.int32)
    np.testing.assert_array_equal(trr.dedup_sorted(torch.from_numpy(cand)).numpy(),
                                  np.asarray(jrr.dedup_sorted(jnp.asarray(cand))))


@pytest.mark.parametrize("offset", [None, 0, 37])
def test_exact_topk_sparse_matches_jax(offset):
    n, d = 700, 300
    c_idx, c_val = sparse_rows(n, d, 16, seed=11, positive=True)
    q_idx, q_val = (c_idx[37:37 + 24], c_val[37:37 + 24]) if offset == 37 else \
        sparse_rows(24, d, 16, seed=12, positive=True)
    qd = densified(q_idx, q_val, d).astype(np.float32)
    ti, ts = texact.exact_topk_sparse(torch.from_numpy(c_idx), torch.from_numpy(c_val),
                                      torch.from_numpy(qd), 10, chunk=128,
                                      exclude_diag_offset=offset)
    ji, js = jexact.exact_topk_sparse(jnp.asarray(c_idx), jnp.asarray(c_val), jnp.asarray(qd),
                                      10, chunk=128, exclude_diag_offset=offset)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 * 16 * U, atol=1e-30)
    if offset is not None:
        assert not (ti.numpy() == np.arange(24)[:, None] + offset).any()


def test_sparse_batch_keeps_tensor_rows():
    """Rows given as tensors stay tensors (cast to i32 / f32 where they
    live), so rows already on the card are not copied through the host."""
    idx, val = sparse_rows(5, 30, 4, seed=2)
    b = SparseBatch(np.arange(5), 30, torch.from_numpy(idx).long(),
                    torch.from_numpy(val).double(), np.full(5, 4))
    assert isinstance(b.indices, torch.Tensor) and b.indices.dtype == torch.int32
    assert isinstance(b.values, torch.Tensor) and b.values.dtype == torch.float32
    sub = b.take(np.array([3, 1]))
    assert torch.equal(sub.indices, torch.from_numpy(idx[[3, 1]]))
    assert list(sub.ids) == [3, 1]
