"""Port vs JAX package: the forest's window mode.

The aligned-window flatten (`gather_blocks` with window > 0), window
scoring (`_coarse_block_scores` with start_b, K2b's plain version against
the TPU kernel in interpret mode), the strided tournament, the head tier,
window pruning and end-to-end window-mode queries on the identical index.

Integer outputs are compared bit for bit. Coarse scores multiply int8 tier
values by bf16 query values exactly in f32 and differ only in summation
order, so each may differ by (n_a + n_b) * 2^-24 * sum_c |tier_c * q_c|,
n_a and n_b the terms each side sums (128 lanes for the JAX package's
lane-packed dot, cs for the port). End-to-end queries differ only by such
float rounding: ids equal on >= 99% of queries, recall@10 within 0.005."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import forest as jforest
from similaritysearchbyrdf_tpu.ops.hashing import hash_dense_with_margins as j_hash_margins
from similaritysearchbyrdf_tpu.ops.pallas import coarse_gather as jcg
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import from_jax_state
from similaritysearchbyrdf_tpu_torch.index import forest as tforest
from similaritysearchbyrdf_tpu_torch.interop import unpack_lane_tier
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2

from test_torch_forest import jax_state_arrays, recall

N, D, NQ, K = 6000, 32, 64, 10
M_CAP, HP = 8192, 16
U = 2.0 ** -24


def confs():
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=M_CAP, top_k=K,
                seed=91, use_pallas_hash=True, coarse_dim=16, coarse_dtype="int8",
                coarse_refine=256, coarse_window=64, coarse_head_pool=HP)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(77)
    centers = rng.normal(size=(80, D))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 80, N)] + 0.08 * rng.normal(size=(N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    ids = np.arange(N, dtype=np.int32)
    jc, tc = confs()
    jf = jforest.RDFForest(jc).fit(JBatch(ids, x))
    port = tforest.RDFForest(tc, device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    gt, _ = exact_search(x, x[:NQ], K, exclude_self=True, device="cpu")
    return {"x": x, "ids": ids, "gt": gt, "jc": jc, "tc": tc, "jf": jf, "port": port}


def _i64(a):
    return None if a is None else torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("win,align", [(64, 8), (256, 64)])
@pytest.mark.parametrize("probe_mode,steps", [("margin", 0), ("reference", 1)])
def test_gather_blocks_window_match_jax(world, win, align, probe_mode, steps):
    jf, port = world["jf"], world["port"]
    js = jf.state
    q = jnp.asarray(world["x"][:NQ])
    probes = pvalid = None
    if probe_mode == "margin":
        h, margins = j_hash_margins(js.model, q)
        probes, pvalid = jforest._probe_hashes_margin(h, margins, jf.layout, 16)
    else:
        h = jforest.hash_dense(js.model, q)
    home = jforest.partition_of_hash(h, js.part_proj)
    want = jforest.gather_blocks(js.tables, h, home, jf.layout, steps, M_CAP, True,
                                 probes=probes, probe_valid=pvalid, window=win, align=align)
    got = tforest.gather_blocks(
        port.state.tables, _i64(h), _i64(home), port.layout, steps, M_CAP, True,
        _i64(probes), None if pvalid is None else torch.tensor(np.asarray(pvalid)),
        window=win, align=align)
    assert got[5] == want[5] == win
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    base, _, start, end, total, _ = (np.asarray(a) if not isinstance(a, int) else a
                                     for a in want)
    assert (total > 0).all()
    # every window that can hold a live slot starts align-aligned
    blk = base + np.arange(M_CAP // win) * win
    live = (blk < end) & (blk + win > start)
    assert live.any() and (blk[live] % align == 0).all()


def _window_inputs(rng, l, cs, caprows, b, mb, win):
    g = 128 // cs
    lg = -(-l // g)
    packed = rng.integers(-127, 128, size=(lg, caprows, g * cs)).astype(np.int8)
    # aligned window starts, some past the end of the table (clamped), a
    # range start/end per window so that some windows are dead and some
    # slots fall before start or past end
    blk = rng.integers(0, (caprows + 2 * win) // 8, size=(b, mb)) * 8
    start = blk + rng.integers(-8, win, size=(b, mb))
    end = start + rng.integers(0, 2 * win, size=(b, mb))
    table = rng.integers(0, l, size=(b, mb))
    return packed, blk, start.astype(np.int32), end.astype(np.int32), table.astype(np.int32)


@pytest.mark.parametrize("l,cs,abs_starts", [(6, 32, False), (8, 16, True), (3, 64, False)])
def test_window_block_scores_match_jax(l, cs, abs_starts):
    """`_coarse_block_scores` in window mode: JAX's XLA path on the
    lane-packed tier, the port (K2b's plain version) on the same tier
    unpacked per table."""
    rng = np.random.default_rng(l * cs)
    caprows, d, b, mb, win = 320, 24, 5, 12, 64
    packed, blk, start, end, table = _window_inputs(rng, l, cs, caprows, b, mb, win)
    base = (blk if abs_starts else blk - np.arange(mb) * win).astype(np.int32)
    proj = rng.normal(size=(d, cs)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    want_s, want_p, want_t = (np.asarray(a) for a in jforest._coarse_block_scores(
        jnp.asarray(packed), jnp.asarray(proj), jnp.asarray(queries), jnp.asarray(base),
        jnp.asarray(table), jnp.asarray(end), win, start_b=jnp.asarray(start),
        abs_starts=abs_starts))
    per_table = unpack_lane_tier(packed, l, cs)
    got_s, got_p, got_t = (a.numpy() for a in tforest._coarse_block_scores(
        torch.from_numpy(per_table), torch.from_numpy(proj), torch.from_numpy(queries),
        torch.from_numpy(base).long(), torch.from_numpy(table).long(),
        torch.from_numpy(end).long(), win, start_b=torch.from_numpy(start).long(),
        abs_starts=abs_starts))
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_t, want_t)
    live = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), live)
    assert 0.1 < live.mean() < 0.9
    assert (got_p.max() < caprows) and (got_p.reshape(b, mb, win)[..., 0] % 8 == 0).all()
    q_low = np.asarray(jnp.asarray(queries @ proj).astype(jnp.bfloat16).astype(jnp.float32))
    blk_c = np.minimum(blk, caprows - win).astype(np.int32)
    bound = (128 + cs) * U * K2.coarse_block_scores_plain(
        torch.from_numpy(np.abs(per_table)), torch.from_numpy(np.abs(q_low)).to(torch.bfloat16),
        torch.from_numpy(table), torch.from_numpy(blk_c), win).numpy().reshape(b, -1)
    assert (np.abs(got_s[live] - want_s[live]) <= bound[live] + 1e-30).all()


@pytest.mark.parametrize("cs,win", [(32, 64), (16, 128)])
def test_window_plain_matches_pallas_aligned(monkeypatch, cs, win):
    """The TPU kernel K2b replaces (`pallas_coarse_scores_aligned`, interpret
    mode on the CPU, per-table tier, dead windows skipped) against K2b's
    plain version. The TPU kernel scores every slot of a live window and
    leaves dead windows undefined; the plain version masks both, so they
    are compared on the valid slots, and the rest must be -inf."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcg.pl, "pallas_call", interpret)
    rng = np.random.default_rng(cs + win)
    l, caprows, b, mb = 3, 512, 3, 16
    tier = rng.integers(-127, 128, size=(l, caprows, cs)).astype(np.int8)
    q = rng.normal(size=(b, cs)).astype(np.float32)
    table = rng.integers(0, l, size=(b, mb)).astype(np.int32)
    blk = (rng.integers(0, (caprows - win) // 8 + 1, size=(b, mb)) * 8).astype(np.int32)
    start = (blk + rng.integers(-8, win, size=(b, mb))).astype(np.int32)
    end = (start + rng.integers(0, 2 * win, size=(b, mb))).astype(np.int32)
    end = np.where(rng.random((b, mb)) < 0.25, blk, end).astype(np.int32)   # dead windows
    live = (blk < end) & (blk + win > start)
    assert 0 < live.mean() < 1
    want = np.asarray(jcg.pallas_coarse_scores_aligned(
        jnp.asarray(tier), jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(blk), win, grp=8, live=jnp.asarray(live)))
    q_low = torch.from_numpy(q).to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (table, blk, start, end)]
    before = K2.WINDOW_LAUNCHES
    got = K2.coarse_window_scores_kernel(torch.from_numpy(tier), q_low, *args,
                                         torch.from_numpy(live), win).numpy()
    assert K2.WINDOW_LAUNCHES == before
    pos = blk[..., None] + np.arange(win)
    valid = live[..., None] & (pos >= start[..., None]) & (pos < end[..., None])
    assert valid.any()
    assert np.isneginf(got[~valid]).all()
    bound = 2 * cs * U * K2.coarse_block_scores_plain(
        torch.from_numpy(np.abs(tier)), q_low.abs(), args[0], args[1], win).numpy()
    assert (np.abs(got[valid] - want[valid]) <= bound[valid] + 1e-30).all()


@pytest.mark.parametrize("win,m2", [(64, 32), (16, 8), (64, 200)])
def test_strided_tournament_bit_equal(win, m2):
    rng = np.random.default_rng(win + m2)
    b, mb, l, cap = 4, 24, 5, 4000
    m_slab = mb * win
    # coarse scores with ties and -inf (masked slots), as window mode makes
    scores = rng.integers(-6, 6, size=(b, m_slab)).astype(np.float32) / 4
    scores[rng.random((b, m_slab)) < 0.3] = -np.inf
    pos = rng.integers(0, cap, size=(b, m_slab)).astype(np.int32)
    table = rng.integers(0, l, size=(b, m_slab)).astype(np.int32)
    want = jforest._strided_tournament(jnp.asarray(scores), jnp.asarray(pos),
                                       jnp.asarray(table), win, m_slab, m2, m_slab, l, cap)
    got = tforest._strided_tournament(torch.from_numpy(scores), torch.from_numpy(pos).long(),
                                      torch.from_numpy(table).long(), win, m_slab, m2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[1] == (m_slab // 4 if m2 * 8 <= m_slab else m_slab)


@pytest.mark.parametrize("l,cs,hp", [(6, 32, 16), (5, 16, 64)])
def test_head_tier_matches_jax(l, cs, hp):
    """The per-table head tier against the JAX package's lane-packed one,
    unpacked; within one bf16 ulp (both divide exact f32 sums)."""
    rng = np.random.default_rng(hp + l)
    caprows = 200
    g = 128 // cs
    packed = rng.integers(-127, 128, size=(-(-l // g), caprows, g * cs)).astype(np.int8)
    n_live = rng.integers(100, caprows, size=l)
    si = np.stack([np.where(np.arange(caprows) < n, rng.permutation(caprows), -1)
                   for n in n_live]).astype(np.int32)
    per_table = unpack_lane_tier(packed, l, cs) * (si >= 0)[..., None]
    packed = np.zeros_like(packed)
    for t in range(l):
        packed[t // g, :, (t % g) * cs:(t % g + 1) * cs] = per_table[t]
    want = np.asarray(jforest.build_head_tier(jnp.asarray(packed), jnp.asarray(si), hp,
                                              groups=g), dtype=np.float32)
    want = unpack_lane_tier(want, l, cs)
    got = tforest.build_head_tier(torch.from_numpy(per_table), torch.from_numpy(si), hp)
    assert got.dtype == torch.bfloat16 and got.shape == (l, -(-caprows // hp), cs)
    got = got.to(torch.float32).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_head_tier_through_from_jax_state(world):
    """The fitted JAX head tier, carried over, equals the port's own head
    tier built from the carried-over coarse tier."""
    st = world["port"].state
    own = tforest.build_head_tier(st.coarse_tier, st.tables.sorted_ids, HP)
    assert st.coarse_head.dtype == torch.bfloat16
    diff = (own.to(torch.float32) - st.coarse_head.to(torch.float32)).abs()
    assert float(diff.max()) <= float(st.coarse_head.abs().max()) * 2.0 ** -7


def _prune_inputs(seed, b=4, mb=32, win=16, hp=8, l=3, hr=64, cs=16):
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(l, hr, cs)).astype(np.float32)
    head = np.array(jnp.asarray(head).astype(jnp.bfloat16).astype(jnp.float32))
    q_low = np.array(jnp.asarray(rng.normal(size=(b, cs))).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    start = np.sort(rng.integers(0, hr * hp - 4 * win, size=(b, mb)), axis=1).astype(np.int32)
    base = (start // win) * win
    end = (start + rng.integers(win, 4 * win, size=(b, mb))).astype(np.int32)
    end[:, -5:] = start[:, -5:]                      # a few dead windows
    table = rng.integers(0, l, size=(b, mb)).astype(np.int32)
    return head, q_low, base.astype(np.int32), table, start, end


@pytest.mark.parametrize("keep", [8, 31])
def test_prune_windows_match_jax(keep):
    """`_prune_windows` on the same inputs: the same windows survive, in
    ascending slot order (mirrors `tests/test_forest.py`'s slot-order test)."""
    win, hp = 16, 8
    head, q_low, base, table, start, end = _prune_inputs(keep)
    blk = base + np.arange(base.shape[1]) * win
    assert ((blk < end) & (blk + win > start)).sum(axis=1).min() >= 2
    want = jforest._prune_windows(
        jnp.asarray(head).astype(jnp.bfloat16), hp, jnp.asarray(q_low).astype(jnp.bfloat16),
        None, jnp.asarray(base), jnp.asarray(table), jnp.asarray(start), jnp.asarray(end),
        win, keep, 1)
    got = tforest._prune_windows(
        torch.from_numpy(head).to(torch.bfloat16), hp,
        torch.from_numpy(q_low).to(torch.bfloat16), *(torch.from_numpy(a).long() for a in
                                                      (base, table, start, end)), win, keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.diff(got[0].numpy(), axis=1) > 0).all()


def test_prune_keeping_every_live_window_is_parity(world):
    """Pruning that keeps at least every live window returns what the
    unpruned window path returns, when refine covers every slot of both
    slabs (mirrors `tests/test_forest.py::test_window_prune_keeps_all_is_parity`)."""
    port, x, ids = world["port"], world["x"], world["ids"]
    kw = dict(steps=1, query_ids=ids[:16], coarse_refine=M_CAP, probe_mode="margin",
              probe_budget=16)
    ids_a, sc_a = port.query(x[:16], window_keep=0, **kw)
    ids_b, sc_b = port.query(x[:16], window_keep=M_CAP // 64 - 1, **kw)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-6)


@pytest.mark.parametrize("window_keep,steps", [(0, 0), (0, 1), (32, 0), (32, 1)])
def test_window_query_matches_jax(world, window_keep, steps):
    """Window mode end to end on the identical index, prune off and on."""
    jf, port, x, ids, gt = (world[k] for k in ("jf", "port", "x", "ids", "gt"))
    kw = dict(steps=steps, query_ids=ids[:NQ], probe_mode="margin", probe_budget=16,
              window_keep=window_keep)
    want, want_s = jf.query(x[:NQ], **kw)
    got, got_s = port.query(x[:NQ], **kw)
    assert got.shape == want.shape == (NQ, K)
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    assert recall(gt, want) > 0.5
