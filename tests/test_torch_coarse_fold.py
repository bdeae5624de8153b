"""Port vs JAX package: the slot-folded coarse tier and the groupmax query.

The folded view of the port's per-table tier against `_build_folded_tier`,
K3's plain version against the JAX package's `rowmax_fallback` and against
the TPU kernel `pallas_coarse_rowmax` in interpret mode (all integer-exact,
so bit for bit), and folded queries end to end on the identical index:
rows_keep 0/1/2, select_mult dedup and the stage2 rerank. End-to-end ids
must be equal on >= 99% of queries and recall@10 within 0.005 (the exact
rerank's f32 sums and the query's int8 quantization may round apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import forest as jforest
from similaritysearchbyrdf_tpu.ops.pallas import coarse_fold as jcf
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch as TBatch
from similaritysearchbyrdf_tpu_torch import from_jax_state
from similaritysearchbyrdf_tpu_torch.index import forest as tforest
from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3

from test_torch_forest import jax_state_arrays, recall

N, D, NQ, K = 6000, 32, 64, 10


def confs(**kw):
    base = dict(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                partition_bits=3, query_batch_size=32, max_candidates=4096, top_k=K,
                seed=5, use_pallas_hash=True, coarse_dim=16, coarse_dtype="int8",
                coarse_layout="folded", coarse_refine=512, coarse_window=256)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=32,
                                                              bucket_overflow=64)))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(64, D))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 64, N)] + 0.1 * rng.normal(size=(N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    ids = np.arange(N, dtype=np.int32)
    jc, tc = confs()
    jf = jforest.RDFForest(jc).fit(JBatch(ids, x))
    port = tforest.RDFForest(tc, device="cpu")
    port.state = from_jax_state(jax_state_arrays(jf.state), tc, device="cpu")
    gt, _ = exact_search(x, x[:NQ], K, exclude_self=True, device="cpu")
    return {"x": x, "ids": ids, "gt": gt, "jc": jc, "tc": tc, "jf": jf, "port": port}


def test_folded_view_matches_jax(world):
    """The port's folded tier is a view of its per-table tier, and carried
    over from the JAX package it is bit-equal to `_build_folded_tier`'s."""
    js, st = world["jf"].state, world["port"].state
    folded = st.coarse_folded
    assert st.coarse_layout == "folded" and folded.dtype == torch.int8
    assert folded.data_ptr() == st.coarse_tier.data_ptr()      # a view, no copy
    np.testing.assert_array_equal(folded.numpy(), np.asarray(js.coarse_folded))
    np.testing.assert_array_equal(st.coarse_proj.numpy(), np.asarray(js.coarse_proj))


def test_own_folded_fit_matches_jax(world):
    """The port's own folded fit: the same tables, and a tier equal to the
    JAX package's up to quantization ties (one count, rarely)."""
    x, ids, tc, js = world["x"], world["ids"], world["tc"], world["jf"].state
    own = tforest.fit_dense(tc, TBatch(ids, x), device="cpu")
    np.testing.assert_array_equal(own.tables.sorted_ids.numpy(),
                                  np.asarray(js.tables.sorted_ids))
    assert own.coarse_head is None
    diff = np.abs(own.coarse_folded.numpy().astype(int)
                  - np.asarray(js.coarse_folded).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_folded_requires_int8(world):
    x, ids, tc = world["x"], world["ids"], world["tc"]
    with pytest.raises(ValueError):
        tforest.fit_dense(tc.replace(coarse_dtype="bfloat16"), TBatch(ids, x), device="cpu")


def _rowmax_inputs(seed, rpg, cs=16, b=4, mb=12, wpr=16, capf=256, l=3):
    rng = np.random.default_rng(seed)
    lanes = 128
    fold = lanes // cs
    folded = rng.integers(-127, 128, (l, capf, lanes), dtype=np.int8)
    qi8 = rng.integers(-127, 128, (b, cs), dtype=np.int8)
    table = rng.integers(0, l, (b, mb)).astype(np.int32)
    # 8-aligned row starts, some past capf - wpr (clipped to the table's
    # end, which is 8-aligned here) and some dead
    rs = (rng.integers(0, (capf - wpr) // 8 + 3, (b, mb)) * 8).astype(np.int32)
    rs = np.where(rng.random((b, mb)) < 0.25, -1, rs).astype(np.int32)
    rs[0, :2] = (capf - wpr + 8, -1)
    qmat = np.zeros((b, fold, lanes), np.int8)
    for s in range(fold):
        qmat[:, s, s * cs:(s + 1) * cs] = qi8
    gsl = rpg * fold
    return folded, qi8, qmat, table, rs, wpr, rpg, gsl.bit_length() - 1


def _torch_rowmax(folded, qi8, table, rs, wpr, rpg, mshift, emit2):
    before = K3.LAUNCHES
    out = K3.coarse_rowmax_kernel(*(torch.from_numpy(a) for a in (folded, qi8, table, rs)),
                                  wpr, rpg, mshift, emit2)
    assert K3.LAUNCHES == before                  # CPU tensors take the plain version
    return tuple(o.numpy() for o in out) if emit2 else (out.numpy(),)


@pytest.mark.parametrize("rpg", [1, 2, 8])
@pytest.mark.parametrize("emit2", [False, True])
@pytest.mark.parametrize("cs", [16, 32])
def test_rowmax_plain_matches_fallback(rpg, emit2, cs):
    """K3's plain version against `rowmax_fallback`, every row, bit for bit
    (dead windows are I32_DEAD in both)."""
    folded, qi8, qmat, table, rs, wpr, rpg, mshift = _rowmax_inputs(rpg * 7 + cs, rpg, cs)
    want = jcf.rowmax_fallback(jnp.asarray(folded), jnp.asarray(qmat), jnp.asarray(table),
                               jnp.asarray(rs), wpr=wpr, rpg=rpg, mshift=mshift, emit2=emit2)
    want = tuple(np.asarray(w) for w in (want if emit2 else (want,)))
    got = _torch_rowmax(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[0] == K3.I32_DEAD).any()


@pytest.mark.parametrize("rpg,emit2", [(1, True), (2, False), (8, False), (8, True)])
def test_rowmax_plain_matches_pallas(monkeypatch, rpg, emit2):
    """The TPU kernel K3 replaces (`pallas_coarse_rowmax`, interpret mode)
    against the plain version, on live windows (the TPU kernel leaves dead
    windows' rows undefined; the port defines them as I32_DEAD)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcf.pl, "pallas_call", interpret)
    folded, qi8, qmat, table, rs, wpr, rpg, mshift = _rowmax_inputs(rpg + 100, rpg)
    want = jcf.pallas_coarse_rowmax(jnp.asarray(folded), jnp.asarray(qmat),
                                    jnp.asarray(table), jnp.asarray(rs), wpr=wpr, rpg=rpg,
                                    mshift=mshift, emit2=emit2)
    want = tuple(np.asarray(w) for w in (want if emit2 else (want,)))
    got = _torch_rowmax(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
    live = np.repeat(rs >= 0, wpr, axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[live], w[live])
        assert (g[~live] == K3.I32_DEAD).all()


@pytest.mark.parametrize("rows_keep,select_mult,stage2,group,extra", [
    (0, 1, 0, 64, {}), (1, 1, 0, 64, {}), (2, 1, 0, 64, {}), (2, 1, 0, 8, {}),
    (0, 2, 0, 64, {}), (0, 1, 160, 64, {}), (0, 2, 160, 8, {}),
    (1, 1, 0, 8, dict(m_cap=256, coarse_window=64))])
def test_folded_query_matches_jax(world, rows_keep, select_mult, stage2, group, extra):
    """Folded queries end to end on the identical index. Group 8 at cs 16 is
    rpg 1: rows_keep 2 then takes the kernel's second output (emit2). The
    32-group select of the last case is too narrow for the packed select
    and takes the two-operand sort."""
    jf, port, x, ids, gt = (world[k] for k in ("jf", "port", "x", "ids", "gt"))
    kw = dict(steps=1, query_ids=ids[:NQ], probe_mode="margin", probe_budget=16,
              rows_keep=rows_keep, select_mult=select_mult, stage2=stage2,
              coarse_group=group, **extra)
    want, want_s = jf.query(x[:NQ], **kw)
    got, got_s = port.query(x[:NQ], **kw)
    assert got.shape == want.shape == (NQ, K)
    assert (got == want).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert abs(recall(gt, got) - recall(gt, want)) <= 0.005
    # reranking only each group's best slots under-recalls on bucket-sorted
    # groups, which co-locate true neighbours (the JAX package's docstring)
    assert recall(gt, want) > (0.5 if rows_keep == 0 else 0.15 if not extra else 0.05)


@pytest.mark.parametrize("m,width", [(96, 40), (300, 64)])
def test_dedup_selected_packed_and_exact_agree(m, width):
    """`_dedup_selected`'s packed one-key sorts (cap < 2^27) and its exact
    two-key sorts (larger caps) lead with the same ids in the same order
    when the select rank needs no quantization: each id's first copy, in
    select order, truncated to `width`. Past the unique ids the packed
    branch pads with -1 and the exact one, as in the JAX package, with
    later copies, which the rerank's dedup drops."""
    rng = np.random.default_rng(m)
    cand2 = rng.integers(-1, m // 3, size=(5, m))
    got_packed = tforest._dedup_selected(torch.from_numpy(cand2), 5000, width).numpy()
    got_exact = tforest._dedup_selected(torch.from_numpy(cand2), 2**28, width).numpy()
    for row, packed, exact in zip(cand2, got_packed, got_exact):
        firsts = list(dict.fromkeys(int(v) for v in row if v >= 0))[:width]
        n = len(firsts)
        np.testing.assert_array_equal(packed, firsts + [-1] * (width - n))
        np.testing.assert_array_equal(exact[:n], firsts)
        assert set(exact[n:].tolist()) <= set(firsts) | {-1}


def test_folded_default_window_matches_jax(world):
    """The default window rule (coarse_window -1) picks the same window in
    both packages; steps 0, reference probes."""
    jf, port, x, ids = (world[k] for k in ("jf", "port", "x", "ids"))
    kw = dict(query_ids=ids[:NQ], coarse_window=-1, rows_keep=0)
    want, _ = jf.query(x[:NQ], **kw)
    got, _ = port.query(x[:NQ], **kw)
    assert (got == want).all(axis=1).mean() >= 0.99
