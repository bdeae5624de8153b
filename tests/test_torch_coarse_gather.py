"""Port vs JAX package: block-mode coarse scoring (K2's plain version) and
the lane-packed → per-table tier conversion.

Both sides multiply int8 tier values by bf16 query values exactly in f32
and differ only in summation order, so each score may differ by at most
(n_a + n_b) * 2^-24 * sum_c |tier_c * q_c|, where n_a and n_b are the
number of terms each side sums (128 lanes for the JAX package's
lane-packed dot, cs for the port)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu.index import forest as jforest
from similaritysearchbyrdf_tpu.ops.pallas import coarse_gather as jcg
from similaritysearchbyrdf_tpu_torch.index import forest as tforest
from similaritysearchbyrdf_tpu_torch.interop import unpack_lane_tier
from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2

U = 2.0 ** -24


def bf16_round(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def abs_bound(tier, q_low, table, start, bs, n_terms):
    """n_terms * u * sum_c |tier * q| for every score."""
    s = K2.coarse_block_scores_plain(torch.from_numpy(np.abs(tier)),
                                     torch.from_numpy(np.abs(q_low)).to(torch.bfloat16),
                                     torch.from_numpy(table), torch.from_numpy(start), bs)
    return n_terms * U * s.numpy()


@pytest.mark.parametrize("l,cs", [(6, 32), (8, 16), (3, 64)])
def test_block_scores_match_jax(l, cs):
    """`_coarse_block_scores` in block mode: JAX on the lane-packed tier,
    the port on the same tier unpacked per table. Block starts past both
    ends of the tier exercise the CLIP gather. Tables are in range: the
    JAX package clips the lane GROUP, so an out-of-range table reads a
    neighbour's segment there, which no caller produces."""
    rng = np.random.default_rng(l * cs)
    g = 128 // cs
    lg, caprows, d, b, mb, bs = -(-l // g), 160, 24, 5, 16, 8
    packed = rng.integers(-127, 128, size=(lg, caprows, g * cs)).astype(np.int8)
    per_table = unpack_lane_tier(packed, l, cs)
    proj = rng.normal(size=(d, cs)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    mbi = np.arange(mb) * bs
    blk_start = rng.integers(-12, caprows + 12, size=(b, mb))
    base = (blk_start - mbi).astype(np.int32)
    table = rng.integers(0, l, size=(b, mb)).astype(np.int32)
    end = (blk_start + rng.integers(-4, 12, size=(b, mb))).astype(np.int32)
    want_s, want_p, want_t = (np.asarray(a) for a in jforest._coarse_block_scores(
        jnp.asarray(packed), jnp.asarray(proj), jnp.asarray(queries), jnp.asarray(base),
        jnp.asarray(table), jnp.asarray(end), bs))
    got_s, got_p, got_t = (a.numpy() for a in tforest._coarse_block_scores(
        torch.from_numpy(per_table), torch.from_numpy(proj), torch.from_numpy(queries),
        torch.from_numpy(base).long(), torch.from_numpy(table).long(),
        torch.from_numpy(end).long(), bs))
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_t, want_t)
    live = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), live)
    assert 0.2 < live.mean() < 0.9
    q_low = bf16_round(queries @ proj)
    bound = abs_bound(per_table, q_low, table,
                      (base + mbi).astype(np.int32), bs, 128 + cs).reshape(b, -1)
    assert (np.abs(got_s[live] - want_s[live]) <= bound[live] + 1e-30).all()


@pytest.mark.parametrize("l,cs", [(6, 32), (3, 64)])
def test_block_scores_match_jax_on_a_bf16_tier(l, cs):
    """`_coarse_block_scores` in block mode over a bf16 tier (coarse_dtype
    "bfloat16"): JAX on the lane-packed tier, the port's plain K2 on the
    same tier unpacked per table. bf16 x bf16 products are exact in f32
    too, so the same summation-order bound holds."""
    rng = np.random.default_rng(l + cs)
    g = 128 // cs
    lg, caprows, d, b, mb, bs = -(-l // g), 160, 24, 5, 16, 8
    packed = bf16_round(rng.normal(size=(lg, caprows, g * cs)).astype(np.float32))
    per_table = unpack_lane_tier(packed, l, cs)
    proj = rng.normal(size=(d, cs)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    mbi = np.arange(mb) * bs
    blk_start = rng.integers(-12, caprows + 12, size=(b, mb))
    base = (blk_start - mbi).astype(np.int32)
    table = rng.integers(0, l, size=(b, mb)).astype(np.int32)
    end = (blk_start + rng.integers(-4, 12, size=(b, mb))).astype(np.int32)
    want_s, want_p, want_t = (np.asarray(a) for a in jforest._coarse_block_scores(
        jnp.asarray(packed).astype(jnp.bfloat16), jnp.asarray(proj), jnp.asarray(queries),
        jnp.asarray(base), jnp.asarray(table), jnp.asarray(end), bs))
    got_s, got_p, got_t = (a.numpy() for a in tforest._coarse_block_scores(
        torch.from_numpy(per_table).to(torch.bfloat16), torch.from_numpy(proj),
        torch.from_numpy(queries), torch.from_numpy(base).long(),
        torch.from_numpy(table).long(), torch.from_numpy(end).long(), bs))
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_t, want_t)
    live = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), live)
    assert 0.2 < live.mean() < 0.9
    q_low = bf16_round(queries @ proj)
    s_abs = K2.coarse_block_scores_plain(
        torch.from_numpy(np.abs(per_table)).to(torch.bfloat16),
        torch.from_numpy(np.abs(q_low)).to(torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy((base + mbi).astype(np.int32)), bs).numpy().reshape(b, -1)
    bound = (128 + cs) * U * s_abs
    assert (np.abs(got_s[live] - want_s[live]) <= bound[live] + 1e-30).all()


def test_plain_matches_pallas_coarse_scores(monkeypatch):
    """The TPU kernel K2 replaces (`pallas_coarse_scores`, interpret mode on
    the CPU) against the port's plain version, at arbitrary block starts."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcg.pl, "pallas_call", interpret)
    rng = np.random.default_rng(1)
    l, cap, cd, b, mb, bs = 3, 128, 32, 3, 8, 8
    cbt = rng.integers(-127, 128, size=(l, cap, cd)).astype(np.int8)
    q = rng.normal(size=(b, cd)).astype(np.float32)
    tb = rng.integers(0, l, size=(b, mb)).astype(np.int32)
    st = rng.integers(0, cap - 2 * bs, size=(b, mb)).astype(np.int32)
    want = np.asarray(jcg.pallas_coarse_scores(jnp.asarray(cbt), jnp.asarray(q),
                                                jnp.asarray(tb), jnp.asarray(st), bs, grp=8))
    q_low = torch.from_numpy(q).to(torch.bfloat16)
    got = K2.coarse_block_scores_kernel(torch.from_numpy(cbt), q_low, torch.from_numpy(tb),
                                        torch.from_numpy(st), bs).numpy()
    bound = abs_bound(cbt, bf16_round(q), tb, st, bs, 2 * cd)
    assert (np.abs(got - want) <= bound + 1e-30).all()


@pytest.mark.parametrize("l,cd", [(6, 32), (10, 16), (4, 60)])
def test_lane_unpack_is_exact(l, cd):
    """Unpacking the JAX package's lane-packed tier gives, for every table,
    exactly its quantized coarse rows in that table's sorted order; the
    port's own tier build matches it up to quantization ties (one count)."""
    rng = np.random.default_rng(cd)
    n, d, cap = 200, 64, 232
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    sorted_ids = np.stack([np.concatenate([rng.permutation(n), -np.ones(cap - n, int)])
                           for _ in range(l)]).astype(np.int32)
    proj, packed = jforest._build_coarse_tier(jnp.asarray(corpus), jnp.asarray(sorted_ids),
                                              cd, "int8", seed=3)
    proj = np.asarray(proj)
    cs = proj.shape[1]
    low = np.asarray(jforest._coarse_low(jnp.asarray(proj), jnp.asarray(corpus), True))
    want = np.where((sorted_ids >= 0)[..., None], low[np.maximum(sorted_ids, 0)], 0)
    got = unpack_lane_tier(np.asarray(packed), l, cs)
    np.testing.assert_array_equal(got, want)
    tproj, ttier = tforest._build_coarse_tier(torch.from_numpy(corpus),
                                              torch.from_numpy(sorted_ids), cd, "int8", seed=3)
    np.testing.assert_array_equal(tproj.numpy(), proj)
    diff = np.abs(ttier.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_kernel_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    tier = torch.from_numpy(rng.integers(-127, 128, size=(2, 40, 16)).astype(np.int8))
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)).to(torch.bfloat16)
    tb = torch.from_numpy(rng.integers(0, 2, size=(3, 4)).astype(np.int32))
    st = torch.from_numpy(rng.integers(0, 33, size=(3, 4)).astype(np.int32))
    before = K2.LAUNCHES
    out = K2.coarse_block_scores_kernel(tier, q, tb, st, 8)
    assert out.shape == (3, 4, 8) and out.dtype == torch.float32
    assert torch.equal(out, K2.coarse_block_scores_plain(tier, q, tb, st, 8))
    assert K2.LAUNCHES == before
    with pytest.raises(ValueError):
        K2.coarse_block_scores_kernel(tier.to("meta"), q.to("meta"), tb.to("meta"),
                                      st.to("meta"), 8)
