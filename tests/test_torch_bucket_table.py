"""Port vs JAX package: bucket tables built from the same composite keys
must hold the same arrays (port keys are the order-preserving int32 image
of the uint32 keys), and probe lookups must give the same ranges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.index import bucket_table as jbt
from similaritysearchbyrdf_tpu_torch.index import bucket_table as tbt
from similaritysearchbyrdf_tpu_torch.ops.bitops import from_key, to_key


def layouts(partition_bits=3, dir_node_size=32):
    kw = dict(partition_bits=partition_bits)
    jt = jcfg.TableConfig(dir_node_size=dir_node_size)
    tt = tcfg.TableConfig(dir_node_size=dir_node_size)
    return (jbt.KeyLayout.from_config(jcfg.RDFConfig(**kw, lsh_table=jt), jt),
            tbt.KeyLayout.from_config(tcfg.RDFConfig(**kw, lsh_table=tt), tt))


def clustered_keys(l, n, n_valid, seed, layout):
    """u32 keys with heavy prefix sharing, so buckets split at several
    depths; padding rows are all-ones with id -1."""
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 6, size=(l, n)).astype(np.uint64) << np.uint64(layout.total_bits - 4)
    low = rng.integers(0, 1 << (layout.total_bits - 9), size=(l, n)).astype(np.uint64)
    keys = (top | low).astype(np.uint32)
    ids = np.broadcast_to(np.where(np.arange(n) < n_valid, np.arange(n), -1), (l, n))
    keys[:, n_valid:] = 0xFFFFFFFF
    return keys, ids.astype(np.int32)


def u32(t):
    return from_key(t).numpy() if t.dtype == torch.int32 else t.numpy()


@pytest.fixture(scope="module")
def built():
    jl, tl = layouts()
    keys, ids = clustered_keys(4, 3072, 3000, 0, jl)
    jt = jbt.build_tables(jnp.asarray(keys), jnp.asarray(ids), jl, 40)
    tt = tbt.build_tables(to_key(torch.from_numpy(keys.astype(np.int64))),
                          torch.from_numpy(ids), tl, 40)
    return jl, tl, jt, tt, keys


def test_build_tables_equal(built):
    _, _, jt, tt, _ = built
    np.testing.assert_array_equal(u32(tt.sorted_keys), np.asarray(jt.sorted_keys))
    np.testing.assert_array_equal(tt.sorted_ids.numpy(), np.asarray(jt.sorted_ids))
    np.testing.assert_array_equal(u32(tt.bucket_keys), np.asarray(jt.bucket_keys))
    np.testing.assert_array_equal(tt.bucket_starts.numpy(), np.asarray(jt.bucket_starts))
    np.testing.assert_array_equal(tt.bucket_shifts.numpy(), np.asarray(jt.bucket_shifts))
    rec, jrec = tt.records.numpy(), np.asarray(jt.records)
    np.testing.assert_array_equal(rec[..., 1:], jrec[..., 1:])
    np.testing.assert_array_equal(
        from_key(torch.from_numpy(rec[..., 0])).numpy(), jrec[..., 0].view(np.uint32))
    assert len(np.unique(np.asarray(jt.bucket_shifts))) > 1      # several depths
    assert tt.index_bytes() == jt.index_bytes()


def test_composite_keys_equal():
    jl, tl = layouts()
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2**32, size=(64, 6), dtype=np.uint64).astype(np.uint32)
    p = rng.integers(0, 8, size=(64, 6)).astype(np.int32)
    want = np.asarray(jbt.composite_keys(jnp.asarray(h), jnp.asarray(p), jl))
    got = tbt.composite_keys(torch.from_numpy(h.astype(np.int64)), torch.from_numpy(p), tl)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("records", [True, False])
def test_lookup_ranges_equal(built, records):
    """The port always looks up through the packed records; the JAX
    package has a records path and a generic one, and both must agree."""
    _, _, jt, tt, keys = built
    if not records:
        jt = jbt.BucketTables(**{**jt.__dict__, "records": None})
    rng = np.random.default_rng(2)
    l = keys.shape[0]
    per_table = 24
    # half the probes are member keys (some with flipped low bits), half random
    member = keys[np.arange(l)[:, None], rng.integers(0, 3000, size=(l, per_table))]
    member ^= (rng.random(member.shape) < 0.5).astype(np.uint32) << np.uint32(3)
    rand = rng.integers(0, 2**32, size=(l, per_table), dtype=np.uint64).astype(np.uint32)
    probes_t = np.where(np.arange(per_table) % 2 == 0, member, rand)   # [L, pt]
    b = 5
    probes = np.stack([np.roll(probes_t, i, axis=1) for i in range(b)])  # [B, L, pt]
    probes = probes.reshape(b, l * per_table)
    table_of = np.repeat(np.arange(l, dtype=np.int32), per_table)
    js, jlen = jbt.lookup_ranges(jt, jnp.asarray(probes), jnp.asarray(table_of))
    ts, tlen = tbt.lookup_ranges(tt, torch.from_numpy(probes.astype(np.int64)))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    live = np.asarray(jlen) > 0
    assert live.mean() > 0.3
    np.testing.assert_array_equal(ts.numpy()[live], np.asarray(js)[live])


def test_decimated_rank_matches_searchsorted():
    """Wide bucket arrays take the two-level rank; it must equal the exact
    rank, including probes below the first and above the last boundary."""
    rng = np.random.default_rng(3)
    l, nb, q = 3, 64 * 160, 300
    bk = np.sort(rng.integers(-2**31, 2**31 - 1, size=(l, nb)), axis=1).astype(np.int32)
    qs = rng.integers(-2**31, 2**31 - 1, size=(l, q)).astype(np.int32)
    qs[:, :3] = bk[:, :3]
    qs[:, 3] = -2**31
    qs[:, 4] = 2**31 - 1
    bk_t, q_t = torch.from_numpy(bk), torch.from_numpy(qs)
    assert nb > max(4096, 2 * q)
    np.testing.assert_array_equal(
        tbt._rank(bk_t, q_t).numpy(),
        torch.searchsorted(bk_t, q_t, right=True).numpy() - 1)


@pytest.mark.parametrize("partition_bits,dir_node_size", [(3, 32), (3, 128), (0, 64)])
def test_key_layout_equal(partition_bits, dir_node_size):
    jl, tl = layouts(partition_bits, dir_node_size)
    assert jl.__dict__ == tl.__dict__
    assert [jl.depth_shift(d) for d in range(jl.num_levels)] == [
        tl.depth_shift(d) for d in range(tl.num_levels)]
