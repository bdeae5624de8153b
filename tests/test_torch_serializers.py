"""The port's record codecs (`similaritysearchbyrdf_tpu_torch/storage/serializers.py`)
against the golden fixtures and the JAX package's codecs, byte for byte.

The golden files are renderings of the JVM wire formats made from the format
spec (java.io.DataOutput and MapDB DataIO varints), not by either package's
codecs. The one place the port departs from the JAX package is the
(id, hash) pair's reader: both packages write the same bytes, but the JAX
package reads back a hash >= 2**63 as a different (signed) number than it
was given, where the port takes the JVM's signed long both ways.
"""

import os

import numpy as np
import pytest

from similaritysearchbyrdf_tpu.storage import serializers as J
from similaritysearchbyrdf_tpu_torch.native import loader as native
from similaritysearchbyrdf_tpu_torch.storage import serializers as S

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    with open(os.path.join(_FIX, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("v", [0, 1, 127, 128, 255, 16383, 16384, 2**31 - 1])
def test_pack_int_roundtrip_and_jax_bytes(v):
    buf = S.pack_int(v)
    assert buf == J.pack_int(v)
    assert S.unpack_int(buf) == (v, len(buf))


@pytest.mark.parametrize("v", [0, 1, 127, 128, 2**31, 2**63 - 1])
def test_pack_long_roundtrip_and_jax_bytes(v):
    buf = S.pack_long(v)
    assert buf == J.pack_long(v)
    assert S.unpack_long(buf) == (v, len(buf))


def test_pack_int_known_encodings():
    assert S.pack_int(0) == bytes([0x00])
    assert S.pack_int(127) == bytes([0x7F])
    assert S.pack_int(128) == bytes([0x81, 0x00])
    assert S.pack_int(300) == bytes([0x82, 0x2C])


def test_golden_packed_varints():
    golden = _fixture("packed_varints_golden.bin")
    ints = [0, 1, 127, 128, 300, 16383, 16384, 2**31 - 1]
    longs = [0, 1, 127, 128, 2**31, 2**63 - 1]
    assert b"".join(map(S.pack_int, ints)) + b"".join(map(S.pack_long, longs)) == golden
    off = 0
    for v in ints:
        got, off = S.unpack_int(golden, off)
        assert got == v
    for v in longs:
        got, off = S.unpack_long(golden, off)
        assert got == v
    assert off == len(golden)


def test_golden_dense_vectors():
    golden = _fixture("densevectors_golden.bin")
    recs = [(3, np.array([1.0, 2.0, 3.0])), (4, np.array([4.0, 5.0, 6.0])),
            (2**31 - 1, np.array([-0.3333333333333333, 1e300]))]
    assert b"".join(S.serialize_dense_vector(v, x) for v, x in recs) == golden
    off = 0
    for vid, vals in recs:
        (got_id, got_vals), off = S.deserialize_dense_vector(golden, off)
        assert got_id == vid
        np.testing.assert_array_equal(got_vals, vals)
    assert off == len(golden)


def test_golden_sparse_vectors():
    golden = _fixture("sparsevectors_golden.bin")
    recs = [(3, 3, np.array([0, 1, 2]), np.array([1.0, 2.0, 3.0])),
            (5, 2, np.array([0, 1]), np.array([1.0, 2.0])),
            (7, 1 << 20, np.array([(1 << 20) - 1]), np.array([-2.5]))]
    assert b"".join(S.serialize_sparse_vector(*r) for r in recs) == golden
    off = 0
    for vid, size, idx, vals in recs:
        (gid, gsize, gidx, gvals), off = S.deserialize_sparse_vector(golden, off)
        assert (gid, gsize) == (vid, size)
        np.testing.assert_array_equal(gidx, idx)
        np.testing.assert_array_equal(gvals, vals)
    assert off == len(golden)


def test_golden_id_hash_pairs():
    """The golden pairs, each hash given as the JVM long: the bytes, and
    the reader returns the same longs."""
    golden = _fixture("idhashpairs_golden.bin")
    recs = [(42, 0x12345678), (0, -1), (-7, 2**63 - 1)]
    assert b"".join(S.serialize_id_hash_pair(v, h) for v, h in recs) == golden
    off = 0
    for rec in recs:
        got, off = S.deserialize_id_hash_pair(golden, off)
        assert got == rec
    assert off == len(golden)


@pytest.mark.parametrize("h", [2**63, 2**63 + 5, 2**64 - 1, 0xDEADBEEFCAFEF00D])
def test_id_hash_pair_is_signed_both_ways(h):
    """A hash >= 2**63 given as its unsigned view is written as the signed
    long of the same bits (the JAX package's bytes) and read back as that
    long, which writes the same bytes again. The JAX package reads the same
    bytes back as a number other than the one it was given."""
    signed = h - 2**64
    buf = S.serialize_id_hash_pair(9, h)
    assert buf == J.serialize_id_hash_pair(9, h) == S.serialize_id_hash_pair(9, signed)
    assert S.deserialize_id_hash_pair(buf) == ((9, signed), 12)
    assert S.serialize_id_hash_pair(*S.deserialize_id_hash_pair(buf)[0]) == buf
    assert J.deserialize_id_hash_pair(J.serialize_id_hash_pair(9, h))[0] != (9, h)


@pytest.mark.parametrize("h", [2**64, -(2**63) - 1])
def test_id_hash_pair_refuses_values_outside_64_bits(h):
    """The JAX package masks such a hash silently to its low 64 bits."""
    with pytest.raises(ValueError):
        S.serialize_id_hash_pair(1, h)


def test_record_codecs_match_jax_on_random_inputs():
    rng = np.random.default_rng(5)
    for _ in range(20):
        vid = int(rng.integers(-2**31, 2**31))
        h = int(rng.integers(-2**63, 2**63))
        assert S.serialize_id_hash_pair(vid, h) == J.serialize_id_hash_pair(vid, h)
        assert S.serialize_int(vid) == J.serialize_int(vid)
        assert S.serialize_long(h) == J.serialize_long(h)
        vals = rng.normal(size=int(rng.integers(0, 40))) * 10.0 ** rng.integers(-30, 30)
        assert S.serialize_dense_vector(vid, vals) == J.serialize_dense_vector(vid, vals)
        size = int(rng.integers(1, 5000))
        nnz = int(rng.integers(0, min(size, 30) + 1))
        idx = np.sort(rng.choice(size, nnz, replace=False))
        sv = rng.normal(size=nnz)
        buf = S.serialize_sparse_vector(vid, size, idx, sv)
        assert buf == J.serialize_sparse_vector(vid, size, idx, sv)
        (gid, gsize, gidx, gvals), off = S.deserialize_sparse_vector(buf)
        assert (gid, gsize, off) == (vid, size, len(buf))
        np.testing.assert_array_equal(gidx, idx)
        np.testing.assert_array_equal(gvals, sv)


def test_dense_batch_codec_matches_per_record_and_jax():
    """The batch codec (native) gives the per-record codec's bytes, the JAX
    package's batch bytes, and decodes back."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 2**31 - 1, 200).astype(np.int32)
    values = rng.normal(size=(200, 24))
    calls = native.CALLS
    batch = S.serialize_dense_batch(ids, values)
    assert native.CALLS == calls + 1, "the native codec was not used"
    assert batch == b"".join(S.serialize_dense_vector(int(ids[i]), values[i])
                             for i in range(len(ids)))
    assert batch == J.serialize_dense_batch(ids, values)
    ids2, values2 = S.deserialize_dense_batch(batch)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(values2, values)


def test_sparse_batch_codec_matches_per_record_and_jax():
    rng = np.random.default_rng(1)
    n, dim, max_nnz = 150, 512, 12
    ids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    lengths = rng.integers(1, max_nnz + 1, n).astype(np.int32)
    indices = np.zeros((n, max_nnz), np.int32)
    values = np.zeros((n, max_nnz), np.float64)
    for i in range(n):
        indices[i, :lengths[i]] = np.sort(rng.choice(dim, size=lengths[i], replace=False))
        values[i, :lengths[i]] = rng.normal(size=lengths[i])
    batch = S.serialize_sparse_batch(ids, dim, indices, values, lengths)
    assert batch == b"".join(S.serialize_sparse_vector(int(ids[i]), dim, indices[i, :lengths[i]],
                                                       values[i, :lengths[i]]) for i in range(n))
    assert batch == J.serialize_sparse_batch(ids, dim, indices, values, lengths)
    ids2, size2, idx2, val2, len2 = S.deserialize_sparse_batch(batch)
    assert size2 == dim
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(len2, lengths)
    for i in range(n):
        np.testing.assert_array_equal(idx2[i, :lengths[i]], indices[i, :lengths[i]])
        np.testing.assert_array_equal(val2[i, :lengths[i]], values[i, :lengths[i]])
