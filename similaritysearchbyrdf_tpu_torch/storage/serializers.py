"""Binary codecs: the reference's serializer SPI and record wire formats.

A copy of `similaritysearchbyrdf_tpu/storage/serializers.py` (framework-free),
writing the same bytes. The reference's storage tier defines a
`Serializer<A>` SPI (`Serializer.java`) with packed-varint primitives
(`DataIO.packInt/packLong`, `DataIO.java`) and the mclab codecs
(`utils/Serializers.scala`: Int/Long, (vectorId, hash) pair, SparseVector,
DenseVector). Whole indexes persist as npz (`storage/persist.py`); the wire
formats serve interop with JVM-side tooling.

Format notes (cites into the reference):
  * packLong/packInt (`DataIO.java:60-130`): 7 bits per byte, HIGH bit set
    on all bytes EXCEPT the last, most-significant group first.
  * scalaIntSerializer (`Serializers.scala:16-26`): 4-byte big-endian int.
  * scalaLongSerializer (`Serializers.scala:28-37`): 8-byte big-endian long.
  * vectorIDHashPairSerializer (`Serializers.scala:42-55`):
    writeInt(vectorId) + writeLong(hash) — 4-byte int then 8-byte long.
  * sparse vector (`Serializers.scala:59-81`): writeInt(id), writeInt(size),
    writeInt(nnz), nnz × writeInt(index), nnz × writeDouble(value).
  * dense vector (`Serializers.scala:86-102`): writeInt(id), writeInt(dim),
    dim × writeDouble(value).
  All integer fields of the record codecs are plain DataOutput 4-byte
  big-endian ints (`Serializers.scala` never varint-packs them). Held byte
  for byte against spec-derived golden fixtures (tests/fixtures/*_golden.bin).

One difference from the JAX package: the (id, hash) pair takes the JVM's
signed 64-bit `long` in both directions. The JAX package writes the hash's
unsigned view and reads it back signed, so a hash >= 2**63 does not survive
its round trip there; here the writer maps an unsigned value to the same
signed long (the same bytes) and refuses a value outside 64 bits, and the
reader returns the signed long.

The batch codecs call the native codec (`native/loader.py`) and fall back to
the per-record codecs when it is not built; the bytes are the same.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..native import loader as native


# ---------------------------------------------------------------------------
# DataIO packed varints
# ---------------------------------------------------------------------------


def pack_long(value: int) -> bytes:
    """MapDB packLong: 7-bit groups, MSB-first, continuation bit on all but
    the last byte (`DataIO.java` packLong)."""
    value &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    shift = 63 - (63 % 7)
    started = False
    while shift > 0:
        group = (value >> shift) & 0x7F
        if group or started:
            out.append(0x80 | group)
            started = True
        shift -= 7
    out.append(value & 0x7F)
    return bytes(out)


def unpack_long(buf: bytes, offset: int = 0) -> Tuple[int, int]:
    """Returns (value, new_offset)."""
    value = 0
    while True:
        b = buf[offset]
        offset += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, offset


def pack_int(value: int) -> bytes:
    """MapDB packInt — same scheme over 32 bits."""
    value &= 0xFFFFFFFF
    out = bytearray()
    shift = 31 - (31 % 7)
    started = False
    while shift > 0:
        group = (value >> shift) & 0x7F
        if group or started:
            out.append(0x80 | group)
            started = True
        shift -= 7
    out.append(value & 0x7F)
    return bytes(out)


def unpack_int(buf: bytes, offset: int = 0) -> Tuple[int, int]:
    return unpack_long(buf, offset)


# ---------------------------------------------------------------------------
# mclab codecs (`utils/Serializers.scala`)
# ---------------------------------------------------------------------------


def serialize_int(value: int) -> bytes:
    return struct.pack(">i", value)


def deserialize_int(buf: bytes, offset: int = 0) -> Tuple[int, int]:
    return struct.unpack_from(">i", buf, offset)[0], offset + 4


def serialize_long(value: int) -> bytes:
    return struct.pack(">q", value)


def deserialize_long(buf: bytes, offset: int = 0) -> Tuple[int, int]:
    return struct.unpack_from(">q", buf, offset)[0], offset + 8


def to_signed64(value: int) -> int:
    """The JVM `long` of a 64-bit value given signed or as its unsigned
    view; ValueError outside [-2**63, 2**64)."""
    if not -(1 << 63) <= value < (1 << 64):
        raise ValueError(f"hash {value} does not fit 64 bits")
    return value - (1 << 64) if value >= (1 << 63) else value


def serialize_id_hash_pair(vector_id: int, hash_value: int) -> bytes:
    """writeInt(vectorId) + writeLong(hash) (`Serializers.scala:42-55`);
    `hash_value` may be given signed or as its unsigned view, and is written
    as the signed long of the same bits."""
    return struct.pack(">iq", vector_id, to_signed64(hash_value))


def deserialize_id_hash_pair(buf: bytes, offset: int = 0) -> Tuple[Tuple[int, int], int]:
    """((vectorId, hash as the signed long), new_offset)."""
    vid, h = struct.unpack_from(">iq", buf, offset)
    return (vid, h), offset + 12


def serialize_sparse_vector(
    vector_id: int, size: int, indices: np.ndarray, values: np.ndarray
) -> bytes:
    out = bytearray()
    out += struct.pack(">i", vector_id)
    out += struct.pack(">i", size)
    out += struct.pack(">i", len(indices))
    for i in indices:
        out += struct.pack(">i", int(i))
    for v in values:
        out += struct.pack(">d", float(v))
    return bytes(out)


def deserialize_sparse_vector(
    buf: bytes, offset: int = 0
) -> Tuple[Tuple[int, int, np.ndarray, np.ndarray], int]:
    vid, size, nnz = struct.unpack_from(">iii", buf, offset)
    offset += 12
    idx = np.frombuffer(buf, dtype=">i4", count=nnz, offset=offset).astype(
        np.int32)
    offset += 4 * nnz
    vals = np.frombuffer(buf, dtype=">f8", count=nnz, offset=offset).astype(np.float64)
    offset += 8 * nnz
    return (vid, size, idx, vals), offset


def serialize_dense_vector(vector_id: int, values: np.ndarray) -> bytes:
    out = bytearray()
    out += struct.pack(">i", vector_id)
    out += struct.pack(">i", len(values))
    for v in values:
        out += struct.pack(">d", float(v))
    return bytes(out)


def deserialize_dense_vector(
    buf: bytes, offset: int = 0
) -> Tuple[Tuple[int, np.ndarray], int]:
    vid, dim = struct.unpack_from(">ii", buf, offset)
    offset += 8
    vals = np.frombuffer(buf, dtype=">f8", count=dim, offset=offset).astype(np.float64)
    offset += 8 * dim
    return (vid, vals), offset


# ---------------------------------------------------------------------------
# Batch codecs (native fast path; byte-identical to the per-record codecs)
# ---------------------------------------------------------------------------


def serialize_dense_batch(ids: np.ndarray, values: np.ndarray) -> bytes:
    """Concatenated dense-vector records for a whole corpus. Uses the
    multithreaded native codec (`native/rdf_codec.cc`) when it is built;
    falls back to the per-record python codec. The byte stream is identical
    either way (tested)."""
    out = native.encode_dense_batch(ids, values)
    if out is not None:
        return out
    buf = bytearray()
    for i in range(len(ids)):
        buf += serialize_dense_vector(int(ids[i]), values[i])
    return bytes(buf)


def deserialize_dense_batch(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (ids i32[N], values f64[N, dim])."""
    out = native.decode_dense_batch(buf)
    if out is not None:
        return out
    ids: List[int] = []
    rows: List[np.ndarray] = []
    offset = 0
    while offset < len(buf):
        (vid, vals), offset = deserialize_dense_vector(buf, offset)
        ids.append(vid)
        rows.append(vals)
    return np.asarray(ids, np.int32), np.stack(rows) if rows else np.zeros((0, 0))


def serialize_sparse_batch(
    ids: np.ndarray, size: int, indices: np.ndarray, values: np.ndarray,
    lengths: np.ndarray,
) -> bytes:
    """Concatenated sparse-vector records (padded-COO input; only the first
    lengths[i] entries of row i are encoded)."""
    out = native.encode_sparse_batch(ids, size, indices, values, lengths)
    if out is not None:
        return out
    buf = bytearray()
    for i in range(len(ids)):
        k = int(lengths[i])
        buf += serialize_sparse_vector(
            int(ids[i]), size, indices[i, :k], values[i, :k]
        )
    return bytes(buf)


def deserialize_sparse_batch(
    buf: bytes,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (ids, size, indices [N, max_nnz], values [N, max_nnz],
    lengths [N]) — padded-COO, ready for `vectors.SparseBatch`."""
    out = native.decode_sparse_batch(buf)
    if out is not None:
        return out
    ids: List[int] = []
    rows = []
    size = 0
    offset = 0
    while offset < len(buf):
        (vid, size, idx, vals), offset = deserialize_sparse_vector(buf, offset)
        ids.append(vid)
        rows.append((idx, vals))
    max_nnz = max((len(r[0]) for r in rows), default=0)
    n = len(rows)
    indices = np.zeros((n, max_nnz), np.int32)
    values = np.zeros((n, max_nnz), np.float64)
    lengths = np.zeros(n, np.int32)
    for i, (idx, vals) in enumerate(rows):
        indices[i, :len(idx)] = idx
        values[i, :len(vals)] = vals
        lengths[i] = len(idx)
    return np.asarray(ids, np.int32), size, indices, values, lengths
