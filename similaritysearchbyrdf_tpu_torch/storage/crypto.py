"""At-rest record encryption (XTEA) + CRC32 integrity.

A copy of `similaritysearchbyrdf_tpu/storage/crypto.py` (numpy on the host),
writing the same bytes.

The reference's store can wrap every serialized record with optional LZF
compression, XTEA encryption and a CRC32 trailer (`Store.java:26-60` flags;
record pipeline `Store.java:296-316` serialize side, `deserializeExtra`
read side; cipher `EncryptionXTEA.java` — 32-round XTEA, subkeys from the
SHA-256 hash of the password, ECB over 8-byte blocks, 16-byte alignment).
This module reproduces that record-wrapping contract for the npz-era
persistence layer:

  wrap:   [pad to 16, XTEA-encrypt, append pad-length byte]  (password)
          [append big-endian CRC32 of everything before it]  (checksum)
  unwrap: verify CRC -> decrypt -> strip padding

The cipher is implemented from the published XTEA algorithm (Needham &
Wheeler 1997; 32 rounds, DELTA = 0x9E3779B9) with the reference's key
schedule (SHA-256(password)[:16] as four big-endian words, subkeys
precomputed as r[2i] = sum + key[sum & 3]; sum += DELTA;
r[2i+1] = sum + key[(sum >>> 11) & 3]) — blocks are processed vectorized
in numpy, so wrapping a multi-MB checkpoint is milliseconds, not a Python
byte loop. CRC32 is `zlib.crc32`, the same polynomial as
`java.util.zip.CRC32`.

`storage/persist.save_forest(password=..., checksum=...)` uses this to
write encrypted/checksummed checkpoints; mismatched open options raise
`WrongConfigError`, mirroring the reference's feature-bit checks
(`Store.java:150-174`) — and unlike the reference there is a real load
path to decrypt into.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Optional

import numpy as np

_DELTA = 0x9E3779B9
_MASK = 0xFFFFFFFF
ALIGN = 16      # EncryptionXTEA.ALIGN — wrapped sizes are 16-multiples


class DataCorruptionError(ValueError):
    """CRC mismatch or malformed wrapped record (the reference raises
    `DBException.DataCorruption`)."""


class WrongConfigError(ValueError):
    """Open options do not match how the artifact was written (the
    reference raises `DBException.WrongConfig`, `Store.java:150-174`)."""


class XTEA:
    """32-round XTEA, ECB over 8-byte blocks, reference key schedule."""

    def __init__(self, password: bytes):
        digest = hashlib.sha256(password).digest()
        key = struct.unpack(">4I", digest[:16])
        subkeys = []
        s = 0
        for _ in range(16):
            subkeys.append((s + key[s & 3]) & _MASK)
            s = (s + _DELTA) & _MASK
            subkeys.append((s + key[(s >> 11) & 3]) & _MASK)
        self._k = np.asarray(subkeys, dtype=np.uint32)

    def _blocks(self, data: bytes) -> np.ndarray:
        if len(data) % 8:
            raise DataCorruptionError(
                f"XTEA data length {len(data)} not an 8-byte multiple")
        return np.frombuffer(data, dtype=">u4").reshape(-1, 2).astype(
            np.uint32)

    def encrypt(self, data: bytes) -> bytes:
        w = self._blocks(data)
        y, z = w[:, 0].copy(), w[:, 1].copy()
        k = self._k
        for r in range(16):
            y = (y + ((((z << 4) ^ (z >> 5)) + z) ^ k[2 * r])) & _MASK
            z = (z + ((((y >> 5) ^ (y << 4)) + y) ^ k[2 * r + 1])) & _MASK
        return self._out(y, z)

    def decrypt(self, data: bytes) -> bytes:
        w = self._blocks(data)
        y, z = w[:, 0].copy(), w[:, 1].copy()
        k = self._k
        for r in range(15, -1, -1):
            z = (z - ((((y >> 5) ^ (y << 4)) + y) ^ k[2 * r + 1])) & _MASK
            y = (y - ((((z << 4) ^ (z >> 5)) + z) ^ k[2 * r])) & _MASK
        return self._out(y, z)

    @staticmethod
    def _out(y: np.ndarray, z: np.ndarray) -> bytes:
        out = np.empty((y.shape[0], 2), dtype=">u4")
        out[:, 0] = y
        out[:, 1] = z
        return out.tobytes()


def wrap_record(
    data: bytes,
    password: Optional[bytes] = None,
    checksum: bool = False,
) -> bytes:
    """Apply the reference's record-wrapping pipeline (`Store.java:
    296-316`): encrypt (pad to 16, ECB, append the pad-length byte), then
    append the big-endian CRC32 of everything before it."""
    out = data
    if password is not None:
        pad = (-len(out)) % ALIGN
        padded = out + b"\x00" * pad
        out = XTEA(password).encrypt(padded) + bytes([pad])
    if checksum:
        out = out + struct.pack(">I", zlib.crc32(out) & _MASK)
    return out


def unwrap_record(
    data: bytes,
    password: Optional[bytes] = None,
    checksum: bool = False,
) -> bytes:
    """Reverse `wrap_record`, verifying the CRC first (the read order of
    `Store.deserializeExtra`)."""
    out = data
    if checksum:
        if len(out) < 4:
            raise DataCorruptionError("record shorter than its CRC32")
        body, crc = out[:-4], struct.unpack(">I", out[-4:])[0]
        if (zlib.crc32(body) & _MASK) != crc:
            raise DataCorruptionError("CRC32 checksum mismatch")
        out = body
    if password is not None:
        if len(out) < 1 or (len(out) - 1) % ALIGN:
            raise DataCorruptionError(
                f"encrypted record length {len(out)} malformed")
        pad = out[-1]
        if pad >= ALIGN:
            raise DataCorruptionError(f"invalid pad length {pad}")
        plain = XTEA(password).decrypt(out[:-1])
        out = plain[: len(plain) - pad] if pad else plain
    return out
