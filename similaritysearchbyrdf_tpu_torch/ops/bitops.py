"""32-bit integer and bit utilities for the hash pipeline, on torch tensors.

torch has no usable uint32: shifts, comparisons, `max` and `searchsorted`
are missing for it. The port therefore keeps two representations:

  * a HASH is an int64 tensor holding the unsigned 32-bit value in
    [0, 2**32) (`HASH_DTYPE`); all bit arithmetic runs on it;
  * a stored KEY (sorted composite keys, bucket boundaries) is int32 with
    the sign bit flipped (`to_key`), which keeps the unsigned order, so
    sorts and binary searches run on 4-byte keys and the index's bytes per
    vector stay those of the JAX package's uint32 arrays.
"""

from __future__ import annotations

import torch

HASH_DTYPE = torch.int64
MASK32 = 0xFFFFFFFF
_SIGN = 1 << 31


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → its unsigned 32-bit value as int64."""
    return x.to(HASH_DTYPE) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values → the int32 with the same bits (wraps)."""
    x = as_u32(x)
    return torch.where(x >= _SIGN, x - (1 << 32), x).to(torch.int32)


def to_key(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values (int64) → order-preserving int32 keys."""
    return (x - _SIGN).to(torch.int32)


def from_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_key`: int32 keys → unsigned 32-bit values (int64)."""
    return k.to(HASH_DTYPE) + _SIGN


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Integer.bitCount of the low 32 bits (SWAR), as int32."""
    x = as_u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & MASK32) >> 24).to(torch.int32)


def clz(x: torch.Tensor) -> torch.Tensor:
    """Integer.numberOfLeadingZeros of the low 32 bits (32 for 0), as int32.
    torch has no clz: a five-step binary search on shifts."""
    x = as_u32(x)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = x < (1 << (32 - s))
        n = torch.where(top_clear, n + s, n)
        x = torch.where(top_clear, (x << s) & MASK32, x)
    n = torch.where(x == 0, n + 1, n)
    return n.to(torch.int32)


def pack_bits_msb_first(bits: torch.Tensor, total_bits: int = 32) -> torch.Tensor:
    """Pack 0/1 bits along the last axis, first bit highest: bit j lands at
    bit (total_bits-1-j) (`AngleHashFamily.scala:187-219`). → int64."""
    c = bits.shape[-1]
    shifts = torch.arange(total_bits - 1, total_bits - 1 - c, -1,
                          dtype=HASH_DTYPE, device=bits.device)
    return (bits.to(HASH_DTYPE) << shifts).sum(dim=-1)


def bits_of(x: torch.Tensor, nbits: int = 32) -> torch.Tensor:
    """Explode the low `nbits` bits along a new trailing axis, LSB at index
    0 (`utils/Partitioner.scala:45-49`). → int64 0/1."""
    shifts = torch.arange(nbits, dtype=HASH_DTYPE, device=x.device)
    return (as_u32(x)[..., None] >> shifts) & 1


def java_bytes_hash_of_ints(ints: torch.Tensor) -> torch.Tensor:
    """`java.util.Arrays.hashCode` over the big-endian bytes of the int32
    values along the last axis (`PStableHashFamily.scala:122-177` via
    `ByteArrayWrapper.scala:11-14`): h = 1; h = 31*h + b per signed byte.
    Computed mod 2**32 in int64. → unsigned 32-bit values (int64)."""
    x = as_u32(ints)
    h = torch.ones(x.shape[:-1], dtype=HASH_DTYPE, device=x.device)
    for j in range(x.shape[-1]):
        for shift in (24, 16, 8, 0):
            b = (x[..., j] >> shift) & 0xFF
            b = torch.where(b >= 128, b - 256, b)
            h = (h * 31 + b) & MASK32
    return h


def searchsorted_u32(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Lower-bound positions of unsigned 32-bit `queries` in ascending
    `sorted_keys` (both any integer dtype holding unsigned values), done as
    an int64 `torch.searchsorted`. → int32."""
    return torch.searchsorted(
        as_u32(sorted_keys).contiguous(), as_u32(queries).contiguous(), right=False
    ).to(torch.int32)
