"""typeOfIndex hash post-transforms on int64 hash tensors.

The reference selects one transform of the raw 32-bit compound hash via
`mclab.lsh.typeOfIndex` (`LSH.scala:110-120`): original (identity),
sampling (`Sampling.scala:32-39`), continueBitsCount
(`significantBits.scala:11-67`), angleNewMethod
(`significantBits.scala:100-127`), plus the unused variableBits
(`significantBits.scala:129-138`). Counterpart of
`similaritysearchbyrdf_tpu/models/transforms.py`, elementwise on hashes held
as unsigned values in int64 (see `ops/bitops.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bitops import as_u32, popcount


def sampling_permutation(seed: int) -> np.ndarray:
    """The seeded permutation of bit positions 0..31 (same numpy draw as the
    JAX package, so the same seed gives the same permutation)."""
    return np.random.default_rng(seed).permutation(32).astype(np.int32)


def sampling_one_key(keys: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out bit (31-j) = in bit perm[j] (`Sampling.samplingOneKey`)."""
    k = as_u32(keys)
    perm = perm.tolist()
    out = torch.zeros_like(k)
    for j in range(32):
        out = out | (((k >> perm[j]) & 1) << (31 - j))
    return out


def continue_bits_count(keys: torch.Tensor, num_of_bits: tuple = (6, 4, 2, 1)) -> torch.Tensor:
    """Runs of consecutive 1-bits in the low 28 bits, bucketed by run-length
    thresholds and repacked into four 7-bit fields under the top 4 bits
    (`significantBits.continueBitsCount`). A run closes at each 0 bit and at
    bit 27."""
    k = as_u32(keys)
    top4 = k >> 28
    run = torch.zeros_like(k)
    counts = [torch.zeros_like(k) for _ in num_of_bits]
    for i in range(28):
        bit = (k >> i) & 1
        run = run + bit
        close = (bit == 0) | (i == 27)
        for c, thr in enumerate(num_of_bits):
            counts[c] = counts[c] + ((run >= thr) & close).to(k.dtype)
        run = torch.where(close, torch.zeros_like(run), run)
    return ((counts[3] << 21) + (counts[2] << 14) + (counts[1] << 7)
            + counts[0] + (top4 << 28)) & 0xFFFFFFFF


_ANGLE_THRESHOLDS = (16.0, 25.0, 33.0, 39.0, 46.0, 52.0, 58.0, 66.0, 72.0)


def angle_distance_deg(keys: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between the low-28-bit 0/1 vector and all-ones
    (`significantBits.angleDistance`); NaN for popcount 0, as on the JVM."""
    pc = popcount(as_u32(keys) & 0x0FFFFFFF).to(torch.float32)
    cos = pc / (math.sqrt(28.0) * torch.sqrt(pc))
    nan_if_zero = torch.where(pc > 0, 1.0, float("nan"))
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0) * nan_if_zero))


def angle_new_method(keys: torch.Tensor) -> torch.Tensor:
    """Replace the third 7-bit field with the angle bucket
    (`significantBits.newMethod`); NaN angles land in bucket 0."""
    k = as_u32(keys)
    angle = angle_distance_deg(k)
    thr = torch.tensor(_ANGLE_THRESHOLDS, dtype=torch.float32, device=k.device)
    label = (angle[..., None] > thr).sum(dim=-1).to(k.dtype)
    first4 = (k >> 28) & 0x7F
    first7 = (k >> 21) & 0x7F
    three7 = (k >> 7) & 0x7F
    last7 = k & 0x7F
    return last7 + (three7 << 7) + (label << 14) + (first7 << 21) + (first4 << 28)


def variable_bits(keys: torch.Tensor) -> torch.Tensor:
    """Different bit widths per layer (`significantBits.variableBits`)."""
    k = as_u32(keys)
    first4 = (k >> 28) & 0x7F
    first7 = (k >> 24) & 0xF
    second7 = (k >> 17) & 0x7F
    three7 = (k >> 10) & 0x7F
    last7 = (k >> 3) & 0x7F
    return last7 + (three7 << 7) + (second7 << 14) + (first7 << 21) + (first4 << 28)


def apply_type_of_index(keys: torch.Tensor, type_of_index: str,
                        sampling_perm: torch.Tensor) -> torch.Tensor:
    """Dispatch matching `LSH.calculateIndex` (`LSH.scala:110-120`)."""
    if type_of_index == "original":
        return as_u32(keys)
    if type_of_index == "sampling":
        return sampling_one_key(keys, sampling_perm)
    if type_of_index == "continueBitsCount":
        return continue_bits_count(keys)
    if type_of_index == "angleNewMethod":
        return angle_new_method(keys)
    if type_of_index == "variableBits":
        return variable_bits(keys)
    raise ValueError(f"unknown typeOfIndex {type_of_index!r}")
