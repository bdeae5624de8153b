"""Content-based partitioner (`utils/Partitioner.scala:27-65`).

Counterpart of `similaritysearchbyrdf_tpu/index/partitioner.py`: the 32-bit
table hash is a 32-dim 0/1 vector, and each table's own `partitionBits`-long
angle chain over it gives the sub-index id. Partition projections are drawn
with the JAX package's numpy sequence, so a seed gives bit-equal chains.
Loading partition chains from a file is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RDFConfig, partition_config
from ..models.families import Device, generate_angle_model, resolve_device
from ..ops.bitops import bits_of
from ..ops.precision import full_f32


def generate_partition_projections(conf: RDFConfig, seed: Optional[int] = None,
                                   device: Device = None) -> torch.Tensor:
    """Q f32[L, partitionBits, 32]: one independent partition chain per
    table (`DensevectorRDFInit.scala:63-70`)."""
    if conf.partition_family_file_path is not None:
        raise NotImplementedError("partition chains from a file are not ported yet")
    device = resolve_device(device)
    pconf = partition_config(conf)
    base_seed = conf.seed if seed is None else seed
    qs = [generate_angle_model(pconf, seed=base_seed + 7919 * (t + 1), device=device).proj[0]
          for t in range(conf.hash_tables)]
    return torch.stack(qs)


def partition_of_hash(hashes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Sub-index id of every (point, table) hash: hashes int64[B, L] (unsigned
    values), q f32[L, pbits, 32] → int64[B, L] in [0, 2**pbits)
    (`LocalitySensitivePartitioner.getPartition`). Bit i of the hash is
    component i (LSB first); the chain's signs pack MSB-first, so the id is
    sum_j sign_j << (pbits-1-j)."""
    bits = bits_of(hashes).to(torch.float32)                    # [B, L, 32]
    with full_f32():
        dots = torch.einsum("blk,lpk->blp", bits, q)            # [B, L, pbits]
    pbits = q.shape[1]
    weights = 1 << torch.arange(pbits - 1, -1, -1, device=hashes.device)
    return ((dots > 0).to(torch.int64) * weights).sum(dim=-1)


def stepwise_patterns(partition_bits: int, steps: int) -> np.ndarray:
    """All XOR patterns within Hamming distance <= steps of a partition id
    (`findStepWiseSubIndexIDs`, `RandomDrawTreeMap.java:613-621`)."""
    n = 1 << partition_bits
    return np.asarray([p for p in range(n) if bin(p).count("1") <= steps],
                      dtype=np.int64)
