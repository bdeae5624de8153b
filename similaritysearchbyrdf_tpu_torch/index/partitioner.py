"""Content-based partitioner (`utils/Partitioner.scala:27-65`).

Counterpart of `similaritysearchbyrdf_tpu/index/partitioner.py`: the 32-bit
table hash is a 32-dim 0/1 vector, and each table's own `partitionBits`-long
angle chain over it gives the sub-index id. Partition projections are drawn
with the JAX package's numpy sequence, so a seed gives bit-equal chains, or
load from the reference's partition checkpoint (`partition_family_file_path`).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..config import RDFConfig, partition_config
from ..models.families import (Device, _sparse_vector_str, generate_angle_model,
                               read_function_rows, resolve_device, write_lines)
from ..ops.bitops import bits_of
from ..ops.precision import full_f32


def generate_partition_projections(conf: RDFConfig, seed: Optional[int] = None,
                                   device: Device = None) -> torch.Tensor:
    """Q f32[L, partitionBits, 32]: one independent partition chain per
    table (`DensevectorRDFInit.scala:63-70`), or the chains of
    `conf.partition_family_file_path` (the reference's `confType=partition`
    flow, `utils/Partitioner.scala:31`)."""
    device = resolve_device(device)
    if conf.partition_family_file_path is not None:
        return load_partition_file(conf.partition_family_file_path, conf, device)
    pconf = partition_config(conf)
    base_seed = conf.seed if seed is None else seed
    qs = [generate_angle_model(pconf, seed=base_seed + 7919 * (t + 1), device=device).proj[0]
          for t in range(conf.hash_tables)]
    return torch.stack(qs)


def save_partition_file(part_proj: Union[torch.Tensor, np.ndarray], path: str) -> None:
    """Write partition chains [L, pbits, 32] in the reference's hash-family
    text format, `partitionBits` lines per chain (the
    `partition-bestHashFamily-angle` layout, `LSH.scala:173-195`)."""
    q = (part_proj.cpu().numpy() if isinstance(part_proj, torch.Tensor)
         else np.asarray(part_proj))
    write_lines([_sparse_vector_str(t * q.shape[1] + j, q[t, j])
                 for t in range(q.shape[0]) for j in range(q.shape[1])], path)


def load_partition_file(path: str, conf: RDFConfig, device: Device = None) -> torch.Tensor:
    """Load partition chains from the reference's text format. A file of one
    chain is broadcast to every table (`DensevectorRDFInit.scala:71-86`); a
    file of `hash_tables` chains gives one chain per table; any other count
    raises."""
    from ..vectors import from_string

    pbits = conf.partition_bits
    rows = []
    for line in read_function_rows(path):
        _, size, idx, val = from_string(line)
        dense = np.zeros(size, dtype=np.float32)
        dense[idx] = val
        rows.append(dense)
    if len(rows) % pbits != 0:
        raise ValueError(f"{path}: {len(rows)} functions not divisible by "
                         f"partitionBits {pbits}")
    chains = np.stack(rows).reshape(-1, pbits, rows[0].shape[0])
    l = conf.hash_tables
    if chains.shape[0] == 1:
        chains = np.broadcast_to(chains, (l,) + chains.shape[1:])
    elif chains.shape[0] != l:
        raise ValueError(f"{path}: {chains.shape[0]} partition chains for {l} tables "
                         "(expected 1 or total_tables)")
    if chains.shape[2] != 32:
        raise ValueError(f"{path}: partition functions must be 32-dim")
    return torch.as_tensor(np.ascontiguousarray(chains), dtype=torch.float32,
                           device=resolve_device(device))


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


def hash_partition(values: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """The dataTable's `HashPartitioner`: `value.hashCode % numPartitions`
    (`utils/Partitioner.scala:14-18`), identity hashCode for int keys; the
    absolute value of int32 wraps at -2**31 as in the JAX package, and the
    remainder takes the divisor's sign."""
    return torch.abs(values.to(torch.int32)) % num_partitions


def stepwise_patterns(partition_bits: int, steps: int) -> np.ndarray:
    """All XOR patterns within Hamming distance <= steps of a partition id
    (`findStepWiseSubIndexIDs`, `RandomDrawTreeMap.java:613-621`)."""
    n = 1 << partition_bits
    return np.asarray([p for p in range(n) if bin(p).count("1") <= steps],
                      dtype=np.int64)
