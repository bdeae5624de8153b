"""Carry a fitted JAX-package forest over into the port's state.

`from_jax_state` takes the JAX package's `ForestState` fields as numpy
arrays, keyed by their attribute paths (`"model.proj"`,
`"tables.sorted_keys"`, ...), so that both packages can query the identical
index. Layout changes on the way:
  * uint32 keys become the port's order-preserving int32 keys;
  * the corpus loses its 128-lane column padding;
  * the lane-packed coarse tier [Lg, caprows, G*cs] (G tables per row) is
    unpacked per table: table t is group t // G, lanes
    [(t % G)*cs, (t % G + 1)*cs).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import RDFConfig
from .index.bucket_table import BucketTables, build_records
from .index.forest import ForestState
from .models.families import Device, HashModel
from .ops.bitops import to_key

FIELDS = (
    "model.proj", "model.perm", "model.b", "model.sampling_perm", "part_proj",
    "tables.sorted_keys", "tables.sorted_ids", "tables.bucket_keys",
    "tables.bucket_starts", "tables.bucket_shifts", "corpus", "row_ids",
)
OPTIONAL_FIELDS = ("coarse_proj", "coarse_by_table")   # forests with a coarse tier


def unpack_lane_tier(packed: np.ndarray, num_tables: int, cs: int) -> np.ndarray:
    """[Lg, caprows, G*cs] lane-packed tier → [L, caprows, cs] per table."""
    g = packed.shape[2] // cs
    return np.stack([packed[t // g, :, (t % g) * cs:(t % g + 1) * cs]
                     for t in range(num_tables)])


def from_jax_state(arrays: Dict[str, np.ndarray], conf: RDFConfig,
                   device: Device = None) -> ForestState:
    """The port's `ForestState` from the JAX package's state arrays (see
    `FIELDS`; `OPTIONAL_FIELDS` may be absent)."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"from_jax_state: missing arrays {missing}")

    def t(name: str, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)

    def key(name: str) -> torch.Tensor:
        return to_key(torch.as_tensor(np.asarray(arrays[name], dtype=np.int64),
                                      device=device)).contiguous()

    model = HashModel(
        proj=t("model.proj", torch.float32), perm=t("model.perm", torch.int32),
        b=t("model.b", torch.float32),
        sampling_perm=t("model.sampling_perm", torch.int32),
        family=conf.family_name, w=conf.pstable.w, type_of_index=conf.type_of_index,
    )
    bucket_keys = key("tables.bucket_keys")
    bucket_starts = t("tables.bucket_starts", torch.int32)
    bucket_shifts = t("tables.bucket_shifts", torch.int32)
    tables = BucketTables(
        sorted_keys=key("tables.sorted_keys"),
        sorted_ids=t("tables.sorted_ids", torch.int32),
        bucket_keys=bucket_keys, bucket_starts=bucket_starts, bucket_shifts=bucket_shifts,
        records=build_records(bucket_keys, bucket_starts, bucket_shifts),
    )
    coarse_proj: Optional[torch.Tensor] = None
    tier: Optional[torch.Tensor] = None
    if arrays.get("coarse_by_table") is not None:
        coarse_proj = t("coarse_proj", torch.float32)
        tier = torch.as_tensor(
            unpack_lane_tier(np.asarray(arrays["coarse_by_table"]), tables.num_tables,
                             coarse_proj.shape[1]), device=device)
    return ForestState(
        model=model, part_proj=t("part_proj", torch.float32), tables=tables,
        corpus=t("corpus", torch.float32)[:, :conf.vector_dim].contiguous(),
        row_ids=t("row_ids", torch.int32), coarse_proj=coarse_proj, coarse_tier=tier,
    )
