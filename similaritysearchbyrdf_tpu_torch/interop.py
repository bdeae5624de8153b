"""Carry a fitted JAX-package forest or flat index over into the port's state.

`from_jax_state` takes the JAX package's `ForestState` fields as numpy
arrays, keyed by their attribute paths (`"model.proj"`,
`"tables.sorted_keys"`, ...), so that both packages can query the identical
index. Layout changes on the way:
  * uint32 keys become the port's order-preserving int32 keys;
  * the corpus and its bf16 copy `corpus_lp` (two-stage rerank) lose
    their 128-lane column padding;
  * the lane-packed coarse tier [Lg, caprows, G*cs] (G tables per row; int8
    or bf16) and its head tier [Lg, hr, G*cs] are unpacked per table: table
    t is group t // G, lanes [(t % G)*cs, (t % G + 1)*cs);
  * the slot-folded tier [L, caprows/fold, fold*cs] is reshaped back to the
    per-table tier [L, caprows, cs] (exact: folding is a row-major
    reshape), of which the port's folded tier is a view.

`jax_state_arrays` goes the other way for the fields a saved forest holds
(`storage/persist.save_forest` writes them as the JAX package's file):
keys back to uint32, the corpus padded with zero columns to the JAX
package's 128-lane width.

`dynamic_from_jax` builds a `DynamicForest` whose main and delta tiers hold
two such states, with the JAX package's staged delta rows and tombstones.

`sparse_from_jax_state` takes a JAX `SparseForestState`'s arrays the same
way (its padded-COO corpus and its lane-packed tier, G = 128 // cs tables
a row, as they are).

`from_jax_flat` does the same for the JAX package's `FlatIndex`: its sketch
loses the 128-lane padding down to the port's multiple of 32 columns, its
exact tier the padding down to the true width, and its strided second
sketch copy (`sketch_gmax`, a TPU tactic) is not read. `from_jax_ivf`
carries the JAX package's `IVFState` over the same way, and
`from_jax_sparse_flat` its `SparseFlatIndex`.

`from_jax_sharded_state` takes a JAX sharded forest's arrays (dense or
sparse) with their leading [ndev] axis and builds each shard with
`from_jax_state` or `sparse_from_jax_state`; `from_jax_sharded_flat` and
`from_jax_sharded_ivf` do the same for the sharded flat and IVF engines.
The TPU layouts of the sharded states (`ids128`, `sketch_gmax`) are not
read.

numpy has no bf16 type: a bf16 array may come as the JAX package's own
(`ml_dtypes`) bf16 or widened to f32 by the caller. Either widens to f32
exactly and narrows back to the same bf16 values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import RDFConfig
from .index.bucket_table import BucketTables, build_records
from .index.dynamic import DynamicForest
from .index.forest import ForestState
from .index.sparse_forest import SparseForestState
from .models.families import Device, HashModel, resolve_device
from .ops.bitops import from_key, to_key
from .ops.flat import _NPAD_MULTIPLE, FlatIndex, SparseFlatIndex, _pad_rows, _round_up
from .ops.ivf import IVFFlatIndex, IVFState
from .parallel.sharded_flat import FlatShard, ShardedFlatIndex, ShardedFlatState
from .parallel.sharded_forest import ShardedForestState, ShardedSparseForestState
from .parallel.sharded_ivf import ShardedIVFIndex, ShardedIVFState

FIELDS = (
    "model.proj", "model.perm", "model.b", "model.sampling_perm", "part_proj",
    "tables.sorted_keys", "tables.sorted_ids", "tables.bucket_keys",
    "tables.bucket_starts", "tables.bucket_shifts", "corpus", "row_ids",
)
# forests with a coarse tier: coarse_proj and one of coarse_by_table (lane
# layout, with coarse_head when `coarse_head_pool` was set) or coarse_folded;
# forests fitted with rerank_dtype="bfloat16": corpus_lp
OPTIONAL_FIELDS = ("coarse_proj", "coarse_by_table", "coarse_head", "coarse_folded",
                   "corpus_lp")
LANES = 128       # the JAX package pads stored widths to a multiple of this


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    """A bf16 tensor of the bf16 values in `a` (bf16, or widened to f32)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device).to(torch.bfloat16)


def unpack_lane_tier(packed: np.ndarray, num_tables: int, cs: int) -> np.ndarray:
    """[Lg, caprows, G*cs] lane-packed tier → [L, caprows, cs] per table."""
    g = packed.shape[2] // cs
    return np.stack([packed[t // g, :, (t % g) * cs:(t % g + 1) * cs]
                     for t in range(num_tables)])


def _model_and_tables(arrays: Dict[str, np.ndarray], conf: RDFConfig, fields, who: str,
                      device: torch.device):
    """(model, tables, t) from a JAX state's arrays: the hash model, the
    bucket tables with their keys made the port's int32 keys (`to_key`),
    and `t(name, dtype)`, which makes any of the arrays a tensor on
    `device`. Raises KeyError naming what `fields` lists and `arrays`
    lacks."""
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"{who}: missing arrays {missing}")

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
    return model, tables, t


def _lane_tier(arrays: Dict[str, np.ndarray], num_tables: int, device: torch.device):
    """(coarse_proj, per-table tier) from the lane-packed `coarse_by_table`
    (int8, or bf16 as bf16 or widened to f32) and its `coarse_proj`, G =
    128 // cs tables a row."""
    coarse_proj = torch.as_tensor(np.array(arrays["coarse_proj"]), dtype=torch.float32,
                                  device=device)
    packed = np.asarray(arrays["coarse_by_table"])
    tier = unpack_lane_tier(packed, num_tables, coarse_proj.shape[1])
    tier = (torch.as_tensor(tier, device=device) if packed.dtype == np.int8
            else _bf16(tier, device))
    return coarse_proj, tier


def from_jax_state(arrays: Dict[str, np.ndarray], conf: RDFConfig,
                   device: Device = None) -> ForestState:
    """The port's `ForestState` from the JAX package's state arrays (see
    `FIELDS`; `OPTIONAL_FIELDS` may be absent), on `device` (default: the
    first CUDA card). A state with `corpus_lp` reranks in two stages, as
    the JAX package's does, whatever `conf.rerank_dtype` says: that option
    acts at the fit."""
    device = resolve_device(device)
    model, tables, t = _model_and_tables(arrays, conf, FIELDS, "from_jax_state", device)
    coarse_proj = tier = head = None
    layout = "lane"
    l = tables.num_tables
    if arrays.get("coarse_by_table") is not None:
        coarse_proj, tier = _lane_tier(arrays, l, device)
        cs = coarse_proj.shape[1]
        if arrays.get("coarse_head") is not None:
            head = _bf16(unpack_lane_tier(np.asarray(arrays["coarse_head"]), l, cs), device)
    elif arrays.get("coarse_folded") is not None:
        coarse_proj = t("coarse_proj", torch.float32)
        folded = np.array(arrays["coarse_folded"])
        tier = torch.as_tensor(folded.reshape(l, -1, coarse_proj.shape[1]), device=device)
        layout = "folded"
    corpus_lp = None
    if arrays.get("corpus_lp") is not None:
        corpus_lp = _bf16(np.asarray(arrays["corpus_lp"])[:, :conf.vector_dim], device)
    return ForestState(
        model=model, part_proj=t("part_proj", torch.float32), tables=tables,
        corpus=t("corpus", torch.float32)[:, :conf.vector_dim].contiguous(),
        row_ids=t("row_ids", torch.int32), corpus_lp=corpus_lp, coarse_proj=coarse_proj,
        coarse_tier=tier, coarse_head=head, coarse_layout=layout,
    )


# FIELDS with the padded-COO corpus in place of the dense one
SPARSE_FIELDS = FIELDS[:-2] + ("corpus_indices", "corpus_values", "row_ids")


def sparse_from_jax_state(arrays: Dict[str, np.ndarray], conf: RDFConfig,
                          device: Device = None) -> SparseForestState:
    """The port's `SparseForestState` from a JAX `SparseForestState`'s arrays
    (`SPARSE_FIELDS`; `coarse_proj` and `coarse_by_table` when it has a
    coarse tier), on `device` (default: the first CUDA card). The model,
    partition projections and tables go as in `from_jax_state`; the corpus,
    ids and the tier's projection come across as they are."""
    device = resolve_device(device)
    model, tables, t = _model_and_tables(arrays, conf, SPARSE_FIELDS, "sparse_from_jax_state",
                                         device)
    coarse_proj = tier = None
    if arrays.get("coarse_by_table") is not None:
        coarse_proj, tier = _lane_tier(arrays, tables.num_tables, device)
    return SparseForestState(
        model=model, part_proj=t("part_proj", torch.float32), tables=tables,
        corpus_indices=t("corpus_indices", torch.int32),
        corpus_values=t("corpus_values", torch.float32), row_ids=t("row_ids", torch.int32),
        coarse_proj=coarse_proj, coarse_tier=tier)


def pad_lanes(a: np.ndarray) -> np.ndarray:
    """`a` with zero columns up to the JAX package's 128-lane multiple."""
    return np.pad(a, ((0, 0), (0, -a.shape[1] % LANES)))


def jax_state_arrays(state: ForestState) -> Dict[str, np.ndarray]:
    """The JAX package's state arrays of a port `ForestState`, on the host,
    keyed as `from_jax_state` takes them (`FIELDS`, and `coarse_proj` when
    the state has a coarse tier), with the JAX package's dtypes: the
    order-preserving int32 keys back to uint32 (`from_key`; the padding key
    becomes 0xFFFFFFFF), bucket shifts as uint32, the corpus padded with
    zero columns to 128 lanes. Derived arrays (records, coarse tiers,
    `corpus_lp`) are not among them: a load rebuilds them."""
    def host(t: torch.Tensor, dtype) -> np.ndarray:
        return t.detach().cpu().numpy().astype(dtype, copy=False)

    def key(t: torch.Tensor) -> np.ndarray:
        return from_key(t.detach().cpu()).numpy().astype(np.uint32)

    model, tables = state.model, state.tables
    out = {
        "model.proj": host(model.proj, np.float32), "model.perm": host(model.perm, np.int32),
        "model.b": host(model.b, np.float32),
        "model.sampling_perm": host(model.sampling_perm, np.int32),
        "part_proj": host(state.part_proj, np.float32),
        "tables.sorted_keys": key(tables.sorted_keys),
        "tables.sorted_ids": host(tables.sorted_ids, np.int32),
        "tables.bucket_keys": key(tables.bucket_keys),
        "tables.bucket_starts": host(tables.bucket_starts, np.int32),
        "tables.bucket_shifts": host(tables.bucket_shifts, np.uint32),
        "corpus": pad_lanes(host(state.corpus, np.float32)),
        "row_ids": host(state.row_ids, np.int32),
    }
    if state.coarse_proj is not None:
        out["coarse_proj"] = host(state.coarse_proj, np.float32)
    return out


def dynamic_from_jax(conf: RDFConfig, main: Dict[str, np.ndarray],
                     delta: Optional[Dict[str, np.ndarray]] = None,
                     delta_ids: Optional[np.ndarray] = None,
                     delta_values: Optional[np.ndarray] = None, tombstones=(),
                     merge_threshold: float = 0.25, device: Device = None) -> DynamicForest:
    """A port `DynamicForest` in the JAX package's DynamicForest's state:
    `main` and `delta` are its tiers' state arrays (see `from_jax_state`;
    `delta` None when it has no delta tier), `delta_ids` / `delta_values`
    its staged delta rows and `tombstones` its pending removals."""
    device = resolve_device(device)
    return DynamicForest.from_states(
        conf, from_jax_state(main, conf, device),
        None if delta is None else from_jax_state(delta, conf, device), tombstones,
        delta_ids, delta_values, merge_threshold, device)


def from_jax_flat(arrays: Dict[str, np.ndarray], dim: int, device: Device = None,
                  **index_kw) -> FlatIndex:
    """A fitted port `FlatIndex` (on `device`, default the first CUDA card;
    `index_kw` as for `FlatIndex`) from the JAX package's FlatIndex arrays
    `sketch`, `scale`, `corpus` and `row_ids`. `dim` is the corpus's true
    width: both packages pad it with zero columns, which change no score.
    The exact tier keeps `corpus`'s type unless `index_kw` names a
    `corpus_dtype` (a saved file widens a bf16 tier to f32)."""
    device = resolve_device(device)
    missing = [f for f in ("sketch", "scale", "corpus", "row_ids") if f not in arrays]
    if missing:
        raise KeyError(f"from_jax_flat: missing arrays {missing}")
    def host(a, dtype=None):    # a writable copy
        return torch.from_numpy(np.array(a, dtype=dtype))

    sketch_np = np.asarray(arrays["sketch"])[:, :-(-dim // 32) * 32]
    bf16 = sketch_np.dtype != np.int8
    # bf16 values widen to f32 exactly, and narrow back exactly
    sketch = host(sketch_np, np.float32).to(torch.bfloat16) if bf16 else host(sketch_np)
    corpus_np = np.asarray(arrays["corpus"])
    index_kw.setdefault("corpus_dtype",
                        "float32" if corpus_np.dtype == np.float32 else "bfloat16")
    index = FlatIndex(sketch_dtype="bfloat16" if bf16 else "int8", device=device, **index_kw)
    return index.set_state(sketch, float(arrays["scale"]), host(corpus_np[:, :dim], np.float32),
                           host(arrays["row_ids"], np.int32))


def from_jax_ivf(arrays: Dict[str, np.ndarray], dim: int, device: Device = None,
                 **index_kw) -> IVFFlatIndex:
    """A fitted port `IVFFlatIndex` (on `device`, default the first CUDA
    card; `index_kw` as for `IVFFlatIndex`) from the JAX package's
    `IVFState` arrays `sketch`, `corpus`, `row_ids`, `centroids`, `starts`
    and `ends`. The sketch, the exact tier and the centroids lose their
    128-lane padding down to the port's multiple of 32 columns above `dim`,
    the corpus's true width; the head tier, derived from the sketch, is
    built anew when `index_kw` asks for pruning."""
    device = resolve_device(device)
    missing = [f for f in ("sketch", "corpus", "row_ids", "centroids", "starts", "ends")
               if f not in arrays]
    if missing:
        raise KeyError(f"from_jax_ivf: missing arrays {missing}")
    dp = -(-dim // 32) * 32

    def cols(name: str) -> torch.Tensor:
        a = np.asarray(arrays[name])[:, :dp]
        if a.dtype in (np.int8, np.float32):
            return torch.as_tensor(np.array(a), device=device)     # a writable copy
        return _bf16(a, device)

    def ints(name: str) -> torch.Tensor:
        return torch.as_tensor(np.array(arrays[name], dtype=np.int32), device=device)

    index = IVFFlatIndex(device=device, **index_kw)
    index.state = IVFState(sketch=cols("sketch"), corpus=cols("corpus"),
                           row_ids=ints("row_ids"), centroids=_bf16(
                               np.asarray(arrays["centroids"])[:, :dp], device),
                           starts=ints("starts"), ends=ints("ends"))
    index.ensure_heads()
    return index


def from_jax_sparse_flat(arrays: Dict[str, np.ndarray], size: int,
                         device: Device = None, **index_kw) -> SparseFlatIndex:
    """A fitted port `SparseFlatIndex` (on `device`, default the first CUDA
    card; `index_kw` as for `SparseFlatIndex`) from the JAX package's
    SparseFlatIndex arrays `sketch`, `scale`, `c_idx`, `c_val` and
    `row_ids`. The sketch loses its 128-lane padding down to the port's
    multiple of 32 columns above `size`, the feature-space size."""
    device = resolve_device(device)
    missing = [f for f in ("sketch", "scale", "c_idx", "c_val", "row_ids") if f not in arrays]
    if missing:
        raise KeyError(f"from_jax_sparse_flat: missing arrays {missing}")

    def host(name: str, dtype) -> torch.Tensor:     # a writable copy
        return torch.from_numpy(np.array(arrays[name], dtype=dtype))

    sketch = torch.from_numpy(np.array(np.asarray(arrays["sketch"])[:, :-(-size // 32) * 32]))
    return SparseFlatIndex(device=device, **index_kw).set_state(
        sketch, float(arrays["scale"]), host("c_idx", np.int32), host("c_val", np.float32),
        host("row_ids", np.int32), size)


# ---------------------------------------------------------------------------
# sharded states: the JAX package's arrays carry a leading [ndev] axis (the
# flat engine's are row-sharded: [ndev * nloc, ...])
# ---------------------------------------------------------------------------

# the JAX ShardedForestState's fields held once for every shard
_REPLICATED = ("model.proj", "model.perm", "model.b", "model.sampling_perm", "part_proj",
               "coarse_proj")
_TABLE_FIELDS = ("sorted_keys", "sorted_ids", "bucket_keys", "bucket_starts", "bucket_shifts")


def _shard_arrays(arrays: Dict[str, np.ndarray], s: int) -> Dict[str, np.ndarray]:
    """Shard s of a JAX sharded forest state's arrays, keyed as
    `from_jax_state` takes them (the tables under `tables.`); `ids128` (a
    TPU view of the sorted ids) is dropped."""
    out = {}
    for name, a in arrays.items():
        if a is None or name == "ids128":
            continue
        if name in _REPLICATED:
            out[name] = a
        else:
            out[f"tables.{name}" if name in _TABLE_FIELDS else name] = np.asarray(a)[s]
    return out


def _trailing_live(row_ids: np.ndarray) -> int:
    """The live rows of a JAX shard, whose padding is its trailing run of
    -1 ids (the JAX package fills its shards in row order)."""
    live = np.flatnonzero(np.asarray(row_ids) != -1)
    return int(live[-1]) + 1 if live.size else 0


def from_jax_sharded_state(arrays: Dict[str, np.ndarray], conf: RDFConfig, mesh):
    """The port's sharded forest state (`parallel.sharded_forest`) from a
    JAX `ShardedForestState`'s or `ShardedSparseForestState`'s arrays,
    keyed by field (`"sorted_keys"`, `"corpus"`, ...; the model as
    `"model.proj"`, ...), the sharded ones with their leading [ndev] axis:
    shard s is `from_jax_state` (a dense state: the lane tier unpacked) or
    `sparse_from_jax_state` (arrays with `corpus_indices`) of its slice, on
    `mesh.devices[s]`. The mesh holds the ndev shards in one process."""
    ndev = np.asarray(arrays["row_ids"]).shape[0]
    if mesh.n_local != ndev:
        raise ValueError(f"the state has {ndev} shards, this process's mesh {mesh.n_local}")
    sparse = "corpus_indices" in arrays
    shards, n_live = [], []
    for s, dev in enumerate(mesh.devices):
        part = _shard_arrays(arrays, s)
        shards.append(sparse_from_jax_state(part, conf, dev) if sparse
                      else from_jax_state(part, conf, dev))
        n_live.append(_trailing_live(part["row_ids"]))
    nloc = np.asarray(arrays["row_ids"]).shape[1]
    if sparse:
        return ShardedSparseForestState(shards=shards, n_live=n_live, nloc=nloc,
                                        dim=conf.vector_dim)
    return ShardedForestState(shards=shards, n_live=n_live, nloc=nloc)


def from_jax_sharded_flat(arrays: Dict[str, np.ndarray], dim: int, mesh,
                          n_live: Optional[list] = None, **index_kw):
    """A fitted port `ShardedFlatIndex` (`index_kw` as for it) from the JAX
    package's `ShardedFlatState` arrays `sketch`, `corpus` and `row_ids`
    ([ndev * nloc, ...] in shard order, as `save_sharded_flat` writes them),
    on `mesh` (any shard count dividing the rows, as the JAX loader allows).
    The sketch loses its 128-lane padding down to the port's multiple of 32
    columns above `dim`, the exact tier down to `dim`; `sketch_gmax` (a TPU
    layout) is not read. `n_live` gives each shard's live rows (a saved
    port index records them); without it, a shard's padding is its trailing
    run of -1 ids."""
    sketch = np.asarray(arrays["sketch"])[:, :_round_up(dim, 32)]
    bf16 = sketch.dtype != np.int8
    rid = np.asarray(arrays["row_ids"], dtype=np.int32)
    rows = rid.shape[0]
    if rows % mesh.n_shards:
        raise ValueError(f"stored rows ({rows}) not divisible by mesh shards ({mesh.n_shards})")
    nloc = rows // mesh.n_shards
    index = ShardedFlatIndex(mesh=mesh, sketch_dtype="bfloat16" if bf16 else "int8",
                             **index_kw)
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + i) * nloc
        sk = (_bf16(sketch[lo:lo + nloc], dev) if bf16
              else torch.as_tensor(np.array(sketch[lo:lo + nloc]), device=dev))
        shards.append(FlatShard(
            sketch=_pad_rows(sk, _round_up(nloc, _NPAD_MULTIPLE)).contiguous(),
            corpus=torch.as_tensor(np.array(np.asarray(arrays["corpus"])[lo:lo + nloc, :dim],
                                            dtype=np.float32), device=dev),
            row_ids=torch.as_tensor(np.array(rid[lo:lo + nloc]), device=dev),
            n_live=(_trailing_live(rid[lo:lo + nloc]) if n_live is None
                    else int(n_live[mesh.first_shard + i]))))
    index.state = ShardedFlatState(shards=shards, nloc=nloc, first_shard=mesh.first_shard)
    return index


def from_jax_sharded_ivf(arrays: Dict[str, np.ndarray], dim: int, mesh, **index_kw):
    """A fitted port `ShardedIVFIndex` (`index_kw` as for it) from the JAX
    package's `ShardedIVFState` arrays `sketch`, `corpus`, `row_ids`,
    `starts` and `ends` (leading [ndev] axis) and `centroids`, on a mesh of
    as many shards (the per-shard cluster layouts are tied to the count).
    Widths lose their 128-lane padding down to the port's multiple of 32
    columns above `dim`; the head tier is built anew when `index_kw` asks
    for pruning."""
    ndev = np.asarray(arrays["row_ids"]).shape[0]
    if ndev != mesh.n_shards:
        raise ValueError(f"saved for {ndev} shards, the mesh has {mesh.n_shards} (per-shard "
                         "cluster layouts are tied to the shard count)")
    dp = -(-dim // 32) * 32
    index = ShardedIVFIndex(mesh=mesh, **index_kw)
    shards = []
    for i, dev in enumerate(mesh.devices):
        s = mesh.first_shard + i

        def part(name):
            return np.asarray(arrays[name])[s]

        sk = part("sketch")[:, :dp]
        shards.append(IVFState(
            sketch=(torch.as_tensor(np.array(sk), device=dev) if sk.dtype == np.int8
                    else _bf16(sk, dev)),
            corpus=torch.as_tensor(np.array(part("corpus")[:, :dp], dtype=np.float32),
                                   device=dev),
            row_ids=torch.as_tensor(np.array(part("row_ids"), dtype=np.int32), device=dev),
            centroids=_bf16(np.asarray(arrays["centroids"])[:, :dp], dev),
            starts=torch.as_tensor(np.array(part("starts"), dtype=np.int32), device=dev),
            ends=torch.as_tensor(np.array(part("ends"), dtype=np.int32), device=dev)))
    index.state = ShardedIVFState(shards=shards, first_shard=mesh.first_shard)
    index.ensure_heads()
    return index
