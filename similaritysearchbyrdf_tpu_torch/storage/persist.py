"""Index persistence: save/load of every engine, and tiered generations.

Counterpart of `similaritysearchbyrdf_tpu/storage/persist.py`. The files are
the interop: the port writes the JAX package's `<path>.npz` and
`<path>.json` (the same member names, dtypes and shapes, and meta JSON with
`version` 1), so either package loads what the other saved:
  * a forest (`save_forest` / `load_forest`): hash model, partition
    projections, bucket tables (keys as uint32, `interop.jax_state_arrays`),
    the corpus padded with zero columns to 128 lanes, and the coarse
    projection; a load cuts the corpus back to `vector_dim` and rebuilds the
    derived arrays (bucket records, the per-table coarse tier from the saved
    projection, its head tier, the bf16 rerank copy) on `device`. The JAX
    package's lane-packed tier is never read or written. The npz may be
    deflated (`compress`), and XTEA-encrypted and CRC-checked behind an
    `RDFX` header (`password`, `checksum`; `storage/crypto.py`);
  * the flat and IVF engines (`save_flat` / `load_flat`, `save_ivf` /
    `load_ivf`): bf16 arrays widened to f32 (npz has no bf16), every width
    padded to 128 lanes as the JAX package stores it, and cut back on load
    to the port's multiple of 32 columns. The JSON also records the width
    `dim` to cut back to (the JAX package reads named keys only); a file
    without it takes the width of the corpus's last non-zero column.

`GenerationStore` keeps spilled forests as millisecond-named generations
with a Bloom summary of their ids (`-summary.npz`) and their bucket
boundaries (`-keysummary.npz`), resident in an LRU by device bytes;
`TieredForest` queries a device tier and every generation its probe keys
can reach, and merges the tiers' top-k.

The sharded flat and IVF engines (`save_sharded_flat` / `load_sharded_flat`,
`save_sharded_ivf` / `load_sharded_ivf`) write the JAX package's sharded
files from one-process meshes: the flat shards concatenated in shard order
(loadable on any shard count that divides the rows), the IVF shards stacked
on a leading shard axis (loadable on the saved count only).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..index.bucket_table import ID_PAD
from ..index.forest import ForestState, RDFForest, _probe_hashes, build_coarse_tiers, probe_key_set
from ..index.partitioner import partition_of_hash
from ..interop import (FIELDS, from_jax_flat, from_jax_ivf, from_jax_sharded_flat,
                       from_jax_sharded_ivf, from_jax_state, jax_state_arrays, pad_lanes)
from ..models.families import Device, HashModel, resolve_device
from ..ops.bitops import from_key
from ..ops.hashing import hash_dense
from .bloom import BloomFilter
from .crypto import WrongConfigError, unwrap_record, wrap_record

_WRAP_MAGIC = b"RDFX"


# ---------------------------------------------------------------------------
# Whole-forest save / load
# ---------------------------------------------------------------------------


def save_forest(forest: RDFForest, path: str, compress: bool = True,
                password: Optional[bytes] = None, checksum: bool = False) -> None:
    """Write config, model, tables, corpus and coarse projection to
    `<path>.npz` / `<path>.json`, the JAX package's files. `compress`
    deflates the npz (the reference store's optional LZF, `Store.java:
    26-60`); `password` / `checksum` wrap its bytes with XTEA and a CRC32
    behind an `RDFX` feature header (`Store.java:296-316`), and a load must
    name the same options (`WrongConfigError` otherwise)."""
    if forest.state is None:
        raise RuntimeError("nothing to save: fit first")
    arrays = {name.split(".")[-1]: a for name, a in jax_state_arrays(forest.state).items()}
    write = np.savez_compressed if compress else np.savez
    if password is not None or checksum:
        buf = io.BytesIO()
        write(buf, **arrays)
        flags = (1 if password is not None else 0) | (2 if checksum else 0)
        with open(path + ".npz", "wb") as f:
            f.write(_WRAP_MAGIC + bytes([flags])
                    + wrap_record(buf.getvalue(), password=password, checksum=checksum))
    else:
        write(path + ".npz", **arrays)
    model = forest.state.model
    meta = dict(config=json.loads(forest.conf.to_json()), family=model.family, w=model.w,
                type_of_index=model.type_of_index, version=1)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _read_npz(path: str, password: Optional[bytes], checksum: bool) -> dict:
    """Every member of `<path>.npz` (each read once: a deflated member is
    inflated on every access), unwrapped when it has the `RDFX` header."""
    with open(path + ".npz", "rb") as f:
        head = f.read(5)
        if head[:4] == _WRAP_MAGIC:
            flags = head[4]
            if bool(flags & 1) != (password is not None):
                raise WrongConfigError(
                    "store was %screated with encryption; password %s"
                    % ("" if flags & 1 else "not ", "missing" if flags & 1 else "given"))
            if bool(flags & 2) != checksum:
                raise WrongConfigError("store was %screated with CRC32 checksum"
                                       % ("" if flags & 2 else "not "))
            src = io.BytesIO(unwrap_record(f.read(), password=password, checksum=checksum))
        else:
            if password is not None or checksum:
                raise WrongConfigError("password/checksum given, but store is not wrapped")
            src = path + ".npz"
    with np.load(src, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def load_forest(path: str, password: Optional[bytes] = None, checksum: bool = False,
                device: Device = None) -> RDFForest:
    """A forest saved by either package's `save_forest`, on `device`
    (default: the first CUDA card). Older files without the `ID_PAD` tail
    of `sorted_ids` or with an unpadded corpus load too. The coarse tier is
    rebuilt from the saved projection, never recomputed (a legacy file
    without one recomputes it), so it equals the fitted tier."""
    device = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)
    conf = RDFConfig.from_json(json.dumps(meta["config"]))
    z = _read_npz(path, password, checksum)
    if z["sorted_ids"].shape[1] == z["sorted_keys"].shape[1]:
        # a save from before the ID_PAD tail: append the -1 pad block gathers need
        z["sorted_ids"] = np.pad(z["sorted_ids"], ((0, 0), (0, ID_PAD)), constant_values=-1)
    state = from_jax_state({name: z[name.split(".")[-1]] for name in FIELDS}, conf, device)
    model = dataclasses.replace(state.model, family=meta["family"], w=meta["w"],
                                type_of_index=meta["type_of_index"])
    coarse_proj, tier, head = build_coarse_tiers(conf, state.corpus, state.tables.sorted_ids,
                                                 proj=z.get("coarse_proj"))
    state = dataclasses.replace(
        state, model=model, coarse_proj=coarse_proj, coarse_tier=tier, coarse_head=head,
        coarse_layout=conf.coarse_layout,
        corpus_lp=state.corpus.to(torch.bfloat16) if conf.rerank_dtype == "bfloat16" else None)
    forest = RDFForest(conf, model=model, device=device)
    forest.part_proj = state.part_proj
    forest.state = state
    return forest


# ---------------------------------------------------------------------------
# Tiered generations (a device tier + spilled disk generations)
# ---------------------------------------------------------------------------


def forest_state_bytes(state: ForestState) -> int:
    """Device bytes of a fitted forest's corpus, index and model (the
    `getCurrSize()` the reference compares with ramThreshold,
    `RandomDrawTreeMap.java:1114,1136`). The fields are the JAX package's,
    counted on the port's own tensors: its corpus keeps the true width
    where the JAX package's is padded to 128 lanes, and, as there, the
    coarse tiers are not counted. So `ram_threshold` acts on the port's own
    bytes, not on the JAX package's count for the same forest."""
    tensors = (state.corpus, state.corpus_lp, state.row_ids, state.part_proj,
               state.model.proj, state.model.perm, state.model.b, state.model.sampling_perm,
               state.tables.sorted_keys, state.tables.sorted_ids, state.tables.bucket_keys,
               state.tables.bucket_starts, state.tables.bucket_shifts, state.tables.records)
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def model_fingerprint(model: HashModel) -> bytes:
    """Deterministic 16-byte identity of a hash model (projection tensors
    and scalar parameters), taken over host numpy copies with numpy's dtype
    names, so a model has the same fingerprint in both packages. Two forests
    agree on bucket keys for every vector iff their fingerprints match: the
    condition for gating one tier's generations with another's probe keys."""
    h = hashlib.sha256()
    for t in (model.proj, model.perm, model.b, model.sampling_perm):
        a = t.detach().cpu().numpy()
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"{model.family}|{model.w}|{model.type_of_index}".encode())
    return h.digest()[:16]


class GenerationStore:
    """Spill generations under `working_dir/name/`, each named by its
    millisecond timestamp, with a Bloom summary of its ids: the array-era
    `StoreAppend` + `<ts>-summary` layout (`RandomDrawTreeMap.java:
    2731-2736`, Bloom fpr 0.001 at `:2764-2773`). Two spills in one
    millisecond get consecutive names (the JAX package's second would
    overwrite the first); names stay integer milliseconds, so either package
    lists the other's generations.

    Loaded generations stay resident on `device` (default: the first CUDA
    card) in an LRU of `cache_bytes` device bytes; `disk_loads` counts the
    npz reads."""

    def __init__(self, working_dir: str, name: str = "forest", cache_bytes: int = 8 << 30,
                 compress: bool = True, device: Device = None) -> None:
        self.dir = os.path.join(working_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.cache_bytes = cache_bytes
        # False trades disk bytes for spill speed (the reference Store's LZF flag)
        self.compress = compress
        self.device = resolve_device(device)
        self.disk_loads = 0
        self._cache: "dict[str, RDFForest]" = {}
        self._lru: List[str] = []            # least recent first
        # stem -> (bucket_keys, bucket_shifts, model_fp | None)
        self._key_summaries: "dict[str, tuple]" = {}

    def generations(self) -> List[str]:
        return [os.path.join(self.dir, fn[:-len(".json")])
                for fn in sorted(os.listdir(self.dir)) if fn.endswith(".json")]

    def _free_stem(self) -> str:
        """The path stem of a new generation: this millisecond, or the next
        one no generation holds yet."""
        ts = int(time.time() * 1000)
        while any(os.path.exists(os.path.join(self.dir, f"{ts}{ext}"))
                  for ext in (".json", ".npz")):
            ts += 1
        return os.path.join(self.dir, str(ts))

    def spill(self, forest: RDFForest) -> str:
        """Save the forest's state as a new generation and return its path
        stem, with two summaries beside it (`generateDataSummary`,
        `RandomDrawTreeMap.java:2764-2773`): `-summary.npz`, a Bloom filter
        of its ids (gates `get`), and `-keysummary.npz`, its bucket keys and
        shifts as uint32 and the model's fingerprint, an exact summary that
        gates queries (`testInDataSummary`, `:926-938`)."""
        if forest.state is None:
            raise RuntimeError("nothing to spill: fit first")
        stem = self._free_stem()
        save_forest(forest, stem, compress=self.compress)
        st = forest.state
        ids = st.row_ids.cpu().numpy()
        ids = ids[ids >= 0]
        bloom = BloomFilter.build(len(ids), fpr=0.001)
        bloom.add(ids.astype(np.uint32))
        np.savez_compressed(stem + "-summary.npz", bits=bloom.bits,
                            num_hashes=np.int32(bloom.num_hashes))
        np.savez_compressed(
            stem + "-keysummary.npz",
            bucket_keys=from_key(st.tables.bucket_keys.cpu()).numpy().astype(np.uint32),
            bucket_shifts=st.tables.bucket_shifts.cpu().numpy().astype(np.uint32),
            model_fp=np.frombuffer(model_fingerprint(st.model), dtype=np.uint8))
        return stem

    def summary(self, stem: str) -> BloomFilter:
        with np.load(stem + "-summary.npz") as z:
            return BloomFilter(z["bits"], int(z["num_hashes"]))

    def key_summary(self, stem: str
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[bytes]]]:
        """(bucket_keys u32[L, NB], bucket_shifts u32[L, NB], model_fp) of a
        generation, or None for a spill without the sidecar (then it might
        match). `model_fp` is None for a sidecar without it. Cached on the
        host."""
        cached = self._key_summaries.get(stem)
        if cached is not None:
            return cached
        path = stem + "-keysummary.npz"
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            out = (z["bucket_keys"].astype(np.uint32), z["bucket_shifts"].astype(np.uint32),
                   z["model_fp"].tobytes() if "model_fp" in z.files else None)
        self._key_summaries[stem] = out
        return out

    def load_generation(self, stem: str) -> RDFForest:
        """The generation's forest, from the LRU when resident (no disk read,
        no upload)."""
        hit = self._cache.get(stem)
        if hit is not None:
            self._lru.remove(stem)
            self._lru.append(stem)
            return hit
        forest = load_forest(stem, device=self.device)
        self.disk_loads += 1
        self._cache[stem] = forest
        self._lru.append(stem)
        self._evict()
        return forest

    def _resident_bytes(self) -> int:
        return sum(forest_state_bytes(f.state) for f in self._cache.values()
                   if f.state is not None)

    def _evict(self) -> None:
        while len(self._lru) > 1 and self._resident_bytes() > self.cache_bytes:
            del self._cache[self._lru.pop(0)]


@dataclasses.dataclass
class TieredForest:
    """A device tier and the store's spilled generations, queried together
    (the reference's read path over RAM and every persisted store,
    `RandomDrawTreeMap.java:583-595,1052-1075`, with a load path the
    reference lacks). Every tier lives on the store's device."""

    conf: RDFConfig
    store: GenerationStore
    device_tier: Optional[RDFForest] = None

    def _new_tier(self, batch) -> RDFForest:
        return RDFForest(self.conf, device=self.store.device).fit(batch)

    def fit(self, batch) -> "TieredForest":
        self.device_tier = self._new_tier(batch)
        self._maybe_spill()
        return self

    def add(self, batch) -> "TieredForest":
        """Insert into the device tier (a fresh one after a spill), then
        apply the ramThreshold rule."""
        if self.device_tier is None:
            self.device_tier = self._new_tier(batch)
        else:
            self.device_tier.add(batch)
        self._maybe_spill()
        return self

    def device_bytes(self) -> int:
        if self.device_tier is None or self.device_tier.state is None:
            return 0
        return forest_state_bytes(self.device_tier.state)

    def _maybe_spill(self) -> None:
        """Spill when the device tier holds more than `conf.ram_threshold`
        bytes (`getCurrSize() >= ramThreshold → runPersistTask`,
        `RandomDrawTreeMap.java:1114,1136,2713-2755`), on the write path."""
        if self.device_bytes() > self.conf.ram_threshold:
            self.spill()

    def spill(self) -> str:
        if self.device_tier is None:
            raise RuntimeError("no device tier to spill")
        stem = self.store.spill(self.device_tier)
        self.device_tier = None
        return stem

    def _row(self, forest: RDFForest, key: int) -> Optional[np.ndarray]:
        st = forest.state
        if st is None or not -(1 << 31) <= key < (1 << 31):
            return None
        rows = torch.nonzero(st.row_ids == key).flatten()
        if not len(rows):
            return None
        return st.corpus[int(rows[0]), :self.conf.vector_dim].cpu().numpy().astype(np.float32)

    def get(self, key: int) -> Optional[np.ndarray]:
        """The stored vector of id `key`, from the device tier or the first
        generation holding it; a generation whose Bloom summary rules the id
        out is never opened (`testInDataSummary`, `RandomDrawTreeMap.java:
        926-938`)."""
        if self.device_tier is not None:
            row = self._row(self.device_tier, key)
            if row is not None:
                return row
        probe = np.asarray([key]).astype(np.uint32)
        for stem in self.store.generations():
            if not self.store.summary(stem).might_contain(probe)[0]:
                continue
            row = self._row(self.store.load_generation(stem), key)
            if row is not None:
                return row
        return None

    def _probe_keys_host(self, queries, steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """The query batch's composite probe keys, a superset of both probe
        modes' (every consumed-bit flip and the self-probe, every step
        pattern, all taken as valid), so the gate never skips a generation a
        query would reach. Hashed on the device (K1 on the card). →
        (probe_keys u32[B, R], table_of i32[R]), R table-major."""
        proto = self._prototype()
        qd = torch.as_tensor(np.asarray(queries, dtype=np.float32), device=proto.device)
        h = hash_dense(proto.model, qd)
        home = partition_of_hash(h, proto.part_proj)
        probes, _ = _probe_hashes(h, proto.layout, multiprobe=True)
        keys, _ = probe_key_set(h, home, proto.layout, steps, True, probes,
                                torch.ones(probes.shape, dtype=torch.bool, device=h.device))
        per_table = keys.shape[1] // h.shape[1]
        table_of = np.repeat(np.arange(h.shape[1], dtype=np.int32), per_table)
        return keys.cpu().numpy().astype(np.uint32), table_of

    def _prototype(self) -> RDFForest:
        """A forest carrying the conf-determined hash model every tier of
        this store shares (the device tier, else an unfitted one), so probe
        keys computed once gate all generations."""
        if self.device_tier is not None:
            return self.device_tier
        if getattr(self, "_proto", None) is None:
            self._proto = RDFForest(self.conf, device=self.store.device)
        return self._proto

    @staticmethod
    def _probe_uniques(probe_keys: np.ndarray, table_of: np.ndarray, num_tables: int) -> list:
        """Each table's unique probe keys, once per query batch (not once
        per generation)."""
        return [np.unique(probe_keys[:, table_of == t]) for t in range(num_tables)]

    @staticmethod
    def _summary_matches(summary: tuple, probe_keys: np.ndarray, table_of: np.ndarray,
                         proto_fp: Optional[bytes] = None,
                         probe_uniques: Optional[list] = None) -> bool:
        """True iff any probe key lands in an existing bucket of the
        generation. Exact (bucket boundaries, not a Bloom filter): no false
        negatives, and false positives only from padding buckets. Sound only
        for probe keys of the generation's own hash model: on a fingerprint
        mismatch, or a sidecar without one, it answers True."""
        bucket_keys, bucket_shifts = summary[0], summary[1]
        gen_fp = summary[2] if len(summary) > 2 else None
        if gen_fp is None or proto_fp is None or gen_fp != proto_fp:
            return True
        for t in range(bucket_keys.shape[0]):
            q = (probe_uniques[t] if probe_uniques is not None
                 else np.unique(probe_keys[:, table_of == t]))
            bk, bs = bucket_keys[t], bucket_shifts[t]
            idx = np.searchsorted(bk, q, side="right").astype(np.int64) - 1
            safe = np.maximum(idx, 0)
            sh = bs[safe]
            hit = (idx >= 0) & ((q >> sh) == (bk[safe] >> sh))
            # padding buckets (key 0xFFFFFFFF, shift 0) hold only pad rows
            hit &= ~((bk[safe] == np.uint32(0xFFFFFFFF)) & (sh == 0))
            if bool(hit.any()):
                return True
        return False

    def query(self, queries, steps: int = 0, k: Optional[int] = None,
              query_ids: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the device tier and every generation a probe key can
        reach (the gate proves the others hold no probed bucket and never
        loads them, `RandomDrawTreeMap.java:771-783,926-938`). The tiers'
        top-k lists are merged on the device as the JAX package's `_top_k`
        merges them: a stable descending sort of the concatenated lists
        (ties to the earlier tier and rank), cut to k, id -1 where the score
        is not finite. → numpy (ids i32[Q, k], scores f32[Q, k])."""
        k = k or self.conf.top_k
        stems = self.store.generations()
        gated: List[str] = []
        if stems:
            probe_keys, table_of = self._probe_keys_host(queries, steps)
            proto_fp = model_fingerprint(self._prototype().model)
            uniques = self._probe_uniques(probe_keys, table_of,
                                          self.conf.table_num * self.conf.permutation_num)
            for stem in stems:
                summary = self.store.key_summary(stem)
                if summary is None or self._summary_matches(summary, probe_keys, table_of,
                                                            proto_fp, probe_uniques=uniques):
                    gated.append(stem)
        tiers: List[RDFForest] = [] if self.device_tier is None else [self.device_tier]
        tiers += [self.store.load_generation(stem) for stem in gated]
        if not tiers:
            nq = len(queries)
            return np.full((nq, k), -1, np.int32), np.full((nq, k), -np.inf, np.float32)
        per_tier = [tier.query_device(queries, steps=steps, query_ids=query_ids, k=k)
                    for tier in tiers]
        if len(per_tier) == 1:
            ids, scores = per_tier[0]
        else:
            cat_i = torch.cat([i for i, _ in per_tier], dim=1)
            cat_s = torch.cat([s for _, s in per_tier], dim=1)
            scores, order = torch.sort(cat_s, dim=1, descending=True, stable=True)
            scores, order = scores[:, :k], order[:, :k]
            ids = torch.where(torch.isfinite(scores), torch.gather(cat_i, 1, order), -1)
        return ids.cpu().numpy(), scores.cpu().numpy()


# ---------------------------------------------------------------------------
# The flat and IVF engines
# ---------------------------------------------------------------------------


def _host_f32(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, bf16 widened to f32 (exactly)."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", "")


def _true_width(corpus: np.ndarray) -> int:
    """The width of a lane-padded corpus saved without its `dim`: up to its
    last non-zero column (zero columns change no score)."""
    nz = np.flatnonzero(np.any(corpus != 0, axis=0))
    return int(nz[-1]) + 1 if nz.size else corpus.shape[1]


def save_flat(index, path: str) -> None:
    """Write a fitted `FlatIndex` (sketch, exact tier, ids) to `<path>.npz`
    / `<path>.json`, the JAX package's files: the sketch's live rows and the
    exact tier padded to 128 lanes, bf16 widened to f32."""
    if index.corpus is None:
        raise RuntimeError("nothing to save: fit first")
    n = index.row_ids.shape[0]
    np.savez_compressed(path + ".npz", sketch=pad_lanes(_host_f32(index.sketch[:n])),
                        corpus=pad_lanes(_host_f32(index.corpus)),
                        row_ids=index.row_ids.cpu().numpy().astype(np.int32))
    with open(path + ".json", "w") as f:
        json.dump(dict(engine="flat", sketch_dtype=index.sketch_dtype, scale=float(index.scale),
                       refine=index.refine, block=index.block, query_batch=index.query_batch,
                       mode=index.mode, r_groups=index.r_groups, corpus_dtype=index.corpus_dtype,
                       version=1, dim=int(index.corpus.shape[1])), f)


def load_flat(path: str, device: Device = None):
    """A `FlatIndex` saved by either package's `save_flat`, on `device`
    (default: the first CUDA card)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["engine"] != "flat":
        raise ValueError(f"{path}.json holds a {meta['engine']!r} index, not a flat one")
    with np.load(path + ".npz") as z:
        arrays = {name: z[name] for name in z.files}
    arrays["scale"] = meta["scale"]
    return from_jax_flat(arrays, meta.get("dim") or _true_width(arrays["corpus"]), device,
                         refine=meta["refine"], block=meta["block"],
                         query_batch=meta["query_batch"], mode=meta.get("mode", "grouped"),
                         r_groups=meta.get("r_groups", 24),
                         corpus_dtype=meta.get("corpus_dtype", "float32"))


def save_ivf(index, path: str) -> None:
    """Write a fitted `IVFFlatIndex` (the cluster-ordered sketch and exact
    tier, ids, centroids, cluster starts and ends) to `<path>.npz` /
    `<path>.json`, the JAX package's files: widths padded to 128 lanes,
    centroids as f32, bf16 widened to f32. The JSON's `dim` is the port's
    stored width (the true width rounded up to 32; queries are padded to
    it). The head tier is derived and never saved."""
    st = index.state
    if st is None:
        raise RuntimeError("nothing to save: fit first")
    np.savez_compressed(
        path + ".npz", sketch=pad_lanes(_host_f32(st.sketch)),
        corpus=pad_lanes(_host_f32(st.corpus)),
        row_ids=st.row_ids.cpu().numpy().astype(np.int32),
        centroids=pad_lanes(_host_f32(st.centroids)),
        starts=st.starts.cpu().numpy().astype(np.int32),
        ends=st.ends.cpu().numpy().astype(np.int32))
    with open(path + ".json", "w") as f:
        json.dump(dict(engine="ivf", target_cluster=index.target_cluster, nprobe=index.nprobe,
                       win=index.win, refine=index.refine, iters=index.iters,
                       query_batch=index.query_batch, seed=index.seed, wb=index.wb,
                       train_sample=index.train_sample, head_pool=index.head_pool,
                       keep=index.keep, version=1, dim=int(st.corpus.shape[1]),
                       sketch_dtype=_dtype_name(st.sketch), corpus_dtype=_dtype_name(st.corpus)),
                  f)


def load_ivf(path: str, device: Device = None):
    """An `IVFFlatIndex` saved by either package's `save_ivf`, on `device`
    (default: the first CUDA card), with its head tier rebuilt when the
    saved index prunes windows."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["engine"] != "ivf":
        raise ValueError(f"{path}.json holds a {meta['engine']!r} index, not an IVF one")
    with np.load(path + ".npz") as z:
        arrays = {name: z[name] for name in z.files}
    if "ends" not in arrays:      # an older file: ends at the padded starts
        arrays["ends"] = arrays["starts"][1:]
    index = from_jax_ivf(
        arrays, meta.get("dim") or _true_width(arrays["corpus"]), device,
        target_cluster=meta["target_cluster"], nprobe=meta["nprobe"], win=meta["win"],
        refine=meta["refine"], iters=meta["iters"], query_batch=meta["query_batch"],
        seed=meta["seed"], wb=meta.get("wb"), train_sample=meta.get("train_sample"),
        head_pool=meta.get("head_pool", 0), keep=meta.get("keep", 0))
    narrow = {name: index.state._asdict()[name].to(torch.bfloat16)
              for name in ("sketch", "corpus") if meta.get(f"{name}_dtype") == "bfloat16"}
    if narrow:
        index.state = index.state._replace(**narrow)
        index.ensure_heads()
    return index


# ---------------------------------------------------------------------------
# The sharded flat and IVF engines (one-process meshes)
# ---------------------------------------------------------------------------


def _one_process(index) -> None:
    if index.state is None:
        raise RuntimeError("nothing to save: fit first")
    if index.mesh.process_count > 1:
        raise RuntimeError("a multi-process save is not supported: each process holds only "
                           "its own shards")


def save_sharded_flat(index, path: str) -> None:
    """Write a fitted `ShardedFlatIndex` to `<path>.npz` / `<path>.json`,
    the JAX package's files: the shards' sketch, exact tier and ids
    concatenated in shard order ([S * nloc, ...], the JAX package's
    row-sharded arrays), widths padded to 128 lanes, bf16 widened to f32.
    The JSON adds the port's `dim` and each shard's live rows (`n_live`),
    which the JAX package ignores."""
    _one_process(index)
    sh = index.state.shards
    nloc = index.state.nloc
    np.savez_compressed(
        path + ".npz",
        sketch=pad_lanes(np.concatenate([_host_f32(s.sketch[:nloc]) for s in sh])),
        corpus=pad_lanes(np.concatenate([_host_f32(s.corpus) for s in sh])),
        row_ids=np.concatenate([s.row_ids.cpu().numpy().astype(np.int32) for s in sh]))
    with open(path + ".json", "w") as f:
        json.dump(dict(engine="sharded_flat", sketch_dtype=index.sketch_dtype,
                       refine=index.refine, block=index.block, ndev=index.mesh.n_shards,
                       mode=index.mode, r_groups=index.r_groups, gmax_halved=False,
                       version=1, dim=int(sh[0].corpus.shape[1]),
                       n_live=[int(s.n_live) for s in sh]), f)


def load_sharded_flat(path: str, mesh=None):
    """A `ShardedFlatIndex` saved by either package's `save_sharded_flat`,
    on `mesh` (default: one shard a visible card). Rows are independent
    under the flat engine's local top-k and merge, so the mesh may hold
    another shard count, as long as it divides the stored rows (each
    shard's live rows are then its rows up to the last id that is not -1).
    A JAX file's strided sketch copy (`gmax_halved`) is derived and a TPU
    layout: it is not rebuilt."""
    from ..parallel.mesh import make_forest_mesh

    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["engine"] != "sharded_flat":
        raise ValueError(f"{path}.json holds a {meta['engine']!r} index, not a sharded flat one")
    with np.load(path + ".npz") as z:
        arrays = {name: z[name] for name in z.files}
    mesh = mesh or make_forest_mesh()
    n_live = meta.get("n_live") if meta.get("ndev") == mesh.n_shards else None
    return from_jax_sharded_flat(
        arrays, meta.get("dim") or _true_width(arrays["corpus"]), mesh, n_live=n_live,
        refine=meta["refine"], block=meta["block"], mode=meta.get("mode", "grouped"),
        r_groups=meta.get("r_groups", 24))


def save_sharded_ivf(index, path: str) -> None:
    """Write a fitted `ShardedIVFIndex` to `<path>.npz` / `<path>.json`, the
    JAX package's files: every array with its leading [S] shard axis
    (centroids once, as f32), widths padded to 128 lanes. The per-shard
    cluster layouts are tied to the shard count, which the JSON records."""
    _one_process(index)
    sh = index.state.shards

    def stack(name, fn=lambda a: a):
        return np.stack([fn(_host_f32(getattr(s, name))) for s in sh])

    np.savez_compressed(
        path + ".npz", sketch=stack("sketch", pad_lanes), corpus=stack("corpus", pad_lanes),
        row_ids=stack("row_ids").astype(np.int32),
        centroids=pad_lanes(_host_f32(index.state.centroids)),
        starts=stack("starts").astype(np.int32), ends=stack("ends").astype(np.int32))
    with open(path + ".json", "w") as f:
        json.dump(dict(engine="sharded_ivf", target_cluster=index.target_cluster,
                       nprobe=index.nprobe, win=index.win, refine=index.refine,
                       iters=index.iters, seed=index.seed, wb=index.wb,
                       head_pool=index.head_pool, keep=index.keep, ndev=len(sh), version=1,
                       dim=int(sh[0].corpus.shape[1])), f)


def load_sharded_ivf(path: str, mesh=None):
    """A `ShardedIVFIndex` saved by either package's `save_sharded_ivf`, on
    `mesh` (default: one shard a visible card), which must hold the saved
    shard count; the head tier is rebuilt when the index prunes."""
    from ..parallel.mesh import make_forest_mesh

    with open(path + ".json") as f:
        meta = json.load(f)
    if meta["engine"] != "sharded_ivf":
        raise ValueError(f"{path}.json holds a {meta['engine']!r} index, not a sharded IVF one")
    with np.load(path + ".npz") as z:
        arrays = {name: z[name] for name in z.files}
    mesh = mesh or make_forest_mesh()
    if mesh.n_shards != meta["ndev"]:
        raise ValueError(f"saved for {meta['ndev']} shards, the mesh has {mesh.n_shards} "
                         "(per-shard cluster layouts are tied to the shard count)")
    dim = meta.get("dim") or _true_width(arrays["corpus"].reshape(-1, arrays["corpus"].shape[-1]))
    return from_jax_sharded_ivf(
        arrays, dim, mesh, target_cluster=meta["target_cluster"], nprobe=meta["nprobe"],
        win=meta["win"], refine=meta["refine"], iters=meta["iters"], seed=meta["seed"],
        wb=meta.get("wb"), head_pool=meta.get("head_pool", 0), keep=meta.get("keep", 0))
