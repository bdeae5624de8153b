"""Configuration system for the Dynamic Partition Forest.

A copy of `similaritysearchbyrdf_tpu/config.py` (framework-free), so
the same configuration drives both packages. Its comments describe the TPU
build where a knob was made for it.

Mirrors the reference's Typesafe-Config (HOCON) key space (the full `mclab.*`
namespace is enumerated in the reference at
`src/test/scala/mclab/TestSettings.scala:6-60`) as typed dataclasses, without
the reference's global-static mutation on construction (`LSH.scala:23-24`),
which SURVEY.md flags as a design to avoid.

Two entry points:
  * :class:`RDFConfig` — the typed config used by the whole framework.
  * :func:`from_hocon_dict` / :func:`parse_hocon` — accept the reference's flat
    `mclab.*` key-value space (e.g. parsed from a `.conf` file) so existing
    reference configs can drive the TPU build unmodified.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Optional


# ---------------------------------------------------------------------------
# Typed configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Per-table-family structure knobs.

    Mirrors `mclab.lshTable.*` / `mclab.dataTable.*`
    (reference `TestSettings.scala:29-37`, applied in
    `DensevectorRDFInit.setupTable`, `DensevectorRDFInit.scala:37-43`).
    """

    bucket_overflow: int = 500   # mclab.*.bufferOverflow  (split threshold)
    bucket_bits: int = 28        # mclab.*.bucketBits      (BUCKET_LENGTH)
    dir_node_size: int = 32      # mclab.*.dirNodeSize     (trie fan-out)
    chain_length: int = 32       # mclab.*.chainLength     (hash bits per table)

    @property
    def seg_bits(self) -> int:
        """Top-of-hash segment bits: 32 - BUCKET_LENGTH
        (ref `RandomDrawTreeMap.java:435-438`)."""
        return 32 - self.bucket_bits

    @property
    def bits_per_level(self) -> int:
        """log2(dirNodeSize) bits consumed per trie level
        (ref `RandomDrawTreeMap.java:446-453`)."""
        return self.dir_node_size.bit_length() - 1

    @property
    def max_tree_level(self) -> int:
        """MAX_TREE_LEVEL = (32 - seg_bits)/bits_per_level - 1
        (ref `RandomDrawTreeMap.java:456`)."""
        return self.bucket_bits // self.bits_per_level - 1

    def __post_init__(self) -> None:
        if self.dir_node_size not in (32, 64, 128):
            # ref exits on bad node size (`RandomDrawTreeMap.java:461-464`);
            # we raise instead.
            raise ValueError(
                f"dir_node_size must be one of 32/64/128, got {self.dir_node_size}"
            )
        if not (0 < self.bucket_bits <= 32):
            raise ValueError(f"bucket_bits must be in (0,32], got {self.bucket_bits}")


@dataclasses.dataclass(frozen=True)
class PStableConfig:
    """p-stable (E2LSH) family parameters: H(v)=floor((a.v+b)/W)
    (ref `PStableHashFamily.scala:24-57`, keys `mclab.lsh.family.pstable.*`)."""

    mu: float = 0.0
    sigma: float = 1.0
    w: int = 4


@dataclasses.dataclass(frozen=True)
class RDFConfig:
    """Top-level configuration (the `mclab.lsh.*` key space)."""

    # --- hash family (ref `LSH.scala:29-53`) ---
    family_name: str = "angle"            # mclab.lsh.name: angle | pStable
    family_size: int = 100                # mclab.lsh.familySize
    vector_dim: int = 100                 # mclab.lsh.vectorDim
    table_num: int = 10                   # mclab.lsh.tableNum
    permutation_num: int = 3              # mclab.lsh.permutationNum
    generate_by_pulling: bool = True      # mclab.lsh.generateByPulling
    is_orthogonal: bool = True            # mclab.lsh.IsOrthogonal
    generate_method: str = "default"      # mclab.lsh.generateMethod: default|fromfile
    family_file_path: Optional[str] = None        # mclab.lsh.familyFilePath
    partition_family_file_path: Optional[str] = None  # mclab.lsh.partitionFamilyFilePath
    # mclab.confType: which hash-family file a fromfile chain loads — "lsh"
    # reads familyFilePath, "partition" reads partitionFamilyFilePath
    # (`LSH.scala:71-77`; the reference's checked-in
    # partition-bestHashFamily-angle resources use the latter)
    conf_type: str = "lsh"
    type_of_index: str = "original"       # mclab.lsh.typeOfIndex:
    #   original | sampling | continueBitsCount | angleNewMethod
    #   (ref `LSH.scala:110-120`)
    sampling_seed: int = 88387            # hardcoded in ref `LSH.scala:21`
    pstable: PStableConfig = dataclasses.field(default_factory=PStableConfig)
    feature_data_format: str = "dense"    # mclab.lsh.featureDataFormat: dense|sparse

    # --- partitioning (ref `utils/Partitioner.scala:27-65`) ---
    partition_bits: int = 3               # mclab.lsh.partitionBits
    num_data_partitions: int = 2          # mclab.dataTable.numPartitions

    # --- table structure ---
    lsh_table: TableConfig = dataclasses.field(default_factory=TableConfig)
    data_table: TableConfig = dataclasses.field(default_factory=TableConfig)

    # --- query / eval ---
    top_k: int = 10                       # mclab.lsh.topK
    # mclab.lsh.similarityThreshold. In the reference this backs a DEAD
    # hash-Hamming-distance post-filter (`RandomDrawTreeMap.java:856-868`);
    # here a value > 0 post-filters forest query results by exact similarity
    # score (ids with score < threshold become -1). 0.0 = off.
    similarity_threshold: float = 0.0

    # --- persistence (ref §3.5) ---
    working_dir_root: str = "PersistIndex"  # mclab.lsh.workingDirRoot
    ram_threshold: int = 2 ** 31 - 1        # mclab.lsh.ramThreshold

    # --- threads in the reference; batch-shape knobs on TPU ---
    # The reference's insertThreadNum/queryThreadNum become batching knobs:
    # TPU processes all tables at once, so these only control host chunking.
    fit_batch_size: int = 8192            # vectors hashed per device step
    query_batch_size: int = 256           # queries per device step

    # --- TPU-specific static-shape caps (SURVEY.md §7 hard part (b)) ---
    max_candidates: int = 4096            # per-query flattened candidate cap
    sparse_nnz_pad: int = 128             # padded nnz for sparse batches
    # dtype of the device-resident corpus used for exact re-ranking.
    # "bfloat16" halves HBM traffic of the candidate gather (the query hot
    # spot) and index memory, at ~3 decimal digits of score precision —
    # ranking of top-10 candidates is essentially unaffected. f32 default
    # keeps bit-exact parity with the scalar oracle.
    rerank_dtype: str = "float32"         # float32 | bfloat16
    # Table-ordered coarse scoring tier (TPU extension; no reference
    # counterpart). When set, the fit keeps a low-dim (coarse_dim) random
    # projection of every corpus row PER TABLE IN BUCKET-SORTED ORDER, so
    # coarse candidate scoring gathers CONTIGUOUS blocks (gather cost on
    # TPU is per-index, so scoring 32k candidates costs ~4k block gathers
    # instead of 32k row gathers). Only the top `coarse_refine` coarse
    # candidates are exactly re-scored at full precision. Costs
    # L × N × coarse_dim × 2 bytes of HBM.
    # route angle hashing through the Pallas fused matmul+sign+bitpack
    # kernel (measured ~10% faster than the XLA path on v5e at bench
    # shapes; bit-identical — scripts/bench_pallas_hash.py)
    use_pallas_hash: bool = False
    coarse_dim: Optional[int] = None      # projection dim; = vector_dim for
    #                                       full-dim (no projection loss)
    coarse_dtype: str = "int8"            # int8 | bfloat16 storage
    coarse_refine: int = 2048             # exact-rescore width
    # aligned-window flatten for the coarse gather: -1 auto (64-slot
    # windows when max_candidates >= 32768 — the regime where the Pallas
    # DMA gather's bandwidth win beats the per-range window round-up),
    # 0 force block mode, >0 explicit window size in slots
    coarse_window: int = -1
    # two-phase window pruning (TPU extension, round 3): a mean-pooled
    # "head" tier (one bf16 row per `coarse_head_pool` consecutive
    # table-ordered coarse rows) is scored with fast row gathers FIRST,
    # and only the top `coarse_keep` windows per query pay the window DMA
    # + wide select. Attacks the ~1.2 us/descriptor DMA floor (the
    # Deep-8M coarse stage is descriptor-bound: 57 of a 123 ms chunk).
    # coarse_head_pool=0 disables the tier; coarse_keep=0 disables pruning
    # (tier may still be built for per-call opt-in via `window_keep`).
    coarse_head_pool: int = 0             # rows pooled per head row (e.g. 64)
    coarse_keep: int = 0                  # windows kept per query (0 = all)
    # coarse tier LAYOUT (TPU extension, round 3): "lane" packs G = 128/cs
    # TABLES per 128-lane row (window DMAs read 128 B per candidate slot);
    # "folded" packs fold = 128/cs CONSECUTIVE slots of ONE table per row —
    # every fetched byte is a candidate byte, so the same descriptor budget
    # covers fold x more candidates — and queries run the groupmax path
    # (in-kernel argmax packing, ops/pallas/coarse_fold.py): the select
    # sees one int32 per `coarse_group` slots and only the top
    # `coarse_rows_keep` rows per group are exactly re-ranked. int8 only.
    coarse_layout: str = "lane"           # lane | folded
    # coarse projection basis: "random" = seeded QR (round-1 default);
    # "pca" = top-cd eigenvectors of the corpus's uncentered second moment
    # (deterministic in the corpus — better coarse rank order at the same
    # cd, so the same recall needs a smaller coarse_refine)
    coarse_proj_mode: str = "random"      # random | pca
    coarse_group: int = 64                # slots per argmax group (pow2)
    # over-select groups by this factor, dedup candidate ids (two sorts),
    # truncate back to coarse_refine UNIQUE candidates: the exact rerank
    # pays per slot, but ~half the selected slots are the same row reached
    # from different tables (scripts/check_fold_dups.py) — 1 = off
    coarse_select_mult: int = 1
    # rows exactly re-ranked per selected group: 0 = the WHOLE group
    # (groups select, slots re-rank — contiguous gathers; the default),
    # 1|2 = only the per-group packed winner row(s)
    coarse_rows_keep: int = 0
    # staged rerank (folded layout, rows_keep=0): int8-rescore every slot
    # of the selected groups, dedup ids in coarse-score order, and exact-
    # score only the best `coarse_stage2` unique ids (the exact stage pays
    # ~20 ns per fetched row — 54% of the shipped Deep-8M chunk). 0 = off
    # (every selected slot is exactly scored, the r4 behavior)
    coarse_stage2: int = 0
    # engine selector (TPU extension): "forest" = the reference-semantics
    # DPF index; "flat" = the quantized-flat MXU scan (ops/flat.py) behind
    # the same front-end surface — fastest for HBM-resident dense corpora,
    # no steps/probe knobs (it scores every row)
    engine: str = "forest"

    # --- reproducibility ---
    seed: int = 31258                     # mclab.lsh.seed1

    @property
    def total_tables(self) -> int:
        """L = tableNum * permutationNum — the forest width
        (ref `DensevectorRDFInit.scala:107`)."""
        return self.table_num * self.permutation_num

    @property
    def hash_tables(self) -> int:
        """Tables the hash model actually produces. The reference's pStable
        pick ignores permutationNum (`PStableHashFamily.pick` draws tableNum
        chains, `PStableHashFamily.scala:59-77`), so a pStable forest is
        tableNum wide; everything sized per hash table (partition chains,
        bucket tables) must use this, not `total_tables`."""
        if self.family_name == "pStable":
            return self.table_num
        return self.table_num * self.permutation_num

    @property
    def num_partitions(self) -> int:
        """Sub-indexes per table = 2**partitionBits
        (ref `utils/Partitioner.scala:28`)."""
        return 1 << self.partition_bits

    def replace(self, **kw: Any) -> "RDFConfig":
        return dataclasses.replace(self, **kw)

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RDFConfig":
        d = json.loads(s)
        d["pstable"] = PStableConfig(**d.get("pstable", {}))
        d["lsh_table"] = TableConfig(**d.get("lsh_table", {}))
        d["data_table"] = TableConfig(**d.get("data_table", {}))
        return RDFConfig(**d)


# ---------------------------------------------------------------------------
# HOCON-compatible loading (the reference's flat mclab.* key space)
# ---------------------------------------------------------------------------

_KEY_MAP = {
    "mclab.lsh.name": "family_name",
    "mclab.lsh.familySize": "family_size",
    "mclab.lsh.vectorDim": "vector_dim",
    "mclab.lsh.tableNum": "table_num",
    "mclab.lsh.permutationNum": "permutation_num",
    "mclab.lsh.generateByPulling": "generate_by_pulling",
    "mclab.lsh.IsOrthogonal": "is_orthogonal",
    "mclab.lsh.generateMethod": "generate_method",
    "mclab.lsh.familyFilePath": "family_file_path",
    "mclab.lsh.partitionFamilyFilePath": "partition_family_file_path",
    "mclab.confType": "conf_type",
    "mclab.lsh.typeOfIndex": "type_of_index",
    "mclab.lsh.featureDataFormat": "feature_data_format",
    "mclab.lsh.partitionBits": "partition_bits",
    "mclab.dataTable.numPartitions": "num_data_partitions",
    "mclab.lsh.topK": "top_k",
    "mclab.lsh.similarityThreshold": "similarity_threshold",
    "mclab.lsh.workingDirRoot": "working_dir_root",
    "mclab.lsh.ramThreshold": "ram_threshold",
    "mclab.lsh.seed1": "seed",
}

_TABLE_KEY_MAP = {
    "bufferOverflow": "bucket_overflow",
    "bucketBits": "bucket_bits",
    "dirNodeSize": "dir_node_size",
    "chainLength": "chain_length",
}

_PSTABLE_KEY_MAP = {
    "mclab.lsh.family.pstable.mu": "mu",
    "mclab.lsh.family.pstable.sigma": "sigma",
    "mclab.lsh.family.pstable.w": "w",
}


def _coerce(value: str) -> Any:
    v = value.strip().strip('"')
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def parse_hocon(text: str) -> Dict[str, Any]:
    """Parse the flat `key = value` subset of HOCON the reference uses
    (`TestSettings.scala:6-60`). Comments (#, //) and blank lines are skipped.
    """
    out: Dict[str, Any] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        m = re.match(r"^([A-Za-z0-9_.\-]+)\s*[=:]\s*(.+)$", line)
        if not m:
            continue
        out[m.group(1)] = _coerce(m.group(2))
    return out


def from_hocon_dict(conf: Dict[str, Any], base: Optional[RDFConfig] = None) -> RDFConfig:
    """Build an :class:`RDFConfig` from a flat `mclab.*` dict, mirroring how
    the reference front-ends read Typesafe Config
    (`DensevectorRDFInit.scala:50-70`)."""
    base = base or RDFConfig()
    kw: Dict[str, Any] = {}
    for hk, field in _KEY_MAP.items():
        if hk in conf:
            kw[field] = conf[hk]
    ps = {f: conf[hk] for hk, f in _PSTABLE_KEY_MAP.items() if hk in conf}
    if ps:
        kw["pstable"] = dataclasses.replace(base.pstable, **ps)
    for table, field in (("lshTable", "lsh_table"), ("dataTable", "data_table")):
        tk = {
            dst: conf[f"mclab.{table}.{src}"]
            for src, dst in _TABLE_KEY_MAP.items()
            if f"mclab.{table}.{src}" in conf
        }
        if tk:
            kw[field] = dataclasses.replace(getattr(base, field), **tk)
    return base.replace(**kw)


def from_hocon_file(path: str, base: Optional[RDFConfig] = None) -> RDFConfig:
    with open(path, "r") as f:
        return from_hocon_dict(parse_hocon(f.read()), base)


def partition_config(conf: RDFConfig) -> RDFConfig:
    """Synthesize the partitioner LSH config exactly as the reference does
    when building each lshTable's `LocalitySensitivePartitioner`
    (`DensevectorRDFInit.scala:63-70`): vectorDim=32 (the hash bits),
    tableNum=1, chainLength=partitionBits."""
    return conf.replace(
        vector_dim=32,
        table_num=1,
        permutation_num=1,
        lsh_table=dataclasses.replace(conf.lsh_table, chain_length=conf.partition_bits),
        generate_method="default",
        type_of_index="original",
    )
