#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds the
port's CUDA kernels from `similaritysearchbyrdf_tpu_torch/csrc/` (first use,
cached in `build/kernels/`), then runs these phases and fails loudly — a
non-zero exit and no result line — on any error, mismatch, or when no CUDA
device is present:

  1. kernels: each kernel against its plain PyTorch version on the card, at
     the bench config's shapes (K1 hash at B 1024 with margins, timed also
     at the fit's B 8192 without; K2 coarse scores at B 1024 x 512 blocks
     of 8 rows of a real fit's tier, with the tier bytes it gathers beside
     the distinct ones, its achieved rate and its share of the bound; K2
     again on the bf16 tiers of the bench corpus fitted with
     coarse_dtype="bfloat16", at cs 32 and, with coarse_dim 100, cs 128),
     with timings;
  2. bench_20k: the bench config (`bench.py`) on the bench corpus: fit, warm
     fit, query, recall@10 against exact ground truth, the kernels' launch
     counts over that main path, and agreement with the port's CPU path
     (block mode, and window mode at m_cap 32768);
  3. deploy_1m: 1,000,000 x 100 GloVe-shaped clustered vectors with the
     same index config (plus a head tier): fit, 1,000 queries, recall,
     peak device memory;
  4. kernels_window: K2b (window scores) against its plain version at the
     window-mode query's shapes on the 1M fit (B 128 x 1024 windows of 64),
     with the tier bytes it gathers beside the distinct ones, its achieved
     rate and its share of the bound;
  5. window_1m: the 1M forest in window mode (`scripts/bench_large.py`'s
     config 2: m_cap 65536, refine 1024, batch 128), without and with
     window pruning: recall, qps, the kernels' launch counts;
  6. folded_8m: 8,000,000 x 96 Deep-shaped clustered vectors with the
     folded tier (`scripts/bench_deep8m_coarse.py`'s operating point):
     fit, K3 (folded rowmax) against its plain version at the query's
     shapes with its achieved rates (gathered and distinct bytes per ms),
     the top-k select (`topk_select`) on a real chunk's group-select values
     and stage2 keys against its plain version, with `torch.topk` beside
     it, 1,024 queries (the top-k select must launch), recall, qps, bytes,
     peak device memory;
  7. flat_20k (after bench_20k): `bench.py`'s flat leg, `flat_topk` with
     refine 128, and `FlatIndex()` in grouped mode (exact2: K4 unpacked and
     K2b) on the bench corpus: recall against the JAX package's on the
     CPU, qps, launches, agreement with the port's CPU path, and K4 (int8,
     and bf16 on bf16 copies of the same values) and K2b against their
     plain versions on the operands the grouped leg gave them (K2b with
     its bytes, rate and bound share as in phase 4);
  8. kernels_flat: K4 (flat group-max) against its plain version at the
     Deep-8M flat query's shapes (int8 packed, unpacked, packed with the
     supergroup tier at 16 and at 32, the width the path asks for: the
     wgmma form), and its K-looped wgmma form at 200k
     x 800 (random int8), each with the form it took and the share of its
     bound it reached;
  9. flat_8m: `FlatIndex()` at its defaults (int8, argpack) on folded_8m's
     corpus and ground truth: fit, 1,024 queries, recall, qps, bytes,
     peak device memory; then flat_8m_bf16, `FlatIndex(sketch_dtype=
     "bfloat16")` on the same corpus (exact2: K4 in bf16, K2b's bf16
     re-score): recall@10 >= 0.995, qps, launches, a profile, K4 bf16 on
     its own operands within the f32 bound and, on the int8 sketch and
     queries as bf16 values, word for word K4 int8's, K2b on its own;
 10. options_1m (after window_1m): the 1M corpus fitted with the bench
     config plus the forest's last three options (a bf16 coarse tier on a
     PCA basis, the bf16 two-stage rerank), queried in block mode at
     deploy_1m's settings (K2 on the bf16 tier) and in window mode at
     window_1m's (K2b on it): recall against the int8 fit's in the same
     mode, qps, build rate, bytes, peak memory, launches, a device profile,
     agreement with the port's CPU path on the same index;
 12. frontend_1m (after window_1m): deploy_1m's corpus and config through
     the front ends, queried in the reference probe mode: `DenseRDFInit`
     fitted by `fit_batch`, its vector query (ids bit-equal to deploy_1m's
     forest queried alike), key query (the same ids; [] for 8 unknown
     keys), precision (equal to the recall@10) and distributions (each
     table's partition counts sum to N); its flat engine (recall@10 >=
     0.995); `RDFMap` (100,000 puts, get_similar on 100 keys equal to a
     forest fitted on the same rows); a model file reloaded through
     generate_method="fromfile" (K1 at P = 1, hashes bit-equal to the saved
     model's). K1 and K2 on the vector query's first call, K4 (unpacked,
     1M x 100) and K2b (exact2 re-score) on the flat engine's first query,
     and K1 on the loaded model are held against their plain versions on
     those operands, with times, bounds and errors. Every call's launches
     (K1 and K2 on each forest call, K4 on the flat engine's query) and qps,
     a device profile of the vector query, the phase's seconds;
 13. dynamic_1m: `DynamicForest` fitted on the first 900,000 rows, 10
     inserts of 10,000 rows (no compaction), 1,000 queries half of them
     inserted rows: the device merge equal to the JAX package's host merge
     redone from each tier's own lists, recall@10 against the live set's
     exact ground truth beside deploy_1m's one-shot fit's, 64 removals (no
     removed id returned; 128 queries equal to the CPU path up to
     exact-score ties), the 65th compacting (then equal to a fresh fit on
     the surviving rows, bit for bit); fit, insert, delta-rebuild and
     compaction times, merged qps, launches, a device profile of the merged
     query, the phase's seconds; K1 (the delta fit's first chunk, the
     query's hash) and K2 (the 900k main and the 100k delta tier) against
     their plain versions on the operands of the query that rebuilds the
     delta;
 14. persist_1m (after dynamic_1m): deploy_1m's forest saved (compressed) and
     loaded, its rebuilt coarse and head tiers equal to the fitted ones and
     its 1,000 queries' ids bit-equal (recall@10 equal to deploy_1m's); a
     `FlatIndex()` on the same corpus and an `IVFFlatIndex(target_cluster=256,
     iters=6)` on its first 200,000 rows saved and loaded with equal ids; a `TieredForest` over 4
     uncompressed generations of 250,000 rows, its merge equal to the host
     merge of the generations' own lists, the second query reading nothing
     from disk, `get` of 100 keys; save and load seconds, file bytes per
     vector, merged qps; K1 and K2 (the loaded forest's first query), K4 and
     K2b (the loaded flat index's) and K2b (the loaded IVF index's) against
     their plain versions on those operands; the native parser on a dense
     text file, built and used; the phase's seconds;
 11. ivf_8m (after flat_8m): `IVFFlatIndex(target_cluster=256, iters=6)` on
     the same Deep-8M corpus and ground truth, built twice from one seed
     (the layouts must be equal), queried at three points (nprobe 2 / win
     128, nprobe 1 / win 64, nprobe 8 / win 64 pruned to 64 windows by a
     64-row head tier): build and k-means seconds, recall, qps, bytes, peak
     memory, a device profile, and K2b against its plain version on the
     operands each point gave it; at the headline point the top-k select's
     f32 form (`top_sorted` on the card) on the query's own centroid and
     window scores, bit for bit against the stable sort's prefix and timed
     beside it and `torch.topk`; the launch counts of the top-k select by
     kind and form (`topk_forms`);
 15. sparse_1m (last): `scripts/bench_sparse_1m.py`'s corpus and config,
     1,000,000 x 4096 rows of 64 non-zeros: exact ground truth of 1,024
     self-excluded queries (`exact_topk_sparse`, equal to an f32 product
     of densified chunks up to ties), the `SparseRDFForest` fit from rows
     on the card (seconds, build rate, bytes, peak memory), its queries at
     (steps 0, refine 2048), (0, 4096) and (1, 8192) (recall beside the
     TPU v5e's, qps, a device profile of the last), the first 64 queries
     again on the CPU path (equal up to exact-score ties), the
     `SparseFlatIndex()` on the same corpus (build, bytes, recall, qps, a
     profile; recall again with more groups kept and more rows re-scored),
     and K1 (a fit chunk, B 8192, and a query chunk, B 64, at D 4096: its
     wide form), K2 (cs 64), K2b (the 4096-wide sketch as one table) and K4
     (D 4096, all 1,007,616 rows: its K-looped form) against their plain
     versions on the operands the path gave them, K1 and K4 with their
     product alone beside them (`product_ms`: a full-f32 `torch.matmul`,
     `torch._int_mm` in row slabs; a yardstick the port never calls), every
     call's launches; then its sharded leg, 4 shards on
     the card: `fit_sparse_sharded` queried by `make_sparse_query_fn` (the
     classic path: steps 0, m_cap 16384, chunks of 64; K1 at D 4096) and
     `ShardedSparseFlatIndex()` (K4 and K2b at D 4096), each recall beside
     the single-device engines', each merge equal to the host merge of the
     shards' own lists, K1, K4 and K2b held on shard 0's first call;
 16. sharded_8m (after ivf_8m): folded_8m's Deep-8M corpus with ids drawn
     sparsely from [0, 100M) (`scripts/deep100m_capstone.py:77-83`), 8
     shards on `cuda:0` (1,000,064 rows a forest shard): `ShardedRDFForest`
     at folded_8m's config (K1, K3) and at the bench config in block mode
     (K1, K2), `ShardedFlatIndex()` (K4, K2b), `ShardedIVFIndex` at
     ivf_8m's headline point (K2b), built one at a time: fit s, recall@10
     beside the single-device phases', qps, peak memory, launches, a device
     profile, every id one of the corpus's, the merge equal to the host
     merge of each shard's own lists (first 64 queries), each kernel held
     against its plain version on shard 0's first call; sharded flat and
     IVF recall >= 0.995. Then two gloo ranks on the card, 4 shards each
     (this script with `--rank`), fit their halves of the first 1,048,576
     rows through the multi-process fits; their ids must equal this
     process's one-process 8-shard fits bit for bit. Each rank also records
     which gloo collectives carry CUDA tensors.

Each phase prints one JSON line. `chip_smoke.py --rank R --port P --out DIR
--rows N` is one rank of sharded_8m's two-process leg, started by the
script itself. A kernel's `ms` is CUDA events around one
call on an idle card, the wrapper's host time included; `device_ms` beside
it is the same with the card first held busy by a ~1 ms spin, so that the
host's work overlaps the spin and the events time the device alone
(`ops/kernels/timing.py`'s `median_event_ms`). Then come the kernel summary
line
`{"kernels": [...]}`, with each kernel's least possible time on the card
(`bound_ms`: the larger of its bytes over the memory rate and its
operations over the peak rate for their type, counted from this run's
inputs), and, last, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# recall@10 of the JAX package at this exact config (bench.py's, plus
# use_pallas_hash=True), 1000 self-excluded queries on make_data(seed=42),
# exact f32 ground truth: measured on the CPU with jax 0.9.0
# (`RDFForest.query(..., probe_mode="margin", probe_budget=16)`). The TPU
# v5e run of bench.py (BENCH_r05.json, without use_pallas_hash) read 0.9813.
JAX_CPU_RECALL = 0.9882
RECALL_TOL = 0.005
N_QUERY = 1000
U32 = 2.0 ** -24            # unit roundoff of f32
# recall@10 of the JAX package on a TPU v5e at the folded_8m operating point
# (results/deep8m_coarse_fold.json: steps 1, margin 16, refine 12288,
# window 4096, m_cap 524288, overflow 2000): a parity reference, not a target
TPU_DEEP8M_RECALL = 0.8605
# recall@10 of the JAX package on the CPU (jax 0.9.0) on the bench corpus,
# 1000 self-excluded queries padded to 1024: `flat_topk(refine=128)` (bench's
# flat leg) and `FlatIndex()` (grouped, exact2 at 20k rows)
JAX_CPU_FLAT_RECALL = 1.0
JAX_CPU_FLAT_GROUPED_RECALL = 1.0
# recall@10 of the JAX package's FlatIndex (argpack, refine 128) on a TPU v5e
# at 8M x 96 (results/tune_argpack.json): a parity reference, gated at 0.995
TPU_FLAT8M_RECALL = 1.0
FLAT8M_RECALL_MIN = 0.995
# published H100 SXM peaks (dense): memory bytes/s and operations/s by type
PEAK = {"bytes": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the peak rate for their type, whichever is larger."""
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": float(nbytes), "bound_ops": float(ops), "bound_ops_type": kind}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# every emitted phase line by its name, for later phases to set beside theirs
RESULTS: dict = {}


def emit(obj) -> None:
    if "phase" in obj:
        RESULTS[obj["phase"]] = obj
    print(json.dumps(obj), flush=True)


QUERY_KW = dict(steps=0, probe_mode="margin", probe_budget=16)
WINDOW_M_CAP = 65536        # scripts/bench_large.py's config 2


def clustered(n, d, n_clusters, noise, seed=7):
    """GloVe-1.2M-shaped clustered corpus (scripts/bench_large.py:19-25)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_clusters, n)] + noise * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def deep_corpus(n, d=96, n_clusters=50_000, noise=0.05, seed=11, chunk=1 << 20, rows=None):
    """Deep-8M-shaped clustered corpus (scripts/bench_deep8m_coarse.py:75-83),
    drawn from the same generator in the same order, a chunk of rows at a
    time so the float64 temporaries stay small. `rows` stops after the
    first that many rows of the n-row corpus (the same values)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    n = n if rows is None else rows
    out = np.empty((n, d), dtype=np.float32)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        x = centers[assign[c0:c1]] + noise * rng.normal(size=(c1 - c0, d))
        out[c0:c1] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return out


def recall_at(gt: np.ndarray, got: np.ndarray) -> float:
    hits = sum(len(set(gt[i].tolist()) & set(int(v) for v in got[i] if v >= 0))
               for i in range(len(gt)))
    return hits / gt.size


def reset_launches() -> None:
    """Zero every kernel's launch count, right before a main path runs."""
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
    from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1
    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as TK

    K1.LAUNCHES = K2.LAUNCHES = K2.WINDOW_LAUNCHES = K3.LAUNCHES = K4.LAUNCHES = 0
    TK.FORM_LAUNCHES.clear()


def read_launches() -> dict:
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
    from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1
    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as TK

    return {"hash_dense_kernel": K1.LAUNCHES, "coarse_block_scores_kernel": K2.LAUNCHES,
            "coarse_window_scores_kernel": K2.WINDOW_LAUNCHES,
            "coarse_rowmax_kernel": K3.LAUNCHES, "flat_groupmax_kernel": K4.LAUNCHES,
            "topk_select": TK.launches(TK.KEY_KINDS), "topk_select_f32": TK.launches(("f32",))}


def read_forms() -> dict:
    """The top-k select's launches since the reset by kind and form
    (`"<kind>.<form>"`, `topk_select.FORM_LAUNCHES`)."""
    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as TK

    return dict(TK.FORM_LAUNCHES)


def timed_s(fn, sync, reps: int) -> float:
    """Median host-clock seconds of `reps` calls, each ending in a sync."""
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def kernel_times(fn) -> dict:
    """A kernel's `ms` and `device_ms` over 20 calls, as the module docstring
    defines them."""
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing

    return timing.kernel_times(fn, reps=20)


def gather_rates(gathered: int, distinct: int, rec: dict) -> dict:
    """A gather kernel's bytes and achieved rates: the tier bytes of every
    valid slot as it reads them (`gathered`) beside the distinct ones the
    bound counts; `achieved_gb_per_s` counts what it moves, the gathered
    bytes plus the small inputs and the output, over `ms`;
    `gathered_gb_per_s` the gathered bytes over `ms`; `bound_share` is
    bound_ms / ms; the `device_` keys are the same over `device_ms`."""
    moved = rec["bound_bytes"] - distinct + gathered
    out = {"gathered_bytes": gathered, "distinct_bytes": distinct}
    for pre in ("", "device_"):
        t = rec[pre + "ms"]
        out.update({pre + "achieved_gb_per_s": moved / t / 1e6,
                    pre + "gathered_gb_per_s": gathered / t / 1e6,
                    pre + "bound_share": rec["bound_ms"] / t})
    return out


def block_kernel_check(tier, q_low, table_i, blk_start, bs, sync, median_ms) -> dict:
    """K2 against its plain version on one set of operands (int8 or bf16
    tier), within the f32 summation bound, with its form, times, bound and
    gathered and distinct bytes."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.kernels import build
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2

    b, mb = table_i.shape
    sk = K2.coarse_block_scores_kernel(tier, q_low, table_i, blk_start, bs)
    sp = K2.coarse_block_scores_plain(tier, q_low, table_i, blk_start, bs)
    sync()
    s_abs = K2.coarse_block_scores_plain(tier.abs(), q_low.abs(), table_i, blk_start, bs)
    s_err = (sk - sp).abs()
    check(bool((s_err <= 2 * tier.shape[2] * U32 * s_abs).all()),
          f"K2 ({tier.dtype}, cs {tier.shape[2]}) exceeds the f32 bound: max err "
          f"{float(s_err.max())}")
    caprows, cs = tier.shape[1], tier.shape[2]
    lib_form = ("generic", "b8")[build.library().rdf_coarse_block_form(
        cs, bs, b, mb, int(tier.dtype == torch.bfloat16))]
    check(lib_form == K2.block_kernel_form(cs, bs, b, mb, tier.dtype == torch.bfloat16),
          f"K2's form mirror disagrees with the library at cs {cs}: {lib_form}")
    row_bytes = cs * tier.element_size()
    blk_rows = (table_i.long().clamp(0, tier.shape[0] - 1)[..., None] * caprows
                + blk_start.long().clamp(0, caprows - bs)[..., None]
                + torch.arange(bs, device=tier.device))
    distinct = int(torch.unique(blk_rows).numel()) * row_bytes
    out = {"shape": {"B": b, "MB": mb, "bs": bs, "L": tier.shape[0], "caprows": caprows,
                     "cs": cs, "tier": str(tier.dtype)},
           "form": K2.block_kernel_form(cs, bs, b, mb, tier.dtype == torch.bfloat16),
           "max_abs_err": float(s_err.max()),
           "tolerance": "|err| <= 2*cs*2^-24*sum_c|tier*q| per score",
           **bound(distinct + nbytes(q_low, table_i, blk_start, sk), 2.0 * sk.numel() * cs,
                   "bf16"),
           **kernel_times(lambda: K2.coarse_block_scores_kernel(tier, q_low, table_i,
                                                                blk_start, bs)),
           "plain_ms": median_ms(lambda: K2.coarse_block_scores_plain(tier, q_low, table_i,
                                                                      blk_start, bs))}
    # every block is read whole: gathered bytes are B * MB * bs rows
    out.update(gather_rates(sk.numel() * row_bytes, distinct, out))
    return out


def hash_check(x, proj, perm, margins: bool, sync, median_ms, where: str) -> dict:
    """K1 against its plain version on one set of operands (any T, P, C):
    hash words equal except for bits whose dot lies within float noise
    (1e-5) of 0, margins (when asked) within the f32 summation bound and
    with the same inf layout; with its times and bound."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.bitops import pack_bits_msb_first, popcount
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1

    hk, mk = K1.hash_dense_kernel(x, proj, perm, margins)
    hp, mp = K1.hash_dense_plain(x, proj, perm, margins)
    sync()
    b, d = x.shape
    dots = torch.einsum("bd,tcd->btc", x.double(), proj.double())
    near_fn = dots.abs() <= 1e-5                                         # [B, T, C]
    idx = perm.long()[None].expand(b, -1, -1, -1)
    near_bits = torch.gather(near_fn[:, :, None, :].expand(-1, -1, idx.shape[2], -1), 3, idx)
    near_mask = pack_bits_msb_first(near_bits).reshape(b, -1)
    diff = hk ^ hp
    far = int((diff & ~near_mask).ne(0).sum())
    check(far == 0, f"K1 on {where} differs from its plain version in {far} words away "
                    f"from near-zero dots")
    t, c, _ = proj.shape
    out = {"shape": {"B": b, "D": d, "T": t, "P": perm.shape[1], "C": c, "margins": margins},
           "far_mismatch_words": far, "near_zero_bit_flips": int(popcount(diff & near_mask).sum()),
           "tolerance": "hash words equal away from |dot| <= 1e-5"}
    outputs = [hk]
    if margins:
        check(bool(torch.equal(torch.isinf(mk), torch.isinf(mp))),
              f"K1 margin inf layout differs on {where}")
        fin = torch.isfinite(mp)
        m_err = (mk - mp).abs()[fin]
        # each side's f32 sum is within D*u*sum|x_d p_d| of the exact dot, so
        # the two are within twice that, whatever their summation orders
        _, m_abs = K1.hash_dense_plain(x.abs(), proj.abs(), perm, True)
        check(bool((m_err <= 2 * d * U32 * m_abs[fin]).all()),
              f"K1 margins on {where} exceed the f32 bound: max err {float(m_err.max())}")
        out["max_margin_err"] = float(m_err.max())
        out["tolerance"] += "; margins |err| <= 2*D*2^-24*sum|x*p|, inf layout equal"
        outputs.append(mk)
    out.update({**bound(nbytes(x, proj, perm, *outputs), 2.0 * b * t * c * d, "f32"),
                **kernel_times(lambda: K1.hash_dense_kernel(x, proj, perm, margins)),
                "plain_ms": median_ms(lambda: K1.hash_dense_plain(x, proj, perm, margins))})
    return out


def window_check(args, sync, median_ms, where: str) -> dict:
    """K2b against its plain version on the operands a path gave it (any
    tier type, any number of tables; a sketch is a one-table tier): within
    the f32 bound, the same -inf slots, the same words on a second call;
    with its form, times, bound, and gathered and distinct bytes."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.kernels import build
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2

    tier, q_low, table, blk_start, start, end, live, win = args
    got = K2.coarse_window_scores_kernel(*args)
    want = K2.coarse_window_scores_plain(*args)
    sync()
    check(bool(torch.equal(torch.isneginf(got), torch.isneginf(want))),
          f"K2b masks a different set of slots than its plain version on {where}")
    fin = torch.isfinite(want)
    s_abs = K2.coarse_block_scores_plain(tier.abs(), q_low.abs(), table, blk_start, win)
    err = (got - want).abs()[fin]
    check(bool((err <= 2 * tier.shape[2] * U32 * s_abs[fin]).all()),
          f"K2b on {where} exceeds the f32 bound: max err {float(err.max())}")
    again = K2.coarse_window_scores_kernel(*args)
    check(bool(torch.equal(again.view(torch.int32), got.view(torch.int32))),
          f"K2b on {where} gives other words on a second call")
    del again
    # bytes: the distinct tier rows of valid slots, the small inputs, the scores
    l, caprows, cs = tier.shape
    lib_form = ("generic", "w64", "window_major", "w96")[
        build.library().rdf_coarse_window_form(cs, win, *blk_start.shape,
                                               int(tier.dtype == torch.bfloat16))]
    check(lib_form == K2.window_kernel_form(cs, win, *blk_start.shape,
                                            tier.dtype == torch.bfloat16),
          f"K2b's form mirror disagrees with the library on {where}: {lib_form}")
    slot_rows = (table.long().clamp(0, l - 1)[..., None] * caprows
                 + blk_start.long()[..., None] + torch.arange(win, device=tier.device))
    rows_read = int(torch.unique(slot_rows[fin]).numel())
    row_bytes = cs * tier.element_size()
    b, mb = blk_start.shape
    out = {"shape": {"B": b, "MB": mb, "win": win, "L": l,
                     "caprows": caprows, "cs": cs, "tier": str(tier.dtype)},
           "form": K2.window_kernel_form(cs, win, b, mb, tier.dtype == torch.bfloat16),
           "live_window_share": float(live.float().mean()),
           "valid_slot_share": float(fin.float().mean()),
           "max_abs_err": float(err.max()),
           "tolerance": "|err| <= 2*cs*2^-24*sum_c|tier*q| per score; -inf slots equal",
           **bound(rows_read * row_bytes + nbytes(q_low, table, blk_start, start, end, live, got),
                   2.0 * int(fin.sum()) * cs, "bf16"),
           **kernel_times(lambda: K2.coarse_window_scores_kernel(*args)),
           "plain_ms": median_ms(lambda: K2.coarse_window_scores_plain(*args))}
    out.update(gather_rates(int(fin.sum()) * row_bytes, rows_read * row_bytes, out))
    return out


def window_kernel_phase(big, xq, sync, median_ms) -> dict:
    """K2b against its plain version on the window-mode query's real blocks:
    128 queries of the 1M corpus, m_cap 65536, 64-slot windows."""
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing

    args = timing.window_operands(big, xq, WINDOW_M_CAP, QUERY_KW["probe_budget"])
    out = window_check(tuple(args), sync, median_ms, "window_1m")
    emit({"phase": "kernels_window", "K2b": out})
    return out


def window_phase(big, conf_l, ql, qids, gt, recall_block, cpu_agree, sync) -> dict:
    """The 1M forest in window mode at `scripts/bench_large.py`'s config 2
    (m_cap 65536, refine 1024, batch 128, auto 64-slot windows), without
    pruning and keeping 256 of the 1024 windows (the JAX package's measured
    keep, MB/4)."""
    import time

    import torch

    from similaritysearchbyrdf_tpu_torch import RDFForest

    conf_w = conf_l.replace(query_batch_size=128, max_candidates=WINDOW_M_CAP,
                            coarse_refine=1024, coarse_window=-1)
    wf = RDFForest(conf_w, model=big.model, device=ql.device)
    wf.state = big.state
    out = {"phase": "window_1m", "n": big.size(), "queries": ql.shape[0], "m_cap": WINDOW_M_CAP,
           "refine": 1024, "query_batch_size": 128, "window": 64,
           "block_mode_recall_at_10": recall_block, "cpu_path_agreement_20k": cpu_agree}
    reset_launches()
    results = {keep: wf.query_device(ql, query_ids=qids, window_keep=keep, **QUERY_KW)
               for keep in (0, 256)}
    sync()
    out["launches"] = read_launches()
    check(out["launches"]["coarse_window_scores_kernel"] > 0
          and out["launches"]["hash_dense_kernel"] > 0,
          f"window mode did not launch its kernels: {out['launches']}")
    for keep, (got, sc) in results.items():
        got = got.cpu().numpy()
        check(got.shape == (ql.shape[0], 10) and bool(torch.isfinite(sc).all()),
              f"window_keep {keep}: wrong shape or non-finite scores")
        rec = recall_at(gt, got)
        check(rec >= recall_block, f"window mode (keep {keep}) recall {rec} is below "
                                   f"block mode's {recall_block} on the same corpus")
        times = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            wf.query_device(ql, query_ids=qids, window_keep=keep, **QUERY_KW)
            sync()
            times.append(time.perf_counter() - t0)
        q_s = float(np.median(times[1:]))
        out[f"keep_{keep}"] = {"recall_at_10": rec, "qps": ql.shape[0] / q_s, "query_s": q_s}
    emit(out)
    return out


K1, K2, K2B, K4 = ("hash_dense_kernel", "coarse_block_scores_kernel",
                   "coarse_window_scores_kernel", "flat_groupmax_kernel")


def launch_checked(phase: str, calls: dict, name: str, fn, kernels, sync, reps: int = 0,
                   queries: int = N_QUERY, record=()):
    """One call of `fn`, with every launch count set to 0 just before it and
    read just after: each kernel in `kernels` must have launched. Records
    the counts and the call's seconds in `calls[name]` (with `reps`, also the
    median `s` of that many more calls and `queries` / `s` as qps) and
    returns what the call returned. `record` holds (module, names) pairs:
    the first call's calls of those functions, as `recording` keeps them,
    are then returned beside its result."""
    reset_launches()
    with contextlib.ExitStack() as stack:
        recorded = {}
        for module, names in record:
            recorded.update(stack.enter_context(recording(module, *names)))
        t0 = time.perf_counter()
        res = fn()
        sync()
        first_s = time.perf_counter() - t0
    launches = read_launches()
    check(all(launches[k] > 0 for k in kernels),
          f"{phase} {name}: a kernel of its path was not launched: {launches}")
    rec = {"launches": {k: launches[k] for k in (K1, K2, K4, K2B)}, "first_s": first_s}
    if reps:
        rec["s"] = timed_s(fn, sync, reps)
        rec["qps"] = queries / rec["s"]
    calls[name] = rec
    return (res, recorded) if record else res


def frontend_phase(big, conf_l, xl, xl_d, gt, sync, median_ms) -> dict:
    """The dense front ends on deploy_1m's corpus and config, queried in
    the reference probe mode (the front ends' default): `DenseRDFInit`
    (fit, vector and key queries, precision, distributions), its flat
    engine, `RDFMap`, and a model file reloaded through
    generate_method="fromfile" (K1 at P = 1). `big` is deploy_1m's forest,
    the one-shot fit the front end must equal bit for bit. K1 and K2 on the
    vector query's first call, K4 and K2b on the flat engine's, and K1 on
    the loaded model are held against their plain versions on those
    operands."""
    import tempfile

    import torch

    from similaritysearchbyrdf_tpu_torch import (DenseBatch, DenseRDFInit, RDFForest, RDFMap,
                                                 generate_model, save_model_file)
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1mod

    t_phase = time.perf_counter()
    dev = xl_d.device
    n = xl_d.shape[0]
    ids = np.arange(n, dtype=np.int32)
    batch = DenseBatch(ids, xl_d)
    q, qids = xl_d[:N_QUERY], ids[:N_QUERY]
    calls = {}
    out = {"phase": "frontend_1m", "n": n, "queries": N_QUERY, "probe_mode": "reference",
           "steps": 0, "calls": calls}

    def run(name, fn, kernels, reps=0, queries=N_QUERY, record=()):
        return launch_checked("frontend_1m", calls, name, fn, kernels, sync, reps, queries,
                              record)

    front = DenseRDFInit(device=dev)
    front.initialize_rdf_hash_map(conf_l)
    run("fit_batch", lambda: front.fit_batch(batch), [K1])
    (got, sc), rec = run("new_multi_thread_query_batch",
                         lambda: front.new_multi_thread_query_batch(qids, q), [K1, K2], reps=3,
                         record=[(H, [K1]), (F, [K2])])
    # the call hashes the queries once and scores one chunk
    check(len(rec[K1]) == 1 and len(rec[K2]) == 1,
          f"frontend_1m: {len(rec[K1])} K1 and {len(rec[K2])} K2 calls in one vector query")
    (x1, proj1, perm1), kw1 = rec[K1][0]
    args2, kw2 = rec[K2][0]
    check(not kw1 and not kw2, f"frontend_1m: unexpected K1 or K2 call: {kw1}, {kw2}")
    kernels = {"K1": hash_check(x1, proj1, perm1, False, sync, median_ms,
                                "the front end's query"),
               "K2": block_kernel_check(*args2, sync, median_ms)}
    del rec, x1, proj1, perm1, args2
    want, _ = big.query(q, query_ids=qids, steps=0)
    check(got.shape == (N_QUERY, 10) and bool(np.isfinite(sc).all()),
          "frontend_1m: wrong shape or non-finite scores")
    check(np.array_equal(got, want), "frontend_1m: the front end's ids differ from "
                                     "RDFForest(conf_l).query's")
    out["profile"] = device_profile(lambda: front.new_multi_thread_query_batch(qids, q), sync)
    # the smoke's keys with 8 unknown ones interleaved
    unknown = [n, n + 7, -1, -2**31, 2**31 - 1, 10**9, 2**40, -5]
    keys = [int(k) for k in qids]
    for j, u in enumerate(unknown):
        keys.insert(j * 126, u)
    res = run("query_batch", lambda: front.query_batch(keys), [K1, K2], reps=3)
    found = [r for k, r in zip(keys, res) if k not in unknown]
    check(all(r == [] for k, r in zip(keys, res) if k in unknown),
          "frontend_1m: an unknown key did not give []")
    check(found == [[i for i in row if i >= 0] for row in got.tolist()],
          "frontend_1m: query_batch's ids differ from the vector query's")
    gt_sets = [set(r.tolist()) for r in gt]
    p_ids, prec, p_ms = run("top_k_and_precision_score",
                            lambda: front.top_k_and_precision_score(batch, gt_sets, conf_l),
                            [K1, K2])
    recall = recall_at(gt, got)
    check(np.array_equal(p_ids, got) and abs(prec - recall) <= 1e-12,
          f"frontend_1m: precision {prec} is not the query's recall@10 {recall}")
    dt, ht = front.get_dt_and_ht_num_distribution()
    dist = front.forest.sub_index_distribution()
    check(dt.sum() == n and bool((dist.sum(axis=1) == n).all())
          and abs(ht.sum() - n) <= 1e-9 * n,
          f"frontend_1m: distributions do not sum to N: dt {dt.sum()}, "
          f"tables {dist.sum(axis=1).tolist()}")
    out.update({"recall_at_10": recall, "precision": prec, "precision_elapsed_ms": p_ms,
                "dt": dt.tolist(), "ht": ht.tolist()})
    del front

    flat = DenseRDFInit(device=dev)
    flat.initialize_rdf_hash_map(conf_l.replace(engine="flat"))
    run("flat fit_batch", lambda: flat.fit_batch(batch), [])
    (f_ids, _), f_calls = run("flat new_multi_thread_query_batch",
                              lambda: flat.new_multi_thread_query_batch(qids, q), [K4], reps=3,
                              record=[(FL, [K4, K2B])])
    out["flat_select_mode"] = FL._resolve_select_mode("auto", flat.forest.index.sketch.dtype, n,
                                                      flat.forest.index.sketch.shape[1])
    kernels["flat"] = flat_kernels(f_calls[K4][0], (f_calls[K2B] or [None])[0], sync,
                                   median_ms, "frontend_1m's flat engine", bf16=False)
    del f_calls
    out["flat_recall_at_10"] = recall_at(gt, f_ids)
    check(out["flat_recall_at_10"] >= FLAT8M_RECALL_MIN,
          f"frontend_1m: the flat engine's recall@10 {out['flat_recall_at_10']} is below "
          f"{FLAT8M_RECALL_MIN}")
    del flat

    # RDFMap: 100,000 puts, then get_similar on 100 keys against a forest
    # fitted on the same rows (the map keeps insertion order), one query each
    m = RDFMap(conf_l, device=dev)
    n_map = 100_000
    t0 = time.perf_counter()
    for i in range(n_map):
        m.put(i, xl[i])
    out["rdfmap_put_s"] = time.perf_counter() - t0
    map_keys = [int(k) for k in range(0, n_map, 1000)]
    run("rdfmap first get_similar (build)", lambda: m.get_similar(map_keys[0]), [K1, K2])
    similar = run("rdfmap get_similar x100", lambda: [m.get_similar(k) for k in map_keys],
                  [K1, K2], reps=1, queries=len(map_keys))
    fresh = RDFForest(conf_l, device=dev).fit(DenseBatch(ids[:n_map], xl_d[:n_map]))
    for k, got_k in zip(map_keys, similar):
        want_k, _ = fresh.query(xl_d[k:k + 1], query_ids=[k])
        check(got_k == [i for i in want_k[0].tolist() if i >= 0],
              f"frontend_1m: RDFMap.get_similar({k}) differs from the forest's query")
    del m, fresh

    # a model file written and reloaded: T*P tables of P = 1, through K1
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model"
        model = big.model
        save_model_file(model, path)
        loaded = generate_model(conf_l.replace(generate_method="fromfile",
                                               family_file_path=path), device=dev)
    check(tuple(loaded.perm.shape) == (model.total_tables, 1, model.chain_length),
          f"frontend_1m: the loaded model's perm is {tuple(loaded.perm.shape)}")
    h_loaded = run("K1 on the loaded model",
                   lambda: K1mod.hash_dense_kernel(q, loaded.proj, loaded.perm)[0], [K1])
    h_saved = K1mod.hash_dense_kernel(q, model.proj, model.perm)[0]
    check(bool(torch.equal(h_loaded, h_saved)),
          "frontend_1m: the reloaded model's hashes differ from the saved model's")
    kernels["K1_loaded_model"] = hash_check(q.contiguous(), loaded.proj, loaded.perm, False,
                                            sync, median_ms, "the loaded P = 1 model")
    out["kernels"] = kernels
    out["fit_s"] = calls["fit_batch"]["first_s"]
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def dynamic_phase(big, conf_l, xl_d, sync, median_ms) -> dict:
    """`DynamicForest` on deploy_1m's corpus and config: fitted on 900,000
    rows, 10 inserts of 10,000 rows (under the 0.25 threshold: no
    compaction), queried with 1,000 rows half of them inserted, 64 removals,
    the 65th compacting. Checks: the merge against one redone on the host
    from each tier's own (k + over-fetch) lists, no removed id returned,
    the card against the CPU path on 128 queries up to exact-score ties, and
    the compaction against a fresh fit on the surviving rows. K1 (the delta
    fit's first chunk and the query's hash) and K2 (the main and the delta
    tier) are held against their plain versions on the operands of the
    first merged query, the one that rebuilds the delta."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, DynamicForest, RDFForest
    from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search

    t_phase = time.perf_counter()
    dev = xl_d.device
    n = xl_d.shape[0]
    n_main = 900_000
    ids = np.arange(n, dtype=np.int32)
    qsel = np.concatenate([np.arange(N_QUERY // 2), n_main + np.arange(N_QUERY // 2)])
    q, qid = xl_d[torch.as_tensor(qsel, device=dev)], qsel.astype(np.int32)
    calls = {}
    out = {"phase": "dynamic_1m", "n": n, "fit_rows": n_main, "inserts": "10 x 10,000",
           "queries": N_QUERY, "queries_from_inserts": N_QUERY // 2, "calls": calls}

    def run(name, fn, kernels, reps=0, record=()):
        return launch_checked("dynamic_1m", calls, name, fn, kernels, sync, reps, record=record)

    def host_merge(dyn):
        """The JAX package's merge on the host: each tier's own top
        (k + over-fetch), tombstones to (-1, -inf), a stable argsort."""
        extra = dyn.overfetch()
        lists = [t.query(q, query_ids=qid, k=10 + extra) for t in (dyn.main, dyn.delta)]
        m_ids = np.concatenate([a for a, _ in lists], axis=1)
        m_sc = np.concatenate([b for _, b in lists], axis=1)
        if dyn._tombstones:
            dead = np.isin(m_ids, np.fromiter(dyn._tombstones, dtype=np.int32))
            m_sc = np.where(dead, -np.inf, m_sc)
            m_ids = np.where(dead, -1, m_ids)
        order = np.argsort(-m_sc, axis=1, kind="stable")[:, :10]
        return np.take_along_axis(m_ids, order, 1), np.take_along_axis(m_sc, order, 1)

    dyn = DynamicForest(conf_l, device=dev)
    run("fit 900k", lambda: dyn.fit(DenseBatch(ids[:n_main], xl_d[:n_main])), [K1])
    sync()
    t0 = time.perf_counter()
    for c0 in range(n_main, n, 10_000):
        dyn.add(DenseBatch(ids[c0:c0 + 10_000], xl_d[c0:c0 + 10_000]))
    sync()
    out["add_s"] = time.perf_counter() - t0
    check(dyn.delta is None and dyn.main.size() == n_main and dyn._delta_count() == n - n_main,
          "dynamic_1m: the inserts compacted under the merge threshold")
    (got, sc), rec = run("query (delta rebuild)", lambda: dyn.query(q, query_ids=qid),
                         [K1, K2], record=[(H, [K1]), (F, [K2])])
    check(dyn.delta is not None and dyn.delta.size() == n - n_main,
          "dynamic_1m: the query did not build the delta tier")
    # the delta fit hashes its rows in chunks, then each tier hashes the
    # queries and scores one chunk: main first, then delta
    n_fit = -(-(n - n_main) // conf_l.fit_batch_size)
    check(len(rec[K1]) == n_fit + 2 and len(rec[K2]) == 2,
          f"dynamic_1m: {len(rec[K1])} K1 and {len(rec[K2])} K2 calls in the "
          f"rebuilding query, not {n_fit} + 2 and 2")
    check(not any(kw for _, kw in rec[K1] + rec[K2]),
          "dynamic_1m: unexpected K1 or K2 keywords")
    out["kernels"] = {
        "K1_delta_fit": hash_check(*rec[K1][0][0], False, sync, median_ms,
                                   "the delta fit's first chunk"),
        "K1_query": hash_check(*rec[K1][-1][0], False, sync, median_ms,
                               "the merged query's hash"),
        "K2_main": block_kernel_check(*rec[K2][0][0], sync, median_ms),
        "K2_delta": block_kernel_check(*rec[K2][1][0], sync, median_ms)}
    del rec
    got, sc = run("query", lambda: dyn.query(q, query_ids=qid), [K1, K2], reps=3)
    check(got.shape == (N_QUERY, 10) and bool(np.isfinite(sc).all()),
          "dynamic_1m: wrong shape or non-finite scores")
    m_ids, m_sc = host_merge(dyn)
    check(np.array_equal(got, m_ids) and np.array_equal(sc, m_sc),
          "dynamic_1m: the device merge differs from the host merge of the tiers' lists")
    out["delta_rebuild_ms"] = (calls["query (delta rebuild)"]["first_s"]
                               - calls["query"]["s"]) * 1e3
    out["profile"] = device_profile(lambda: dyn.query(q, query_ids=qid), sync)
    # exact ground truth of the live set, the query itself excluded: 75 per
    # query cover the self row and the 64 removals below
    gt75, _ = exact_search(xl_d, q, 75, device=dev)

    def live_gt(dead) -> np.ndarray:
        return np.stack([[j for j in row if j != qid[i] and j not in dead][:10]
                         for i, row in enumerate(gt75)])

    gt = live_gt(set())
    out["recall_at_10"] = recall_at(gt, got)
    one_shot, _ = big.query(q, query_ids=qid, steps=0)
    out["one_shot_fit_recall_at_10"] = recall_at(gt, one_shot)

    # 64 removals among the returned ids, half of them inserted rows
    returned = list(dict.fromkeys(int(i) for i in got.ravel() if i >= 0))
    removed = ([i for i in returned if i < n_main][:32]
               + [i for i in returned if i >= n_main][:32])
    check(len(removed) == 64, f"dynamic_1m: only {len(removed)} ids to remove")
    for r in removed:
        dyn.remove(r)
    check(len(dyn._tombstones) == 64 and dyn.delta is not None,
          "dynamic_1m: 64 removals compacted")
    got2, sc2 = run("query after 64 removals", lambda: dyn.query(q, query_ids=qid), [K1, K2])
    check(not np.isin(got2, removed).any(), "dynamic_1m: a removed id was returned")
    m_ids, m_sc = host_merge(dyn)
    check(np.array_equal(got2, m_ids) and np.array_equal(sc2, m_sc),
          "dynamic_1m: after removals the device merge differs from the host merge")
    cpu = DynamicForest.from_states(conf_l, dyn.main.state, dyn.delta.state, dyn._tombstones,
                                    device="cpu")
    c_ids, c_sc = cpu.query(q[:128].cpu().numpy(), query_ids=qid[:128])
    del cpu
    tol = 2 * xl_d.shape[1] * U32
    check(all(equal_up_to_ties(got2[i], sc2[i], c_ids[i], c_sc[i], tol) for i in range(128)),
          "dynamic_1m: the card and the CPU path differ beyond exact-score ties")
    out["cpu_path_exact_agreement_128"] = float((c_ids == got2[:128]).all(axis=1).mean())
    out["recall_at_10_after_removals"] = recall_at(live_gt(set(removed)), got2)

    # the 65th removal compacts; the result is a fresh fit on the survivors
    victim = next(i for i in returned if i not in removed)
    removed.append(victim)
    run("remove 65th (compaction)", lambda: dyn.remove(victim), [K1])
    check(dyn.delta is None and not dyn._tombstones and dyn.main.size() == n - 65,
          "dynamic_1m: the 65th removal did not compact")
    got3, sc3 = run("query after compaction", lambda: dyn.query(q, query_ids=qid), [K1, K2])
    keep = ~np.isin(ids, removed)
    fresh = RDFForest(conf_l, model=dyn.main.model, device=dev)
    fresh.part_proj = dyn.main.part_proj
    fresh.fit(DenseBatch(ids[keep], xl_d[torch.as_tensor(keep, device=dev)]))
    want3, want_sc3 = fresh.query(q, query_ids=qid)
    check(np.array_equal(got3, want3) and np.array_equal(sc3, want_sc3),
          "dynamic_1m: after compaction the ids differ from a fresh fit's")
    del fresh, dyn
    out.update({"fit_s": calls["fit 900k"]["first_s"],
                "compaction_s": calls["remove 65th (compaction)"]["first_s"],
                "merged_qps": N_QUERY / calls["query"]["s"],
                "phase_s": time.perf_counter() - t_phase})
    emit(out)
    return out


def persist_phase(big, conf_l, xl, xl_d, gt, recall_block, sync, median_ms) -> dict:
    """Persistence on deploy_1m's corpus and config: `big` saved
    (compressed, the CLI's default) and loaded, its rebuilt coarse and head
    tiers equal to the fitted ones and its 1,000 queries bit-equal; a
    `FlatIndex()` and an `IVFFlatIndex(target_cluster=256, iters=6, seed=0,
    refine=128)` fitted on the same corpus, saved and loaded with equal
    ids (the IVF index on the first 200,000 rows, so that the phase stays
    within 90 s); a `TieredForest` over an uncompressed `GenerationStore`, the
    corpus spilled as 4 generations of 250,000 rows: its merge equal to the
    host merge of the generations' own lists, the second query reading
    nothing from disk, `get` of 100 keys. K1 and K2 on the loaded forest's
    first query, K4 and K2b on the loaded flat index's, and K2b on the
    loaded IVF index's are held against their plain versions, and the
    loaded IVF index's query is profiled; the native parser reads a dense
    text file of 10,000 rows."""
    import os
    import tempfile

    import torch

    from similaritysearchbyrdf_tpu_torch import (DenseBatch, FlatIndex, GenerationStore,
                                                 IVFFlatIndex, TieredForest, load_flat,
                                                 load_forest, load_ivf, save_flat, save_forest,
                                                 save_ivf)
    from similaritysearchbyrdf_tpu_torch import vectors as V
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.native import loader as native
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.ops import ivf as IVF
    from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
    from similaritysearchbyrdf_tpu_torch.storage.persist import forest_state_bytes

    t_phase = time.perf_counter()
    dev = xl_d.device
    n = xl_d.shape[0]
    ids = np.arange(n, dtype=np.int32)
    q, qids = xl_d[:N_QUERY], ids[:N_QUERY]
    calls = {}
    out = {"phase": "persist_1m", "n": n, "queries": N_QUERY, "calls": calls, "cuts": []}
    kernels = {}

    def run(name, fn, kernels_of_path, reps=0, record=()):
        return launch_checked("persist_1m", calls, name, fn, kernels_of_path, sync, reps,
                              record=record)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    def file_bytes(path):
        return os.path.getsize(path + ".npz") + os.path.getsize(path + ".json")

    tmp = tempfile.mkdtemp(prefix="persist_1m_")
    try:
        # ---- (a) the forest -------------------------------------------------
        want_ids, want_sc = big.query_device(q, query_ids=qids, **QUERY_KW)
        path = os.path.join(tmp, "forest")
        _, save_s = timed(lambda: save_forest(big, path))
        loaded, load_s = timed(lambda: load_forest(path, device=dev))
        st, lst = big.state, loaded.state
        tiers_equal = {"coarse_proj": bool(torch.equal(st.coarse_proj, lst.coarse_proj)),
                       "coarse_tier": bool(torch.equal(st.coarse_tier, lst.coarse_tier)),
                       "coarse_head": bool(torch.equal(st.coarse_head, lst.coarse_head))}
        check(all(tiers_equal.values()), f"persist_1m: a rebuilt tier differs: {tiers_equal}")
        (got, sc), rec = run("loaded forest query",
                             lambda: loaded.query_device(q, query_ids=qids, **QUERY_KW),
                             [K1, K2], reps=3, record=[(H, [K1]), (F, [K2])])
        check(len(rec[K1]) == 1 and len(rec[K2]) == 1,
              f"persist_1m: {len(rec[K1])} K1 and {len(rec[K2])} K2 calls in one query")
        (x1, proj1, perm1), kw1 = rec[K1][0]
        args2, kw2 = rec[K2][0]
        check(kw1 == {"emit_margins": True} and not kw2,
              f"persist_1m: unexpected K1 or K2 call: {kw1}, {kw2}")
        kernels["K1"] = hash_check(x1, proj1, perm1, True, sync, median_ms,
                                   "the loaded forest's query")
        kernels["K2"] = block_kernel_check(*args2, sync, median_ms)
        del rec, x1, proj1, perm1, args2
        check(bool(torch.equal(got, want_ids)) and bool(torch.equal(sc, want_sc)),
              "persist_1m: the loaded forest's ids or scores differ from the fitted forest's")
        recall = recall_at(gt, got.cpu().numpy())
        check(recall == recall_block,
              f"persist_1m: the loaded forest's recall@10 {recall} is not deploy_1m's "
              f"{recall_block}")
        out["forest"] = {"save_s": save_s, "load_s": load_s, "compress": True,
                         "file_bytes": file_bytes(path),
                         "file_bytes_per_vector": file_bytes(path) / n,
                         "forest_state_bytes": forest_state_bytes(lst),
                         "tiers_equal": tiers_equal, "ids_bit_equal": True,
                         "recall_at_10": recall, "deploy_1m_recall_at_10": recall_block,
                         "qps": calls["loaded forest query"]["qps"]}
        del loaded, lst, got, sc, want_ids, want_sc
        os.remove(path + ".npz")
        torch.cuda.empty_cache()

        # ---- (b) the flat engine ----------------------------------------------
        flat, fit_s = timed(lambda: FlatIndex(device=dev).fit(DenseBatch(ids, xl_d)))
        want_ids, want_sc = flat.query_device(q, k=10, query_ids=qids)
        path = os.path.join(tmp, "flat")
        _, save_s = timed(lambda: save_flat(flat, path))
        loaded, load_s = timed(lambda: load_flat(path, device=dev))
        check(bool(torch.equal(loaded.sketch, flat.sketch))
              and bool(torch.equal(loaded.corpus, flat.corpus)) and loaded.scale == flat.scale,
              "persist_1m: the loaded flat index's arrays differ")
        (got, sc), f_calls = run("loaded flat query",
                                 lambda: loaded.query_device(q, k=10, query_ids=qids), [K4],
                                 reps=3, record=[(FL, [K4, K2B])])
        kernels["flat"] = flat_kernels(f_calls[K4][0], (f_calls[K2B] or [None])[0], sync,
                                       median_ms, "the loaded flat index", bf16=False)
        del f_calls
        check(bool(torch.equal(got, want_ids)) and bool(torch.equal(sc, want_sc)),
              "persist_1m: the loaded flat index's ids differ from the fitted index's")
        out["flat"] = {"fit_s": fit_s, "save_s": save_s, "load_s": load_s,
                       "file_bytes_per_vector": file_bytes(path) / n,
                       "select_mode": FL._resolve_select_mode("auto", flat.sketch.dtype, n,
                                                              flat.sketch.shape[1]),
                       "recall_at_10": recall_at(gt, got.cpu().numpy()), "ids_bit_equal": True,
                       "qps": calls["loaded flat query"]["qps"]}
        del flat, loaded, got, sc, want_ids, want_sc
        os.remove(path + ".npz")
        torch.cuda.empty_cache()

        # ---- (c) the IVF engine, on the first 200,000 rows ---------------------
        # (at 1M rows the phase took 106 s on an NVIDIA H100 80GB HBM3
        # machine, over its 90 s budget: IVF's compressed save alone took
        # 22 s there, as the flat engine's did)
        n_ivf = min(200_000, n)
        out["cuts"].append(f"ivf on the first {n_ivf:,} of {n:,} rows")
        gt_ivf, _ = exact_search(xl_d[:n_ivf], q, 10, exclude_self=True, device=dev)
        ivf, build_s = timed(lambda: IVFFlatIndex(target_cluster=256, iters=6, seed=0,
                                                  refine=128, device=dev).fit(
            DenseBatch(ids[:n_ivf], xl_d[:n_ivf])))
        want_ids, want_sc = ivf.query_device(q, k=10, query_ids=qids)
        path = os.path.join(tmp, "ivf")
        _, save_s = timed(lambda: save_ivf(ivf, path))
        loaded, load_s = timed(lambda: load_ivf(path, device=dev))
        same = {f: bool(torch.equal(a, b)) for f, a, b in
                zip(ivf.state._fields, loaded.state, ivf.state) if a is not None}
        check(all(same.values()), f"persist_1m: the loaded IVF state differs: {same}")
        (got, sc), i_calls = run("loaded ivf query",
                                 lambda: loaded.query_device(q, k=10, query_ids=qids), [K2B],
                                 reps=3, record=[(IVF, [K2B])])
        args, kw = i_calls[K2B][0]
        check(not kw, f"persist_1m: unexpected K2b call on the IVF path: {kw}")
        kernels["K2b_ivf"] = window_check(args, sync, median_ms, "the loaded IVF index")
        del i_calls, args
        check(bool(torch.equal(got, want_ids)) and bool(torch.equal(sc, want_sc)),
              "persist_1m: the loaded IVF index's ids differ from the built index's")
        out["ivf"] = {"rows": n_ivf, "k_clusters": ivf.state.centroids.shape[0],
                      "nprobe": ivf.nprobe, "win": ivf.win, "build_s": build_s,
                      "save_s": save_s, "load_s": load_s,
                      "file_bytes_per_vector": file_bytes(path) / n_ivf,
                      "recall_at_10": recall_at(gt_ivf, got.cpu().numpy()),
                      "ids_bit_equal": True,
                      "qps": calls["loaded ivf query"]["qps"],
                      "profile": device_profile(
                          lambda: loaded.query_device(q, k=10, query_ids=qids), sync)}
        del ivf, loaded, got, sc, want_ids, want_sc
        os.remove(path + ".npz")
        torch.cuda.empty_cache()

        # ---- (d) the tiered store ---------------------------------------------
        store = GenerationStore(tmp, "tiered", compress=False, device=dev)
        tiered = TieredForest(conf_l, store)
        spill_s, per_gen = [], n // 4
        for c0 in range(0, n, per_gen):
            tiered.fit(DenseBatch(ids[c0:c0 + per_gen], xl_d[c0:c0 + per_gen]))
            spill_s.append(timed(tiered.spill)[1])
        stems = store.generations()
        check(len(stems) == 4, f"persist_1m: {len(stems)} generations, not 4")
        q_np = xl[:N_QUERY]
        got, sc = run("tiered query (loads)", lambda: tiered.query(q_np, query_ids=qids),
                      [K1, K2])
        loads_first = store.disk_loads
        got2, sc2 = run("tiered query (resident)", lambda: tiered.query(q_np, query_ids=qids),
                        [K1, K2], reps=3)
        loads_second = store.disk_loads
        check(loads_first == 4 and loads_second == loads_first,
              f"persist_1m: disk loads {loads_first} then {loads_second}, not 4 then 4")
        check(np.array_equal(got, got2) and np.array_equal(sc, sc2),
              "persist_1m: the resident query differs from the first")
        # the JAX package's merge on the host: each generation's own top-10,
        # a stable descending order of the concatenated lists, -1 where not finite
        lists = [store.load_generation(s).query(q_np, query_ids=qids, k=10) for s in stems]
        cat_i = np.concatenate([a for a, _ in lists], axis=1)
        cat_s = np.concatenate([b for _, b in lists], axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :10]
        m_sc = np.take_along_axis(cat_s, order, 1)
        m_ids = np.where(np.isfinite(m_sc), np.take_along_axis(cat_i, order, 1), -1)
        check(np.array_equal(got, m_ids) and np.array_equal(sc, m_sc),
              "persist_1m: the tiered merge differs from the host merge of the generations")
        check(got.shape == (N_QUERY, 10) and bool(np.isfinite(sc).all()),
              "persist_1m: tiered output has the wrong shape or non-finite scores")
        keys = [int(k) for k in np.linspace(0, n - 1, 100).astype(np.int64)]
        rows, get_s = timed(lambda: [tiered.get(k) for k in keys])
        check(all(r is not None and np.array_equal(r, xl[k]) for k, r in zip(keys, rows)),
              "persist_1m: get did not return the stored rows")
        out["tiered"] = {"generations": len(stems), "rows_per_generation": per_gen,
                         "compress": False, "spill_s": spill_s,
                         "generation_bytes_per_vector": sum(file_bytes(s) for s in stems) / n,
                         "gated": len(store._cache), "loaded": loads_first,
                         "disk_loads_after_first_query": loads_first,
                         "disk_loads_after_second_query": loads_second,
                         "probe_mode": "reference", "recall_at_10": recall_at(gt, got),
                         "deploy_1m_recall_at_10": recall_block,
                         "merged_qps": calls["tiered query (resident)"]["qps"],
                         "merge_equals_host_merge": True, "get_100_keys_s": get_s}
        del tiered, store, lists

        # ---- the native parser --------------------------------------------------
        path = os.path.join(tmp, "dense.txt")
        with open(path, "w") as f:
            f.write("\n".join(f"[{i},[{','.join(repr(float(v)) for v in xl[i])}]]"
                              for i in range(10_000)))
        _, build_s = timed(native.library)
        before = native.CALLS
        batch, parse_s = timed(lambda: V.load_dense_file(path))
        used = native.CALLS == before + 1
        py, py_s = timed(lambda: V.load_dense_file(path, use_native=False))
        check(native.built and used, f"persist_1m: the native parser was not built and used: "
                                     f"{native.last_build_log}")
        check(np.array_equal(batch.ids, py.ids) and np.array_equal(batch.values, py.values),
              "persist_1m: the native parser's rows differ from the Python parser's")
        out["native"] = {"built": native.built, "used": used, "build_s": native.build_s,
                         "first_call_s": build_s,
                         "library": str(native.library_path().relative_to(
                             native.BUILD_ROOT.parent.parent)),
                         "rows": 10_000, "parse_s": parse_s, "python_parse_s": py_s}
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["kernels"] = kernels
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def options_phase(conf, x_d, gt, recall_block, recall_window, sync, median_ms) -> dict:
    """The forest's last three options on the 1M corpus: the bench config
    plus a bf16 coarse tier on a PCA basis and the bf16 two-stage rerank,
    fitted once and queried in block mode at deploy_1m's settings (K2 on
    the bf16 tier) and in window mode at window_1m's (m_cap 65536, refine
    1024, batch 128, unpruned; K2b on it). Each mode's recall must come
    within RECALL_TOL of the int8 fit's in that mode, and the port's CPU
    path must return the same ids on >= 99% of 128 queries on the same
    index (copied to the host). K2 and K2b are held against their plain
    versions on the operands of each mode's first kernel call."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFForest
    from similaritysearchbyrdf_tpu_torch.index import forest as F

    dev = x_d.device
    n = x_d.shape[0]
    ids = np.arange(n, dtype=np.int32)
    conf_o = conf.replace(coarse_dtype="bfloat16", coarse_proj_mode="pca",
                          rerank_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    forest = RDFForest(conf_o, device=dev).fit(DenseBatch(ids, x_d))
    fit_s = timed_s(lambda: forest.fit(DenseBatch(ids, x_d)), sync, 1)
    st = forest.state
    check(st.coarse_tier.dtype == torch.bfloat16 and st.corpus_lp is not None,
          "the options fit made no bf16 tier or no bf16 corpus copy")
    wf = RDFForest(conf_o.replace(query_batch_size=128, max_candidates=WINDOW_M_CAP,
                                  coarse_refine=1024, coarse_window=-1),
                   model=forest.model, device=dev)
    wf.state = st
    cpu_state = st.to("cpu")
    q, qids = x_d[:N_QUERY], ids[:N_QUERY]
    out = {"phase": "options_1m", "n": n, "queries": N_QUERY,
           "config": {"coarse_dtype": "bfloat16", "coarse_proj_mode": "pca",
                      "rerank_dtype": "bfloat16", "coarse_dim": conf.coarse_dim},
           "build_vectors_per_sec": n / fit_s, "build_s": fit_s,
           "index_bytes_per_vector": forest.index_bytes_per_vector(),
           "coarse_tier_bytes_per_vector": nbytes(st.coarse_tier) / n,
           "corpus_lp_bytes_per_vector": nbytes(st.corpus_lp) / n}
    for mode, f, ref, kernel in (
            ("block", forest, recall_block, "coarse_block_scores_kernel"),
            ("window", wf, recall_window, "coarse_window_scores_kernel")):
        f.query_device(q, query_ids=qids, **QUERY_KW)
        with recording(F, kernel) as calls:
            reset_launches()
            got, sc = f.query_device(q, query_ids=qids, **QUERY_KW)
            sync()
            launches = read_launches()
        check(launches[kernel] > 0 and launches["hash_dense_kernel"] > 0,
              f"options_1m {mode} mode did not launch {kernel}: {launches}")
        # the kernel against its plain version on the first call's operands
        args, kw = calls[kernel][0]
        check(not kw and args[0].dtype == torch.bfloat16,
              f"options_1m {mode}: unexpected {kernel} call: {kw}, tier {args[0].dtype}")
        del calls
        if mode == "block":
            k_check = {"K2": block_kernel_check(*args, sync, median_ms)}
        else:
            k_check = {"K2b": window_check(args, sync, median_ms, "options_1m window")}
        del args
        got = got.cpu().numpy()
        check(got.shape == (N_QUERY, 10) and bool(torch.isfinite(sc).all()),
              f"options_1m {mode}: wrong shape or non-finite scores")
        rec = recall_at(gt, got)
        check(rec >= ref - RECALL_TOL, f"options_1m {mode} mode: recall@10 {rec} is more than "
                                       f"{RECALL_TOL} below the int8 fit's {ref}")
        cpu = RDFForest(f.conf, model=cpu_state.model, device="cpu")
        cpu.state = cpu_state
        cpu_ids, _ = cpu.query(q[:128].cpu().numpy(), query_ids=qids[:128], **QUERY_KW)
        agree = float((cpu_ids == got[:128]).all(axis=1).mean())
        check(agree >= 0.99, f"options_1m {mode}: GPU and CPU paths agree on only {agree}")
        q_s = timed_s(lambda: f.query_device(q, query_ids=qids, **QUERY_KW), sync, 3)
        out[mode] = {"recall_at_10": rec, "int8_fit_recall_at_10": ref,
                     "cpu_path_agreement_128": agree, "qps": N_QUERY / q_s, "query_s": q_s,
                     "launches": {k: v for k, v in launches.items() if v}, **k_check,
                     "profile": device_profile(
                         lambda: f.query_device(q, query_ids=qids, **QUERY_KW), sync)}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    emit(out)
    return out


def ivf_phase(xd, gt, sync, median_ms) -> dict:
    """The IVF engine on the Deep-8M corpus (`scripts/bench_ivf.py`'s build:
    target_cluster 256, iters 6, seed 0, refine 128; K = 31,250), built
    twice from one seed (equal layouts required, the first build freed
    before the second), k-means timed apart inside each build, then three
    query points on the second index, K2b checked on each point's own
    operands."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, IVFFlatIndex
    from similaritysearchbyrdf_tpu_torch.ops import ivf as IVF

    dev = xd.device
    n, d = xd.shape
    nq = 1024
    ids = np.arange(n, dtype=np.int32)
    kmeans_s = []
    kmeans = IVF.kmeans

    def timed_kmeans(*args, **kw):
        sync()
        t0 = time.perf_counter()
        res = kmeans(*args, **kw)
        sync()
        kmeans_s.append(time.perf_counter() - t0)
        return res

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    build_s, layouts = [], []
    IVF.kmeans = timed_kmeans
    try:
        for _ in range(2):
            layouts.clear()
            idx = IVFFlatIndex(target_cluster=256, iters=6, seed=0, refine=128, device=dev)
            sync()
            t0 = time.perf_counter()
            idx.fit(DenseBatch(ids, xd))
            sync()
            build_s.append(time.perf_counter() - t0)
            layouts.append({f: getattr(idx.state, f).clone()
                            for f in ("starts", "ends", "row_ids", "centroids")})
            if len(build_s) == 1:
                first = layouts[0]
                del idx
                torch.cuda.empty_cache()
    finally:
        IVF.kmeans = kmeans
    same = {f: bool(torch.equal(first[f], layouts[0][f])) for f in first}
    check(all(same.values()), f"two IVF builds from one seed lay out differently: {same}")
    del first, layouts
    build_peak = torch.cuda.max_memory_allocated(dev)
    st = idx.state
    kc = st.centroids.shape[0]
    out = {"phase": "ivf_8m", "n": n, "dim": d, "queries": nq, "k_clusters": kc,
           "config": {"target_cluster": 256, "iters": 6, "seed": 0, "refine": 128,
                      "query_batch": 1024},
           "build_s": build_s, "kmeans_s": kmeans_s, "same_layout_twice": same,
           "build_vectors_per_sec": n / build_s[-1],
           "bytes_per_vector": {f: nbytes(getattr(st, f)) / n
                                for f in ("sketch", "corpus", "row_ids", "centroids")},
           "build_max_memory_allocated": build_peak, "points": {}}
    qd, qids = xd[:nq], ids[:nq]
    points = (("headline", dict(nprobe=2, win=128), 1.0),
              ("smallest_probe", dict(nprobe=1, win=64), 0.9998),
              ("two_phase", dict(nprobe=8, win=64, head_pool=64, keep=64), None))
    torch.cuda.reset_peak_memory_stats(dev)
    for name, p, tpu_recall in points:
        idx.nprobe, idx.win = p["nprobe"], p["win"]
        idx.head_pool, idx.keep = p.get("head_pool", 0), p.get("keep", 0)
        idx.state = idx.state._replace(heads=None)
        idx.ensure_heads()
        wb = IVF.ivf_window_budget(st.starts, st.ends, idx.nprobe, idx.win)
        idx.query_device(qd, k=10, query_ids=qids)
        with recording(IVF, "coarse_window_scores_kernel", "top_sorted") as calls:
            reset_launches()
            got, sc = idx.query_device(qd, k=10, query_ids=qids)
            sync()
            launches, forms = read_launches(), read_forms()
        check(launches["coarse_window_scores_kernel"] > 0,
              f"ivf_8m {name} did not launch K2b: {launches}")
        check(launches["topk_select_f32"] > 0,
              f"ivf_8m {name} did not launch the top-k select's f32 form: {launches}")
        if name == "headline":
            out["TK_f32"] = topk_f32_check(calls["top_sorted"], sync, median_ms)
        got = got.cpu().numpy()
        check(got.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
              f"ivf_8m {name}: wrong shape or non-finite scores")
        rec = recall_at(gt, got)
        if name == "headline":
            check(rec >= FLAT8M_RECALL_MIN,
                  f"ivf_8m headline recall@10 {rec} is below {FLAT8M_RECALL_MIN}")
        q_s = timed_s(lambda: idx.query_device(qd, k=10, query_ids=qids), sync, 3)
        args, kw = calls["coarse_window_scores_kernel"][0]
        check(not kw, f"unexpected K2b call on the IVF path: {kw}")
        out["points"][name] = {
            **p, "wb": wb, "recall_at_10": rec, "tpu_v5e_recall_at_10": tpu_recall,
            "qps": nq / q_s, "query_s": q_s,
            "launches": {k: v for k, v in launches.items() if v}, "topk_forms": forms,
            "profile": device_profile(lambda: idx.query_device(qd, k=10, query_ids=qids), sync),
            "K2b": window_check(args, sync, median_ms, f"ivf_8m {name}")}
        del calls, args
    out["query_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    emit(out)
    return out


def folded_conf():
    """`scripts/bench_deep8m_coarse.py`'s operating point of the folded tier
    at Deep-8M (96 dims, batch 64)."""
    from similaritysearchbyrdf_tpu_torch import RDFConfig, TableConfig

    return RDFConfig(
        vector_dim=96, table_num=10, permutation_num=3, family_size=100, partition_bits=3,
        lsh_table=TableConfig(chain_length=32, bucket_overflow=2000), query_batch_size=64,
        max_candidates=524288, top_k=10, coarse_dim=16, coarse_dtype="int8",
        coarse_refine=12288, coarse_layout="folded", coarse_group=64, coarse_rows_keep=0,
        coarse_window=4096)


def folded_phase(dev, sync, median_ms):
    """The Deep-8M operating point of the folded tier: fit, K3 and the top-k
    select against their plain versions at the query's real shapes, then
    1,024 self-excluded queries. → (K3's and the top-k select's checks and
    timings, launch counts of the query, the corpus, its ground truth)."""
    import time

    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFForest
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3

    n, d, nq, qb = 8_000_000, 96, 1024, 64
    steps, budget, refine, win, m_cap, gsl = 1, 16, 12288, 4096, 524288, 64
    conf = folded_conf()
    t0 = time.perf_counter()
    x = deep_corpus(n, d)
    gen_s = time.perf_counter() - t0
    ids = np.arange(n, dtype=np.int32)
    xd = torch.as_tensor(x, device=dev)
    gt, _ = exact_search(xd, x[:nq], 10, exclude_self=True, device=dev)
    del x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    forest = RDFForest(conf, device=dev).fit(DenseBatch(ids, xd))
    sync()
    t0 = time.perf_counter()
    forest.fit(DenseBatch(ids, xd))
    sync()
    fit_s = time.perf_counter() - t0
    st = forest.state

    # K3 against its plain version on the query's real windows
    q = xd[:qb].contiguous()
    h, margins = F.hash_dense_with_margins(st.model, q)
    probes, pvalid = F._probe_hashes_margin(h, margins, forest.layout, budget)
    home = F.partition_of_hash(h, st.part_proj)
    folded = st.coarse_folded
    _, capf, lanes = folded.shape
    fold = lanes // st.coarse_proj.shape[1]
    base, table, start, end, _, _ = F.gather_blocks(
        st.tables, h, home, forest.layout, steps, m_cap, True, probes, pvalid, window=win,
        align=max(gsl, 8 * fold))
    blk = torch.clamp(base + torch.arange(base.shape[1], device=dev) * win, 0,
                      capf * fold - win)
    live = (blk < end) & (blk + win > start)
    rs = torch.where(live, blk // fold, -1).to(torch.int32).contiguous()
    table = table.to(torch.int32).contiguous()
    qi8 = F.query_int8(q, st.coarse_proj)
    wpr, rpg, mshift = win // fold, gsl // fold, gsl.bit_length() - 1
    mismatched, max_err = {}, 0
    for emit2 in (False, True):
        got = K3.coarse_rowmax_kernel(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
        want = K3.coarse_rowmax_plain(folded, qi8, table, rs, wpr, rpg, mshift, emit2)
        pairs = list(zip(got, want)) if emit2 else [(got, want)]
        mismatched[f"emit2_{emit2}"] = sum(int((g != w).sum()) for g, w in pairs)
        max_err = max([max_err] + [int((g.long() - w.long()).abs().max()) for g, w in pairs])
    sync()
    check(not any(mismatched.values()), f"K3 differs from its plain version: {mismatched}")
    # bytes: the distinct folded rows of live windows, the small inputs, both outputs
    l_rows = (table.long().clamp(0, folded.shape[0] - 1)[..., None] * capf
              + rs.long().clamp(0, capf - wpr)[..., None] + torch.arange(wpr, device=dev))
    rows_read = int(torch.unique(l_rows[live]).numel())
    gathered = int(live.sum()) * wpr * lanes           # what the kernel streams in
    k3_out = qb * base.shape[1] * wpr * 4               # one output; emit2 writes two
    k3_in = rows_read * lanes + nbytes(qi8, table, rs)
    k3_bound = bound(k3_in + k3_out, 2 * gathered, "int8")
    k3 = {"shape": {"B": qb, "MB": base.shape[1], "wpr": wpr, "fold": fold, "rpg": rpg,
                    "mshift": mshift, "L": folded.shape[0], "capf": capf, "lanes": lanes},
          "live_window_share": float(live.float().mean()),
          "mismatched_words": mismatched, "max_abs_err": float(max_err),
          "tolerance": "bit for bit (0 mismatched words)", **k3_bound,
          "bound_ms_emit2": bound(k3_in + 2 * k3_out, 2 * gathered, "int8")["bound_ms"],
          "gathered_bytes": gathered, "distinct_bytes": rows_read * lanes}
    for emit2 in (False, True):
        sfx = "_emit2" if emit2 else ""
        t = kernel_times(lambda: K3.coarse_rowmax_kernel(
            folded, qi8, table, rs, wpr, rpg, mshift, emit2))
        k3["ms" + sfx], k3["device_ms" + sfx] = t["ms"], t["device_ms"]
        k3["plain_ms" + sfx] = median_ms(lambda: K3.coarse_rowmax_plain(
            folded, qi8, table, rs, wpr, rpg, mshift, emit2))
        # achieved rates over the kernel's time, GB/s
        k3["gathered_gb_per_s" + sfx] = gathered / k3["ms" + sfx] / 1e6
        k3["distinct_gb_per_s" + sfx] = rows_read * lanes / k3["ms" + sfx] / 1e6
    tk = topk_check(st, q, forest.layout, dict(
        steps=steps, probe_mode="margin", probe_budget=budget, m_cap=m_cap, k=10,
        coarse_refine=refine, coarse_window=win, coarse_group=gsl, rows_keep=0), sync,
        median_ms)
    emit({"phase": "kernels_folded", "K3": k3, "TK": tk})

    qkw = dict(steps=steps, probe_mode="margin", probe_budget=budget)
    qd, qids = xd[:nq], ids[:nq]
    reset_launches()
    got, sc = forest.query_device(qd, query_ids=qids, **qkw)
    sync()
    launches, forms = read_launches(), read_forms()
    check(launches["coarse_rowmax_kernel"] > 0 and launches["hash_dense_kernel"] > 0
          and launches["topk_select"] > 0,
          f"the folded path did not launch its kernels: {launches}")
    got = got.cpu().numpy()
    check(got.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
          "folded query output has the wrong shape or non-finite scores")
    rec = recall_at(gt, got)
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        forest.query_device(qd, query_ids=qids, **qkw)
        sync()
        times.append(time.perf_counter() - t0)
    q_s = float(np.median(times))
    emit({"phase": "folded_8m", "n": n, "dim": d, "queries": nq, "corpus_gen_s": gen_s,
          "config": {"bucket_overflow": 2000, "coarse_dim": 16, "coarse_group": gsl,
                     "rows_keep": 0, "window": win, "m_cap": m_cap, "refine": refine,
                     "steps": steps, "probe_budget": budget, "query_batch_size": qb},
          "recall_at_10": rec, "tpu_v5e_recall_at_10": TPU_DEEP8M_RECALL,
          "recall_gap": rec - TPU_DEEP8M_RECALL, "launches": launches, "topk_forms": forms,
          "qps": nq / q_s, "query_s": q_s, "build_vectors_per_sec": n / fit_s,
          "build_s": fit_s, "index_bytes_per_vector": forest.index_bytes_per_vector(),
          "coarse_tier_bytes_per_vector": st.coarse_tier.numel() / n,
          "corpus_bytes": st.corpus.numel() * 4, "coarse_tier_bytes": st.coarse_tier.numel(),
          "table_bytes": st.tables.index_bytes(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    return k3, tk, launches, xd, gt


def topk_check(st, q, layout, qkw: dict, sync, median_ms) -> dict:
    """The top-k select (`topk_select`) on one real chunk's operands: the
    group select's values at this operating point, and stage2's keys of the
    same chunk with the benchmark's folded cell's stage2 (4,096 kept), each
    taken from the forest's own call. Each held bit for bit against its
    plain version on the card (the int64 pack and `torch.sort`'s prefix),
    timed, beside `torch.topk` (`library_ms`, device time) and the bound of
    one read of the row and one write of the kept keys."""
    import torch

    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as TK

    seen = {}
    real_packed, real_select = F.topk_packed_select, F.topk_select

    def packed(values, k, sh, bits_w):
        seen.setdefault("group_select", (values.clone(), k, sh, bits_w))
        return real_packed(values, k, sh, bits_w)

    def select(keys, k, descending):
        seen.setdefault("stage2", (keys.clone(), k, descending))
        return real_select(keys, k, descending)

    qids = torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device)
    F.topk_packed_select, F.topk_select = packed, select
    try:
        o = F.QueryOptions(**qkw, stage2=4096)
        F._query_chunk(st, q, qids, layout, o, F._coarse_plan(st, o), None)
    finally:
        F.topk_packed_select, F.topk_select = real_packed, real_select
    sync()
    check(set(seen) == {"group_select", "stage2"},
          f"the folded chunk did not reach both top-k selects: {sorted(seen)}")
    values, k, sh, bits_w = seen["group_select"]
    keys, keep, descending = seen["stage2"]
    pack = TK.pack_keys_plain(values, sh, bits_w)
    calls = {
        "group_select": (lambda: TK.topk_packed_select(values, k, sh, bits_w),
                         lambda: TK.topk_select_plain(TK.pack_keys_plain(values, sh, bits_w),
                                                      k, True),
                         lambda: torch.topk(pack, k, dim=1, largest=True, sorted=True).values,
                         values, k),
        "stage2": (lambda: TK.topk_select(keys, keep, descending),
                   lambda: TK.topk_select_plain(keys, keep, descending),
                   lambda: torch.topk(keys, keep, dim=1, largest=descending,
                                      sorted=True).values,
                   keys, keep)}
    out = {}
    for name, (kern, plain, lib, rows, kept) in calls.items():
        got, want, by_lib = kern(), plain(), lib()
        sync()
        bad = int((got != want).sum()) if got.shape == want.shape else got.numel()
        check(bad == 0, f"TK {name} differs from its plain version: {bad} words")
        check(torch.equal(by_lib, want), f"torch.topk differs from the sort's prefix at {name}")
        out_bytes = rows.shape[0] * min(kept, rows.shape[1]) * rows.element_size()
        t = kernel_times(kern)
        out[name] = {"shape": {"B": rows.shape[0], "n": rows.shape[1], "k": kept,
                               "dtype": str(rows.dtype).replace("torch.", ""),
                               "form": TK._form(rows.device.index, rows.shape[1],
                                                min(kept, rows.shape[1]),
                                                rows.element_size())},
                     "mismatched_words": bad, "max_abs_err": 0.0,
                     "tolerance": "bit for bit (0 mismatched words)",
                     **bound(nbytes(rows) + out_bytes, 0, "int8"),
                     "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": median_ms(plain),
                     "library_ms": timing_device_ms(lib)}
    return out


TK_F32_KEYS = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def topk_f32_check(selects, sync, median_ms) -> dict:
    """The top-k select's f32 form (`ops/rerank.top_sorted` on the card) on
    an IVF query's own operands, as the index's call passed them: its
    centroid scores (nprobe of K a query) and its window scores (refine of
    wb x win a query). Each held bit for bit against the card's stable
    descending sort's prefix (the values' bits and the indices), timed
    beside it (`plain_ms`), beside `torch.topk` (`library_ms`, device time;
    it may order ties otherwise) and the bound of one read of the row and
    one write of the kept values and indices."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select as TK

    check(len(selects) >= 2, f"the IVF query made {len(selects)} selects, not 2")
    out = {}
    for name, (args, kw) in zip(("centroids", "windows"), selects[:2]):
        check(not kw and len(args) == 2, f"unexpected top_sorted call on the IVF path: {kw}")
        scores, m = args
        b, n = scores.shape
        kout = min(m, n)

        def kern():
            return TK.topk_select_f32(scores, m)

        def plain():
            return TK.topk_select_f32_plain(scores, m)

        def lib():
            return torch.topk(scores, m, dim=1, largest=True, sorted=True)

        (got_s, got_i), (want_s, want_i) = kern(), plain()
        sync()
        bad = (int((got_s.view(torch.int32) != want_s.view(torch.int32)).sum())
               + int((got_i != want_i).sum())) if got_s.shape == want_s.shape else got_s.numel()
        check(bad == 0, f"TK f32 at the IVF {name} select differs from the stable sort's "
                        f"prefix: {bad} words")
        t = kernel_times(kern)
        out[name] = {"shape": {"B": b, "n": n, "k": m, "dtype": "float32",
                               "form": TK._f32_form(scores.device.index, n, kout)},
                     "mismatched_words": bad, "max_abs_err": 0.0,
                     "tolerance": "bit for bit (0 mismatched words)",
                     **bound(nbytes(scores) + b * kout * (4 + 8), 0, "int8"),
                     "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": median_ms(plain),
                     "library_ms": timing_device_ms(lib)}
    return out


def timing_device_ms(fn) -> float:
    """Device time of one call of `fn` (`timing.median_event_ms` with the
    card held busy first), over 20 calls."""
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing

    return timing.median_event_ms(fn, 20, busy=True)


def device_profile(fn, sync, reps: int = 3, wall_reps: int = 5) -> dict:
    """torch.profiler over `reps` calls of `fn`: CUDA-kernel time and count
    per call (kernel events only, so no operator is counted twice), the
    largest kernels, and the idle share 1 - kernel time / unprofiled wall
    time of the same call (median of `wall_reps`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = timed_s(fn, sync, wall_reps) * 1e3
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / reps, e.count / reps)
           for e in kern]
    total = sum(ms for _, ms, _ in per)
    if total <= 0:
        return {"wall_ms": wall_ms, "kernel_ms": "not measured"}
    top = sorted(per, key=lambda t: -t[1])[:8]
    return {"wall_ms": wall_ms, "kernel_ms": total,
            "kernels_per_call": sum(c for *_, c in per), "idle_share": 1 - total / wall_ms,
            "top_kernels_ms": [[k[:80], ms, c] for k, ms, c in top]}


@contextlib.contextmanager
def recording(module, *names, limit=None):
    """Within the block, calls of `module.<name>` for each name also keep
    their arguments: {name: [(args, kwargs), ...]}, the first `limit` calls
    of each (all without one: a fit's hundred chunks would all be held).
    The kernels' own launch counts are untouched."""
    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def keep(name):
        def call(*args, **kw):
            if limit is None or len(calls[name]) < limit:
                calls[name].append((args, kw))
            return saved[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, keep(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, saved[name])


def flat_kernels(k4_call, k2b_call, sync, median_ms, where: str, bf16: bool = True) -> dict:
    """K4 and K2b against their plain versions on the operands a grouped
    flat query gave them (each call as `recording` keeps it): K4 int8
    unpacked (bit for bit); with `bf16`, K4 in bf16 on bf16 copies of the
    same int8 operands (within the f32 bound, and equal to the int8 result,
    as every sum of those products is an integer below 2^24); and K2b, when
    the select called it, on the int8 sketch as a one-table tier (within
    the f32 bound, the same -inf slots)."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4

    (sk, q8, group), kw4 = k4_call
    check(not kw4 and sk.dtype == torch.int8, f"unexpected K4 call on {where}: {kw4}")
    npad, dk = sk.shape
    b = q8.shape[0]
    got = K4.flat_groupmax_kernel(sk, q8, group)
    want = K4.flat_groupmax_plain(sk, q8, group)
    sync()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(bad == 0, f"K4 int8 on {where}'s operands differs in {bad} words")
    out = {"K4_int8": {"shape": {"B": b, "Npad": npad, "D": dk, "group": group},
                       "form": K4.kernel_form(sk.dtype, dk), "mismatched_words": bad,
                       "max_abs_err": float((got - want).abs().max()),
                       **bound(nbytes(sk, q8, got), 2.0 * b * npad * dk, "int8"),
                       **kernel_times(lambda: K4.flat_groupmax_kernel(sk, q8, group)),
                       "plain_ms": median_ms(lambda: K4.flat_groupmax_plain(sk, q8, group))}}
    if bf16:
        s16, q16 = sk.to(torch.bfloat16), q8.to(torch.bfloat16)
        got16 = K4.flat_groupmax_kernel(s16, q16, group)
        want16 = K4.flat_groupmax_plain(s16, q16, group)
        lim = 2 * dk * U32 * K4.flat_groupmax_plain(s16.abs(), q16.abs(), group)
        sync()
        err = (got16 - want16).abs()
        check(bool((err <= lim).all()),
              f"K4 bf16 exceeds the f32 bound: max err {float(err.max())}")
        vs_int8 = int((got16.view(torch.int32) != got.view(torch.int32)).sum())
        check(vs_int8 == 0, f"K4 bf16 on int8 values differs from K4 int8 in {vs_int8} words")
        out["K4_bf16"] = {"form": K4.kernel_form(s16.dtype, dk), "max_abs_err": float(err.max()),
                          "words_unequal_to_int8": vs_int8,
                          **bound(nbytes(s16, q16, got16), 2.0 * b * npad * dk, "bf16"),
                          **kernel_times(lambda: K4.flat_groupmax_kernel(s16, q16, group)),
                          "plain_ms": median_ms(lambda: K4.flat_groupmax_plain(s16, q16, group))}
        del got16, want16, lim, err
    del got, want

    if k2b_call is not None:
        args, kw2 = k2b_call
        check(not kw2, f"unexpected K2b call on {where}: {kw2}")
        out["K2b"] = window_check(args, sync, median_ms, where)
    out["tolerance"] = ("K4 int8: bit for bit; K4 bf16 and K2b: |err| <= "
                        "2*D*2^-24*sum|s*q| per value, K2b's -inf slots equal")
    return out


def flat_20k_phase(x, gt, dev, sync, median_ms) -> dict:
    """`bench.py`'s flat leg (`flat_topk`, refine 128, 1,000 self-excluded
    queries padded to 1,024) and `FlatIndex()` in grouped mode (exact2 at
    20k rows: K4 unpacked, then K2b) on the bench corpus; K4 and K2b are
    checked on the grouped leg's own operands."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, FlatIndex, flat_topk
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL

    n = x.shape[0]
    ids = np.arange(n, dtype=np.int32)
    xd = torch.as_tensor(x, device=dev)
    pad = (-N_QUERY) % 1024
    qf = torch.as_tensor(np.pad(x[:N_QUERY], ((0, pad), (0, 0))), device=dev)
    qfi = torch.as_tensor(np.pad(ids[:N_QUERY], (0, pad), constant_values=-1), device=dev)
    rid = torch.as_tensor(ids, device=dev)
    sketch, _ = FL.build_flat_sketch(xd, "int8")
    out = {"phase": "flat_20k", "n": n, "queries": N_QUERY, "batch": 1024, "refine": 128}

    def scan():
        return flat_topk(sketch, xd, rid, qf, qfi, 10, refine=128)

    flat = FlatIndex(device=dev).fit(DenseBatch(ids, xd))

    def grouped():
        return flat.query_device(x[:N_QUERY], k=10, query_ids=ids[:N_QUERY])

    cpu_kw = {"scan": dict(mode="scan"), "grouped": {}}
    for name, fn, want in (("scan", scan, JAX_CPU_FLAT_RECALL),
                           ("grouped", grouped, JAX_CPU_FLAT_GROUPED_RECALL)):
        with recording(FL, "flat_groupmax_kernel", "coarse_window_scores_kernel") as calls:
            reset_launches()
            got, sc = fn()
            sync()
            launches = read_launches()
        got = got[:N_QUERY].cpu().numpy()
        check(got.shape == (N_QUERY, 10) and bool(torch.isfinite(sc[:N_QUERY]).all()),
              f"flat_20k {name}: wrong shape or non-finite scores")
        rec = recall_at(gt, got)
        check(abs(rec - want) <= RECALL_TOL, f"flat_20k {name}: recall@10 {rec} is not within "
                                             f"{RECALL_TOL} of the JAX package's {want}")
        if name == "grouped":
            check(launches["flat_groupmax_kernel"] > 0
                  and launches["coarse_window_scores_kernel"] > 0,
                  f"grouped flat did not launch K4 and K2b: {launches}")
            check(len(calls["flat_groupmax_kernel"]) == 1
                  and len(calls["coarse_window_scores_kernel"]) == 1,
                  f"grouped flat made {len(calls['flat_groupmax_kernel'])} K4 and "
                  f"{len(calls['coarse_window_scores_kernel'])} K2b calls, not one each")
            kernels = flat_kernels(calls["flat_groupmax_kernel"][0],
                                   calls["coarse_window_scores_kernel"][0], sync, median_ms,
                                   "flat_20k")
        cpu = FlatIndex(device="cpu", **cpu_kw[name]).fit(DenseBatch(ids, x))
        cpu_ids, _ = cpu.query(x[:128], k=10, query_ids=ids[:128])
        agree = float((cpu_ids == got[:128]).all(axis=1).mean())
        check(agree >= 0.99, f"flat_20k {name}: GPU and CPU paths agree on only {agree}")
        q_s = timed_s(fn, sync, 7)
        out[name] = {"recall_at_10": rec, "jax_cpu_recall_at_10": want,
                     "launches": {k: v for k, v in launches.items() if v},
                     "cpu_path_agreement_128": agree, "qps": N_QUERY / q_s, "query_s": q_s,
                     "profile": device_profile(fn, sync)}
    out["grouped"]["select_mode"] = FL._resolve_select_mode("auto", flat.sketch.dtype, n,
                                                            flat.sketch.shape[1])
    out["grouped"]["kernels"] = kernels
    emit(out)
    return out


def flat_8m_phase(xd, gt, dev, sync, median_ms):
    """K4 against its plain version at the Deep-8M flat query's shapes, then
    `FlatIndex()` at its defaults (int8, refine 128, batch 1024, argpack with
    supergroups of 32, level 1 from K4's emitted tier and a sorted level 2)
    on folded_8m's corpus: 1,024 self-excluded queries.
    → (K4's check and timings, launch counts of the query)."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, FlatIndex
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4

    n, d = xd.shape
    nq = 1024
    ids = np.arange(n, dtype=np.int32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    flat = FlatIndex(device=dev).fit(DenseBatch(ids, xd))
    fit_s = timed_s(lambda: flat.fit(DenseBatch(ids, xd)), sync, 1)

    # ---- kernels_flat: K4 on the path's real operands -----------------------
    sk = flat.sketch
    q8 = FL._quantize_queries(xd[:nq], sk)
    npad, dk = sk.shape
    k4 = {"shape": {"B": nq, "Npad": npad, "D": dk, "group": 64},
          "tolerance": "bit for bit (0 mismatched words)"}
    # the tier at 32 is the one the path asks for at these shapes (the
    # select's own supergroup width, `_argpack_candidates`); the query below
    # checks that it does
    for name, kw in (("int8_packed", dict(pack_arg=True)), ("int8", {}),
                     ("int8_packed_emit16", dict(pack_arg=True, emit_sg=16)),
                     ("int8_packed_emit32", dict(pack_arg=True, emit_sg=32))):
        got = K4.flat_groupmax_kernel(sk, q8, 64, **kw)
        want = K4.flat_groupmax_plain(sk, q8, 64, **kw)
        pairs = list(zip(got, want)) if "emit_sg" in kw else [(got, want)]
        sync()
        bad = sum(int((g != w).sum()) for g, w in pairs)
        err = max(float((g.double() - w.double()).abs().max()) for g, w in pairs)
        check(bad == 0, f"K4 {name} differs from its plain version in {bad} words")
        out_bytes = nbytes(*(g for g, _ in pairs))
        del got, want, pairs
        k4[name] = {"form": K4.kernel_form(sk.dtype, dk), "mismatched_words": bad,
                    "max_abs_err": err,
                    **bound(nbytes(sk, q8) + out_bytes, 2.0 * nq * npad * dk, "int8"),
                    **kernel_times(lambda: K4.flat_groupmax_kernel(sk, q8, 64, **kw)),
                    "plain_ms": median_ms(lambda: K4.flat_groupmax_plain(sk, q8, 64, **kw))}
        k4[name]["bound_share"] = k4[name]["bound_ms"] / k4[name]["ms"]
    # the K-looped form (int8 past D 192) at the JAX package's high-D flat
    # workload, 200k x 784 (sketch width 800), exact2's unpacked call:
    # seeded random int8 values
    gen = torch.Generator(device=dev).manual_seed(784)
    sk_hd = torch.randint(-127, 128, (204_800, 800), generator=gen, device=dev, dtype=torch.int8)
    q_hd = torch.randint(-127, 128, (nq, 800), generator=gen, device=dev, dtype=torch.int8)
    got = K4.flat_groupmax_kernel(sk_hd, q_hd, 64)
    want = K4.flat_groupmax_plain(sk_hd, q_hd, 64)
    sync()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(bad == 0, f"K4 at D 800 differs from its plain version in {bad} words")
    hd = k4["int8_200k_d800"] = {
        "shape": {"B": nq, "Npad": sk_hd.shape[0], "D": 800, "group": 64},
        "form": K4.kernel_form(sk_hd.dtype, 800),
        "mismatched_words": bad, "max_abs_err": float((got - want).abs().max()),
        **bound(nbytes(sk_hd, q_hd, got), 2.0 * nq * sk_hd.shape[0] * 800, "int8"),
        **kernel_times(lambda: K4.flat_groupmax_kernel(sk_hd, q_hd, 64)),
        "plain_ms": median_ms(lambda: K4.flat_groupmax_plain(sk_hd, q_hd, 64))}
    hd["bound_share"] = hd["bound_ms"] / hd["ms"]
    del sk_hd, q_hd, got, want
    emit({"phase": "kernels_flat", "K4": k4})

    # ---- flat_8m: the engine at its defaults --------------------------------
    qd = xd[:nq]
    reset_launches()
    with recording(FL, "flat_groupmax_kernel") as calls:
        got, sc = flat.query_device(qd, k=10, query_ids=ids[:nq])
        sync()
    launches = read_launches()
    check(launches["flat_groupmax_kernel"] > 0, f"flat_8m did not launch K4: {launches}")
    emit_sg = [kw.get("emit_sg") for _, kw in calls["flat_groupmax_kernel"]]
    check(emit_sg == [32], f"flat_8m asked K4 for the tiers {emit_sg}, not one of 32")
    got = got.cpu().numpy()
    check(got.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
          "flat_8m output has the wrong shape or non-finite scores")
    rec = recall_at(gt, got)
    check(rec >= FLAT8M_RECALL_MIN, f"flat_8m recall@10 {rec} is below {FLAT8M_RECALL_MIN}")
    q_s = timed_s(lambda: flat.query_device(qd, k=10, query_ids=ids[:nq]), sync, 3)
    # host-clock stages of the argpack path around K4 (median of 7, each
    # ending in a sync; K4's own time is kernels_flat's "ms"), on K4's keys
    # and emitted tier at 32 as the path takes them; the select folding the
    # tier equals the one reducing the slab, bit for bit
    n_live = flat.row_ids.shape[0]
    qi = torch.arange(nq, dtype=torch.int32, device=dev)
    packed, sgmax_pre = K4.flat_groupmax_kernel(sk, q8, 64, pack_arg=True, emit_sg=32)
    packed[:, -(-n_live // 64):] = FL._I32_DEAD

    def select():
        return FL.select_packed_rows(packed, 64, 128, n_live, sgmax_pre=sgmax_pre, emit_sg=32)

    cand, sel = select()
    cand0, sel0 = FL.select_packed_rows(packed, 64, 128, n_live)
    sync()
    tier_bad = int((cand != cand0).sum()) + int((sel.view(torch.int32)
                                                 != sel0.view(torch.int32)).sum())
    check(tier_bad == 0, f"flat_8m's select on K4's tier differs from the slab reduce's "
                         f"in {tier_bad} words")
    del cand0, sel0

    def stage_ms(fn):
        return timed_s(fn, sync, 7) * 1e3

    stages = {
        "quantize_queries": stage_ms(lambda: FL._quantize_queries(qd, sk)),
        "mask_dead_groups": stage_ms(lambda: packed[:, -(-n_live // 64):].fill_(FL._I32_DEAD)),
        "two_level_select": stage_ms(select),
        "exact_refine": stage_ms(lambda: FL._exact_refine(flat.corpus, flat.row_ids, qd, cand,
                                                          torch.isfinite(sel), qi, 10, True))}
    del packed, sgmax_pre
    emit({"phase": "flat_8m", "n": n, "dim": d, "queries": nq,
          "config": {"sketch_dtype": "int8", "refine": 128, "query_batch": 1024,
                     "select_mode": FL._resolve_select_mode("auto", sk.dtype, n, dk),
                     "select_sg": 32, "emit_sg": emit_sg[0], "argpack_l2": "sort",
                     "group": 64},
          "select_tier_mismatched_words": tier_bad,
          "recall_at_10": rec, "tpu_v5e_recall_at_10": TPU_FLAT8M_RECALL,
          "recall_gap": rec - TPU_FLAT8M_RECALL,
          "launches": {k: v for k, v in launches.items() if v},
          "qps": nq / q_s, "query_s": q_s, "fit_s": fit_s,
          "bytes_per_vector": flat.bytes_per_vector(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "stage_ms": stages,
          "profile": device_profile(lambda: flat.query_device(qd, k=10, query_ids=ids[:nq]),
                                    sync)})
    del flat
    torch.cuda.empty_cache()
    bf16_leg = flat_8m_bf16_leg(xd, gt, sk, q8, sync, median_ms)
    return k4, launches, bf16_leg


def flat_8m_bf16_leg(xd, gt, sk8, q8, sync, median_ms) -> dict:
    """`FlatIndex(sketch_dtype="bfloat16")` on the Deep-8M corpus (exact2: K4
    unpacked in bf16, then K2b's bf16 re-score): 1,024 self-excluded
    queries, recall@10 gated at FLAT8M_RECALL_MIN, qps, launches; K4 bf16
    on the path's own operands against its plain version (within the f32
    bound) and, on the int8 path's sketch and queries as bf16 values, word
    for word equal to K4 int8; K2b on its own operands (`window_check`).
    → the phase's record."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch, FlatIndex
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops.kernels import flat_groupmax as K4

    dev = xd.device
    n, d = xd.shape
    nq = 1024
    ids = np.arange(n, dtype=np.int32)
    torch.cuda.reset_peak_memory_stats(dev)
    flat = FlatIndex(sketch_dtype="bfloat16", device=dev).fit(DenseBatch(ids, xd))
    fit_s = timed_s(lambda: flat.fit(DenseBatch(ids, xd)), sync, 1)
    qd = xd[:nq]
    with recording(FL, "flat_groupmax_kernel", "coarse_window_scores_kernel") as calls:
        reset_launches()
        got, sc = flat.query_device(qd, k=10, query_ids=ids[:nq])
        sync()
        launches = read_launches()
    check(launches["flat_groupmax_kernel"] > 0 and launches["coarse_window_scores_kernel"] > 0,
          f"flat_8m_bf16 did not launch K4 and K2b: {launches}")
    got = got.cpu().numpy()
    check(got.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
          "flat_8m_bf16 output has the wrong shape or non-finite scores")
    rec = recall_at(gt, got)
    check(rec >= FLAT8M_RECALL_MIN, f"flat_8m_bf16 recall@10 {rec} is below {FLAT8M_RECALL_MIN}")
    q_s = timed_s(lambda: flat.query_device(qd, k=10, query_ids=ids[:nq]), sync, 3)

    (sk16, q16, group), kw4 = calls["flat_groupmax_kernel"][0]
    check(not kw4 and sk16.dtype == torch.bfloat16, f"unexpected K4 call on flat_8m_bf16: {kw4}")
    npad, dk = sk16.shape
    kern = K4.flat_groupmax_kernel(sk16, q16, group)
    plain = K4.flat_groupmax_plain(sk16, q16, group)
    lim = 2 * dk * U32 * K4.flat_groupmax_plain(sk16.abs(), q16.abs(), group)
    sync()
    err = (kern - plain).abs()
    check(bool((err <= lim).all()), f"K4 bf16 on flat_8m_bf16 exceeds the f32 bound: max err "
                                    f"{float(err.max())}")
    again = K4.flat_groupmax_kernel(sk16, q16, group)
    check(bool(torch.equal(again.view(torch.int32), kern.view(torch.int32))),
          "K4 bf16 on flat_8m_bf16 gives other words on a second call")
    del plain, lim, again
    # int8 values as bf16: every sum an integer below 2^24, exact in f32
    via_bf16 = K4.flat_groupmax_kernel(sk8.to(torch.bfloat16), q8.to(torch.bfloat16), group)
    as_int8 = K4.flat_groupmax_kernel(sk8, q8, group)
    sync()
    vs_int8 = int((via_bf16.view(torch.int32) != as_int8.view(torch.int32)).sum())
    check(vs_int8 == 0, f"K4 bf16 on int8 values differs from K4 int8 in {vs_int8} words")
    del via_bf16, as_int8
    torch.cuda.empty_cache()
    k4 = {"shape": {"B": q16.shape[0], "Npad": npad, "D": dk, "group": group},
          "form": K4.kernel_form(sk16.dtype, dk), "max_abs_err": float(err.max()),
          "words_unequal_to_int8": vs_int8,
          "tolerance": "|err| <= 2*D*2^-24*sum|s*q| per value; int8 values: bit for bit",
          **bound(nbytes(sk16, q16, kern), 2.0 * q16.shape[0] * npad * dk, "bf16"),
          **kernel_times(lambda: K4.flat_groupmax_kernel(sk16, q16, group)),
          "plain_ms": median_ms(lambda: K4.flat_groupmax_plain(sk16, q16, group))}
    k4["bound_share"] = k4["bound_ms"] / k4["ms"]
    del kern, err, sk16, q16, calls["flat_groupmax_kernel"]
    args, kw2 = calls["coarse_window_scores_kernel"][0]
    check(not kw2, f"unexpected K2b call on flat_8m_bf16: {kw2}")
    k2b = window_check(args, sync, median_ms, "flat_8m_bf16's re-score")
    del args, calls
    out = {"phase": "flat_8m_bf16", "n": n, "dim": d, "queries": nq,
           "config": {"sketch_dtype": "bfloat16", "refine": flat.refine, "query_batch": 1024,
                      "select_mode": FL._resolve_select_mode("auto", torch.bfloat16, n, dk),
                      "group": group},
           "recall_at_10": rec, "launches": {k: v for k, v in launches.items() if v},
           "qps": nq / q_s, "query_s": q_s, "fit_s": fit_s,
           "bytes_per_vector": flat.bytes_per_vector(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "profile": device_profile(lambda: flat.query_device(qd, k=10, query_ids=ids[:nq]),
                                     sync),
           "kernels": {"K4_bf16": k4, "K2b": k2b}}
    emit(out)
    del flat
    torch.cuda.empty_cache()
    return out


# recall@10 of the JAX package on a TPU v5e on the sparse_1m corpus
# (results/sparse_1m.json, scripts/bench_sparse_1m.py): parity references,
# not targets. At coarse_refine 2048 the TPU took approx_max_k, which was
# approximate there; the port selects exactly.
SPARSE_TPU_RECALL = {(0, 2048): 0.6168, (0, 4096): 0.9655, (1, 8192): 0.9997}
SPARSE_N, SPARSE_DIM, SPARSE_NNZ, SPARSE_NQ = 1_000_000, 4096, 64, 1024
# (refine, r_groups) of the sparse flat engine beside its default (128, 30)
SPARSE_FLAT_WITNESS = ((128, 100), (128, 200), (512, 200))


def sparse_corpus(n=SPARSE_N, dim=SPARSE_DIM, nnz=SPARSE_NNZ, n_clusters=5000, seed=3):
    """`scripts/bench_sparse_1m.py:29-37`'s corpus, drawn in the same order:
    5,000 cluster supports of `nnz` distinct indices, each row one
    cluster's support, values 0.8 + 0.2·U normalised."""
    rng = np.random.default_rng(seed)
    supports = np.stack([rng.choice(dim, size=nnz, replace=False) for _ in range(n_clusters)])
    idx = supports[rng.integers(0, n_clusters, n)].astype(np.int32)
    val = (0.8 + 0.2 * rng.random((n, nnz))).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return idx, val


def sparse_conf(**kw):
    """`scripts/bench_sparse_1m.py:62-69`'s index config."""
    from similaritysearchbyrdf_tpu_torch import RDFConfig, TableConfig

    return RDFConfig(vector_dim=SPARSE_DIM, table_num=10, permutation_num=3, family_size=100,
                     partition_bits=3,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=500),
                     query_batch_size=64, max_candidates=16384, top_k=10, coarse_dim=64,
                     coarse_dtype="int8", coarse_refine=2048, **kw)


def sparse_phase(dev, sync, median_ms) -> dict:
    """The sparse path at `scripts/bench_sparse_1m.py`'s scale: 1,000,000 x
    4096 rows of 64 non-zeros. Exact ground truth of 1,024 self-excluded
    queries (`exact_topk_sparse`, held against an f32 product of densified
    chunks); the forest's fit and its three query points; the first query
    chunk again on the CPU path; the sparse flat engine; K1 (a fit chunk
    and a query chunk), K2 (cs 64), K2b (cs 4096) and K4 (D 4096) against
    their plain versions on the operands the path gave them. → the kernel
    records."""
    import torch

    from similaritysearchbyrdf_tpu_torch import SparseBatch, SparseFlatIndex, SparseRDFForest
    from similaritysearchbyrdf_tpu_torch.experiments.harness import equal_up_to_ties
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.index import sparse_forest as SF
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.ops.exact import exact_topk_sparse
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2M
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1M
    from similaritysearchbyrdf_tpu_torch.ops.precision import full_f32
    from similaritysearchbyrdf_tpu_torch.ops.rerank import top_sorted

    t_phase = time.perf_counter()
    n, dim, nq = SPARSE_N, SPARSE_DIM, SPARSE_NQ
    t0 = time.perf_counter()
    idx, val = sparse_corpus()
    gen_s = time.perf_counter() - t0
    ids = np.arange(n, dtype=np.int32)
    idx_d, val_d = torch.as_tensor(idx, device=dev), torch.as_tensor(val, device=dev)
    batch = SparseBatch(ids, dim, idx_d, val_d, np.full(n, SPARSE_NNZ, np.int32))
    queries = batch.slice(0, nq)
    out = {"phase": "sparse_1m", "n": n, "dim": dim, "nnz": SPARSE_NNZ, "queries": nq,
           "corpus_gen_s": gen_s, "source": "scripts/bench_sparse_1m.py:29-80",
           "tpu_v5e_recall_at_10": {f"steps{s}_rf{r}": v
                                    for (s, r), v in SPARSE_TPU_RECALL.items()}}
    calls = {}

    # ---- ground truth: exact_topk_sparse, held against densified f32 products
    qd = H.densify(idx_d[:nq], val_d[:nq], dim)
    sync()
    t0 = time.perf_counter()
    gt_i, gt_s = exact_topk_sparse(idx_d, val_d, qd, 10, exclude_diag_offset=0)
    sync()
    gt_secs = time.perf_counter() - t0
    best_s = torch.full((nq, 10), float("-inf"), device=dev)
    best_i = torch.full((nq, 10), -1, dtype=torch.int64, device=dev)
    qrow = torch.arange(nq, device=dev)[:, None]
    for c0 in range(0, n, 65536):
        rows = H.densify(idx_d[c0:c0 + 65536], val_d[c0:c0 + 65536], dim)
        with full_f32():
            sc = qd @ rows.T
        rid = torch.arange(c0, c0 + rows.shape[0], device=dev)[None, :]
        sc = torch.where(rid == qrow, float("-inf"), sc)
        cat_s, cat_i = torch.cat([best_s, sc], 1), torch.cat([best_i, rid.expand(nq, -1)], 1)
        best_s, ti = top_sorted(cat_s, 10)
        best_i = torch.gather(cat_i, 1, ti)
        del rows, sc
    gt = gt_i.cpu().numpy()
    gs, di, ds = gt_s.cpu().numpy(), best_i.cpu().numpy(), best_s.cpu().numpy()
    check(np.isfinite(gs).all(), "sparse ground truth has non-finite scores")
    gt_ties = int((gt != di).any(axis=1).sum())
    check(all(equal_up_to_ties(gt[i], gs[i], di[i], ds[i], 1e-6) for i in range(nq)),
          "exact_topk_sparse disagrees with the densified f32 product beyond ties")
    out["ground_truth"] = {"s": gt_secs, "queries_differing_by_ties": gt_ties,
                           "max_score_diff": float(np.abs(gs - ds).max())}
    del best_s, best_i

    # ---- the forest: cold fit, then a warm fit on the main path -----------
    conf = sparse_conf()
    t0 = time.perf_counter()
    forest = SparseRDFForest(conf, device=dev)
    out["model_s"] = time.perf_counter() - t0
    forest.fit(batch)
    sync()
    nb_pad = forest.state.tables.bucket_keys.shape[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with recording(H, K1, limit=1) as k1_fit:
        state = launch_checked("sparse_1m", calls, "fit", lambda: SF.fit_sparse(
            conf, batch, model=forest.model, part_proj=forest.part_proj, nb_pad=nb_pad),
            (K1,), sync)
    fit_s = calls["fit"]["first_s"]
    forest.state = state
    st = state
    out["fit"] = {"s": fit_s, "build_vectors_per_sec": n / fit_s,
                  "index_bytes_per_vector": st.tables.index_bytes() / n,
                  "coarse_tier_bytes_per_vector": nbytes(st.coarse_tier) / n,
                  "corpus_bytes_per_vector": nbytes(st.corpus_indices, st.corpus_values) / n,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}

    # ---- the query points --------------------------------------------------
    qids = ids[:nq]
    out["points"] = {}
    torch.cuda.reset_peak_memory_stats(dev)
    k1_query_call = k2_call = None
    for steps, refine in SPARSE_TPU_RECALL:
        name = f"steps{steps}_rf{refine}"

        def run(steps=steps, refine=refine):
            return forest.query_device(queries, steps=steps, query_ids=qids, coarse_refine=refine)

        if k2_call is None:
            with recording(H, K1, limit=1) as k1c, recording(F, K2, limit=1) as k2c:
                got, sc = launch_checked("sparse_1m", calls, name, run, (K1, K2), sync)
            k1_query_call, k2_call = k1c[K1][0], k2c[K2][0]
        else:
            got, sc = launch_checked("sparse_1m", calls, name, run, (K1, K2), sync)
        got = got.cpu().numpy()
        check(got.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
              f"sparse_1m {name}: wrong shape or non-finite scores")
        q_s = timed_s(run, sync, 3)
        rec = recall_at(gt, got)
        out["points"][name] = {"steps": steps, "coarse_refine": refine, "recall_at_10": rec,
                               "tpu_v5e_recall_at_10": SPARSE_TPU_RECALL[(steps, refine)],
                               "recall_gap": rec - SPARSE_TPU_RECALL[(steps, refine)],
                               "qps": nq / q_s, "query_s": q_s}
    out["query_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    last = lambda: forest.query_device(queries, steps=1, query_ids=qids, coarse_refine=8192)
    out["profile_steps1_rf8192"] = device_profile(last, sync)

    # ---- the card against the CPU path: the first 64-query chunk ----------
    t0 = time.perf_counter()
    cpu_state = st.to("cpu")
    layout = forest.layout
    q64 = queries.slice(0, 64)
    kw = dict(steps=0, m_cap=conf.max_candidates, k=10, exclude_self=True, coarse_refine=4096)
    g_ids, g_sc, _ = SF._query_sparse(st, q64.indices, q64.values,
                                      torch.as_tensor(qids[:64], device=dev), layout, dim, **kw)
    c_ids, c_sc, _ = SF._query_sparse(cpu_state, q64.indices.cpu(), q64.values.cpu(),
                                      torch.as_tensor(qids[:64]), layout, dim, **kw)
    g_ids, g_sc, c_ids, c_sc = (t.cpu().numpy() for t in (g_ids, g_sc, c_ids, c_sc))
    tied = int((g_ids != c_ids).any(axis=1).sum())
    check(all(equal_up_to_ties(g_ids[i], g_sc[i], c_ids[i], c_sc[i], 1e-6) for i in range(64)),
          "sparse_1m: the card and the CPU path disagree beyond exact-score ties")
    out["cpu_path"] = {"queries": 64, "steps": 0, "coarse_refine": 4096,
                       "queries_differing_by_ties": tied, "s": time.perf_counter() - t0}
    del cpu_state

    # ---- the sparse flat engine on the same corpus -------------------------
    flat = SparseFlatIndex(device=dev)
    sync()
    t0 = time.perf_counter()
    flat.fit(batch)
    sync()
    flat_build_s = time.perf_counter() - t0

    def flat_query():
        return flat.query_device(queries.indices, queries.values, k=10, query_ids=qids)

    with recording(FL, K4, K2B, limit=1) as f_calls:
        f_ids, f_sc = launch_checked("sparse_1m", calls, "flat", flat_query, (K4, K2B), sync)
    f_ids = f_ids.cpu().numpy()
    check(f_ids.shape == (nq, 10) and bool(torch.isfinite(f_sc).all()),
          "sparse_1m flat: wrong shape or non-finite scores")
    f_s = timed_s(flat_query, sync, 3)
    # the witness to the recall's cause: more groups kept, and then more rows
    # re-scored exactly, on the same sketch and queries
    witness = {}
    for refine, r_groups in SPARSE_FLAT_WITNESS:
        wit = SparseFlatIndex(refine, r_groups, device=dev).set_state(
            flat.sketch, flat.scale, flat.c_idx, flat.c_val, flat.row_ids, flat.size)
        w_ids, _ = wit.query_device(queries.indices, queries.values, k=10, query_ids=qids)
        witness[f"refine{refine}_rg{r_groups}"] = {
            "refine": refine, "r_groups": wit.groups_kept(10),
            "recall_at_10": recall_at(gt, w_ids.cpu().numpy()),
            "query_s": timed_s(lambda: wit.query_device(queries.indices, queries.values, k=10,
                                                        query_ids=qids), sync, 1)}
    out["flat"] = {"refine": flat.refine, "r_groups": flat.groups_kept(10),
                   "select_mode": FL._resolve_select_mode("auto", flat.sketch.dtype, n,
                                                          flat.sketch.shape[1]),
                   "build_s": flat_build_s, "bytes_per_vector": flat.bytes_per_vector(),
                   "recall_at_10": recall_at(gt, f_ids), "qps": nq / f_s, "query_s": f_s,
                   "forest_best_recall_at_10": out["points"]["steps1_rf8192"]["recall_at_10"],
                   "witness": witness,
                   "profile": device_profile(flat_query, sync)}

    # ---- the kernels on the path's own operands ---------------------------
    kern = {}
    for name, call, b in (("K1_fit", k1_fit[K1][0], conf.fit_batch_size),
                          ("K1_query", k1_query_call, conf.query_batch_size)):
        (x, proj, perm), kw1 = call
        check(not kw1 and x.shape == (b, dim), f"unexpected K1 call {name}: {kw1}")
        kern[name] = {"form": K1M.kernel_form(dim),
                      **hash_check(x, proj, perm, False, sync, median_ms, f"sparse_1m's {name}")}
        pmat = proj.reshape(-1, dim)
        with full_f32():
            kern[name]["product_ms"] = median_ms(lambda: torch.matmul(x, pmat.T))
    (tier, q_low, table_i, blk_start, bs), kw2 = k2_call
    check(not kw2, f"unexpected K2 call on sparse_1m: {kw2}")
    k2 = block_kernel_check(tier, q_low, table_i, blk_start, bs, sync, median_ms)
    k2["mismatched_values"] = int(
        (K2M.coarse_block_scores_kernel(tier, q_low, table_i, blk_start, bs)
         != K2M.coarse_block_scores_plain(tier, q_low, table_i, blk_start, bs)).sum())
    kern["K2"] = k2
    fk = flat_kernels(f_calls[K4][0], f_calls[K2B][0], sync, median_ms, "sparse_1m",
                      bf16=False)
    check(fk["K4_int8"]["shape"]["D"] == dim, f"unexpected K4 call on sparse_1m: {fk}")
    kern["K4"] = fk["K4_int8"]
    (sk4, q4, _), _ = f_calls[K4][0]

    def int_mm_slabs():
        for r0 in range(0, sk4.shape[0], 131_072):
            torch._int_mm(q4, sk4[r0:r0 + 131_072].t())

    kern["K4"]["product_ms"] = median_ms(int_mm_slabs)
    kern["K2b"] = fk["K2b"]
    for rec in kern.values():
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
    out["kernels"] = kern
    # the single-device engines go before the sharded ones are built
    model, part_proj = forest.model, forest.part_proj
    del forest, state, st, flat, f_calls, wit, k1_fit, k1_query_call, k2_call, tier, q_low
    del table_i, blk_start, x, proj, perm, pmat, fk, sk4, q4
    torch.cuda.empty_cache()
    out["sharded"] = sparse_sharded_leg(batch, queries, qids, gt, out, calls, model, part_proj,
                                        dev, sync, median_ms)
    out["calls"] = calls
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def sparse_sharded_leg(batch, queries, qids, gt, single: dict, calls: dict, model, part_proj,
                       dev, sync, median_ms) -> dict:
    """sparse_1m's corpus on 4 shards of the card: `fit_sparse_sharded` and
    `make_sparse_query_fn` (the classic path: steps 0, m_cap 16384, 1,024
    queries in chunks of 64; K1 at D 4096), then `ShardedSparseFlatIndex()`
    (K4 and K2b at D 4096); each recall beside the single-device engines',
    each merge redone on the host for the first chunk, K1, K4 and K2b held
    against their plain versions on shard 0's first call."""
    import torch

    from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh

    nq, dim = queries.n, batch.size
    mesh = make_forest_mesh(devices=[dev] * 4)
    conf = sparse_conf()
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    qi, qv = queries.indices, queries.values
    qd = torch.as_tensor(qids, device=dev)
    out = {"shards": 4, "devices": [str(d) for d in mesh.devices],
           "single_device_forest_recall_at_10": {
               k: v["recall_at_10"] for k, v in single["points"].items()},
           "single_device_flat_recall_at_10": single["flat"]["recall_at_10"]}
    sync()
    t0 = time.perf_counter()
    st, _ = SF.fit_sparse_sharded(conf, batch, mesh, model=model, part_proj=part_proj)
    sync()
    fit_s = time.perf_counter() - t0
    fn = SF.make_sparse_query_fn(mesh, layout, dim, steps=0, m_cap=conf.max_candidates, k=10)

    def forest_query():
        return fn(st, qi, qv, qd, chunk=conf.query_batch_size)[:2]

    with recording(H, K1, limit=1) as k1c:
        (got, sc) = launch_checked("sparse_1m", calls, "sharded_forest", forest_query, (K1,),
                                   sync)
    got = got.cpu().numpy()
    check(got.shape == (nq, 10), "sparse_1m sharded forest: wrong shape")
    want_i, want_s = host_merge(SF.query_sparse_shards(
        st, qi[:64], qv[:64], qd[:64], layout, dim, steps=0, m_cap=conf.max_candidates,
        k=10), 10, "above_neg_inf")
    check(np.array_equal(got[:64], want_i) and np.array_equal(sc[:64].cpu().numpy(), want_s),
          "sparse_1m sharded forest: the merge differs from the host merge")
    q_s = timed_s(forest_query, sync, 2)
    out["forest"] = {"steps": 0, "m_cap": conf.max_candidates, "chunk": conf.query_batch_size,
                     "fit_s": fit_s, "recall_at_10": recall_at(gt, got), "qps": nq / q_s,
                     "query_s": q_s, "launches": calls["sharded_forest"]["launches"],
                     "profile": device_profile(forest_query, sync, reps=1, wall_reps=2)}
    (x, proj, perm), kw1 = k1c[K1][0]
    check(not kw1 and x.shape[1] == dim, f"unexpected K1 call: {kw1}")
    kern = {"K1": hash_check(x, proj, perm, False, sync, median_ms,
                             "the sharded sparse forest's shard 0")}
    del st, k1c, x
    torch.cuda.empty_cache()

    sync()
    t0 = time.perf_counter()
    flat = SFL.ShardedSparseFlatIndex(mesh).fit(batch)
    sync()
    fit_s = time.perf_counter() - t0

    def flat_query():
        return flat.query_device(qi, qv, k=10, query_ids=qids)

    with recording(FL, K4, K2B, limit=1) as f_calls:
        got, sc = launch_checked("sparse_1m", calls, "sharded_flat", flat_query, (K4, K2B), sync)
    got = got.cpu().numpy()
    want_i, want_s = host_merge(
        [FL.flat_topk_sparse(sh.sketch, sh.c_idx, sh.c_val, sh.row_ids, qi[:64], qv[:64],
                              qd[:64], 10, refine=flat.refine, r_groups=max(flat.r_groups, 3 * 10),
                              n_live=sh.n_live) for sh in flat.state.shards], 10, "finite")
    check(np.array_equal(got[:64], want_i) and np.array_equal(sc[:64].cpu().numpy(), want_s),
          "sparse_1m sharded flat: the merge differs from the host merge")
    q_s = timed_s(flat_query, sync, 3)
    out["flat"] = {"fit_s": fit_s, "recall_at_10": recall_at(gt, got), "qps": nq / q_s,
                   "query_s": q_s, "launches": calls["sharded_flat"]["launches"],
                   "profile": device_profile(flat_query, sync)}
    fk = flat_kernels(f_calls[K4][0], f_calls[K2B][0], sync, median_ms,
                      "the sharded sparse flat engine's shard 0", bf16=False)
    kern["K4"], kern["K2b"] = fk["K4_int8"], fk["K2b"]
    for rec in kern.values():
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    out["kernels"] = kern
    return out


# ---------------------------------------------------------------------------
# sharded_8m: the sharded engines, 8 shards on the card
# ---------------------------------------------------------------------------

ID_SPACE = 100_000_000          # the Deep-100M plan's id space (results/deep100m.json)
# rows of the two-process leg: each of 8 shards a multiple of 128 rows, so
# the one-process and the multi-process fits lay rows out alike. Cut from
# 7,999,488: with those the whole smoke ran 529 s on an H100 (700 W), past
# its 450 s aim (each rank drew the 8M corpus in 40 s); a rank now draws its
# first chunk.
TWO_PROC_ROWS = 1_048_576
SHARDED_RECALL_MIN = 0.995      # flat_8m and ivf_8m read 1.0


def sharded_ids(n: int = 8_000_000) -> np.ndarray:
    """Ids drawn sparsely from [0, 100M) and shuffled, as
    `scripts/deep100m_capstone.py:77-83` draws them."""
    rng = np.random.default_rng(100)
    ids = np.sort(rng.choice(ID_SPACE, size=n, replace=False)).astype(np.int32)
    rng.shuffle(ids)
    return ids


def host_merge(lists, k: int, mask: str):
    """The merge redone on the host from each shard's own (ids, scores)
    lists: concatenated in shard order, a stable sort by score, the best
    k, an id kept where its score is finite (or above -inf)."""
    ids = np.concatenate([np.asarray(i.cpu()) for i, *_ in lists], axis=1)
    sc = np.concatenate([np.asarray(s.cpu()) for _, s, *_ in lists], axis=1)
    order = np.argsort(-sc, axis=1, kind="stable")[:, :k]
    m_sc = np.take_along_axis(sc, order, 1)
    keep = np.isfinite(m_sc) if mask == "finite" else m_sc > -np.inf
    return np.where(keep, np.take_along_axis(ids, order, 1), -1), m_sc


def fold_check(args, sync, median_ms, where: str) -> dict:
    """K3 against its plain version on the operands a folded query gave it:
    bit for bit; with its times and bound (the distinct folded rows of live
    windows, the small inputs, the packed output)."""
    import torch

    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3

    folded, qi8, table, rs, wpr, rpg, mshift, emit2 = args
    got = K3.coarse_rowmax_kernel(*args)
    want = K3.coarse_rowmax_plain(*args)
    pairs = list(zip(got, want)) if emit2 else [(got, want)]
    sync()
    bad = sum(int((g != w).sum()) for g, w in pairs)
    check(bad == 0, f"K3 on {where} differs from its plain version in {bad} words")
    _, capf, lanes = folded.shape
    live = rs >= 0
    rows = (table.long().clamp(0, folded.shape[0] - 1)[..., None] * capf
            + rs.long().clamp(0, capf - wpr)[..., None] + torch.arange(wpr, device=rs.device))
    distinct = int(torch.unique(rows[live]).numel()) * lanes
    gathered = int(live.sum()) * wpr * lanes
    out_bytes = sum(nbytes(g) for g, _ in pairs)
    return {"shape": {"B": qi8.shape[0], "MB": rs.shape[1], "wpr": wpr, "rpg": rpg,
                      "L": folded.shape[0], "capf": capf, "lanes": lanes, "emit2": emit2},
            "mismatched_words": bad, "max_abs_err": 0.0,
            "tolerance": "bit for bit (0 mismatched words)",
            **bound(distinct + nbytes(qi8, table, rs) + out_bytes, 2 * gathered, "int8"),
            **kernel_times(lambda: K3.coarse_rowmax_kernel(*args)),
            "plain_ms": median_ms(lambda: K3.coarse_rowmax_plain(*args)),
            "gathered_bytes": gathered, "distinct_bytes": distinct}


def k1_check(call, sync, median_ms, where: str) -> dict:
    (x, proj, perm, *rest), kw = call
    margins = bool(rest[0] if rest else kw.get("emit_margins", False))
    return hash_check(x, proj, perm, margins, sync, median_ms, where)


def sharded_leg(out: dict, name: str, run, kernels, record, nq: int, gt_ids, all_ids,
                sync, wall_reps: int = 3, profile_reps: int = 3):
    """One engine's query on the main path: every launch count set to 0
    just before its first call and read just after (each kernel in
    `kernels` must have launched), the first recorded call of each
    (module, name) in `record` kept; its recall@10 against `gt_ids`, every
    returned id one of `all_ids`, its qps and a device profile. → (ids,
    scores, recorded calls)."""
    import torch

    rec_calls = {}
    reset_launches()
    with contextlib.ExitStack() as stack:
        for module, names in record:
            rec_calls.update(stack.enter_context(recording(module, *names, limit=1)))
        t0 = time.perf_counter()
        got, sc = run()
        sync()
        first_s = time.perf_counter() - t0
    launches = read_launches()
    check(all(launches[k] > 0 for k in kernels),
          f"sharded_8m {name}: a kernel of its path was not launched: {launches}")
    got_np, sc_np = got.cpu().numpy(), sc.cpu().numpy()
    check(got_np.shape == (nq, 10) and bool(torch.isfinite(sc).all()),
          f"sharded_8m {name}: wrong shape or non-finite scores")
    unknown = int((~np.isin(got_np, all_ids)).sum())
    check(unknown == 0, f"sharded_8m {name}: {unknown} returned ids are not in the corpus")
    q_s = timed_s(run, sync, wall_reps)
    out[name].update({"recall_at_10": recall_at(gt_ids, got_np), "first_query_s": first_s,
                      "qps": nq / q_s, "query_s": q_s,
                      "launches": {k: v for k, v in launches.items() if v},
                      "profile": device_profile(run, sync, reps=profile_reps,
                                                wall_reps=wall_reps)})
    return got_np, sc_np, rec_calls


def sharded_phase(x8, gt8, dev, sync, median_ms) -> dict:
    """The sharded engines on the Deep-8M corpus, 8 shards on one card
    (the capstone's 8-shard layout), ids over a 100M id space: the sharded
    forest at folded_8m's config (K1, K3) and at the bench config in block
    mode (K1, K2), the sharded flat engine (K4, K2b) and the sharded IVF
    engine at ivf_8m's headline point (K2b), built one at a time; each
    merge redone on the host from the shards' own lists for the first
    query chunk; every kernel held against its plain version on shard 0's
    first call; then the two-process leg."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops import flat as FL
    from similaritysearchbyrdf_tpu_torch.ops import hashing as H
    from similaritysearchbyrdf_tpu_torch.ops import ivf as IVF
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import SHARD_AXIS, make_forest_mesh

    t_phase = time.perf_counter()
    n, nq = x8.shape[0], 1024
    t0 = time.perf_counter()
    ids = sharded_ids(n)
    ids_s = time.perf_counter() - t0
    gt_ids = ids[gt8]
    ids_d = torch.as_tensor(ids, device=dev)
    batch = DenseBatch(ids_d, x8)
    q, qids = x8[:nq], ids_d[:nq]
    mesh = make_forest_mesh(devices=[dev] * 8)
    check(mesh.shape[SHARD_AXIS] == 8, "the mesh does not hold 8 shards")
    single = {k: RESULTS.get(k, {}) for k in ("folded_8m", "flat_8m", "ivf_8m")}
    out = {"phase": "sharded_8m", "n": n, "dim": x8.shape[1], "queries": nq, "shards": 8,
           "devices": [str(d) for d in mesh.devices], "id_space": ID_SPACE,
           "max_id": int(ids.max()), "ids_draw_s": ids_s,
           "source": "scripts/deep100m_capstone.py:77-83 (ids), folded_8m's corpus"}
    kern = {}

    def fit_timed(fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    def merge_check(name, got, sc, lists, mask):
        want_i, want_s = host_merge(lists, 10, mask)
        b = want_i.shape[0]
        same = bool(np.array_equal(got[:b], want_i) and np.array_equal(sc[:b], want_s))
        check(same, f"sharded_8m {name}: the merge differs from the host merge of the "
                    f"shards' own lists")
        out[name]["merge_equal_to_host_merge_queries"] = b

    # ---- 1. the sharded forest at folded_8m's config: K1, K3 --------------
    t_leg = time.perf_counter()
    qkw = dict(steps=1, probe_mode="margin", probe_budget=16)
    conf_f = folded_conf()
    forest = SF.ShardedRDFForest(conf_f, mesh)
    with recording(H, K1, limit=1) as fit_k1:
        fit_s = fit_timed(lambda: forest.fit(batch))[1]
    st = forest.state
    out["folded"] = {"config": "folded_8m", "fit_s": fit_s, "build_vectors_per_sec": n / fit_s,
                     "nloc": st.nloc, "n_live": st.n_live,
                     "index_bytes_per_vector": sum(s.tables.index_bytes()
                                                   for s in st.shards) / n,
                     "single_device": {k: single["folded_8m"].get(k) for k in
                                       ("recall_at_10", "qps", "build_s")}}
    check(st.nloc == 1_000_064, f"a forest shard holds {st.nloc} rows, not 1,000,064")
    got, sc, calls = sharded_leg(
        out, "folded", lambda: forest.query_device(q, query_ids=qids, **qkw),
        (K1, "coarse_rowmax_kernel"), ((H, (K1,)), (F, ("coarse_rowmax_kernel",))),
        nq, gt_ids, ids, sync, wall_reps=2, profile_reps=1)
    out["folded"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    merge_check("folded", got, sc, SF.query_shards(st, q[:64], qids[:64], forest.layout,
                                                   forest.query_kw(**qkw)), "above_neg_inf")
    single_rec = single["folded_8m"].get("recall_at_10")
    if single_rec is not None:
        out["folded"]["recall_gap_to_single_device"] = out["folded"]["recall_at_10"] - single_rec
    kern["K1_fit"] = k1_check(fit_k1[K1][0], sync, median_ms, "shard 0's first fit chunk")
    kern["K1_folded"] = k1_check(calls[K1][0], sync, median_ms, "shard 0's first query chunk")
    kern["K3"] = fold_check(calls["coarse_rowmax_kernel"][0][0], sync, median_ms,
                            "shard 0's first query chunk")
    out["folded"]["leg_s"] = time.perf_counter() - t_leg
    del forest, st, calls, fit_k1

    # ---- 2. the sharded forest at the bench config, block mode: K1, K2 ----
    t_leg = time.perf_counter()
    conf_b = timing.bench_config().replace(vector_dim=x8.shape[1])    # Deep's 96 dims
    forest = SF.ShardedRDFForest(conf_b, mesh)
    fit_s = fit_timed(lambda: forest.fit(batch))[1]
    out["block"] = {"config": "bench (int8 cd 32, refine 384, m_cap 4096, batch 1024; D 96)",
                    "fit_s": fit_s, "build_vectors_per_sec": n / fit_s}
    got, sc, calls = sharded_leg(
        out, "block", lambda: forest.query_device(q, query_ids=qids, **QUERY_KW), (K1, K2),
        ((H, (K1,)), (F, (K2,))), nq, gt_ids, ids, sync)
    out["block"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    merge_check("block", got, sc, SF.query_shards(forest.state, q[:64], qids[:64],
                                                  forest.layout, forest.query_kw(**QUERY_KW)),
                "above_neg_inf")
    kern["K1_block"] = k1_check(calls[K1][0], sync, median_ms, "shard 0's block query")
    (tier, q_low, table_i, blk_start, bs), kw2 = calls[K2][0]
    check(not kw2, f"unexpected K2 call on sharded_8m: {kw2}")
    kern["K2"] = block_kernel_check(tier, q_low, table_i, blk_start, bs, sync, median_ms)
    out["block"]["leg_s"] = time.perf_counter() - t_leg
    del forest, calls, tier, q_low, table_i, blk_start

    # ---- 3. the sharded flat engine, grouped: K4, K2b ---------------------
    t_leg = time.perf_counter()
    flat, fit_s = fit_timed(lambda: SFL.ShardedFlatIndex(mesh).fit(batch))
    out["flat"] = {"fit_s": fit_s, "nloc": flat.state.nloc,
                   "select_mode": FL._resolve_select_mode(
                       "auto", torch.int8, flat.state.nloc,
                       flat.state.shards[0].sketch.shape[1]),
                   "single_device": {k: single["flat_8m"].get(k) for k in ("recall_at_10", "qps")}}
    got, sc, calls = sharded_leg(
        out, "flat", lambda: flat.query_device(q, k=10, query_ids=qids), (K4, K2B),
        ((FL, (K4, K2B)),), nq, gt_ids, ids, sync)
    out["flat"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    check(out["flat"]["recall_at_10"] >= SHARDED_RECALL_MIN,
          f"sharded flat recall@10 {out['flat']['recall_at_10']} is below {SHARDED_RECALL_MIN}")
    merge_check("flat", got, sc, SFL.query_flat_shards(
        flat.state, q[:64], qids[:64], k=10, refine=flat.refine, block=flat.block,
        exclude_self=True, mode=flat.mode, r_groups=flat.r_groups), "finite")
    fk = flat_kernels(calls[K4][0], calls[K2B][0], sync, median_ms, "sharded_8m's flat shard 0")
    kern["K4"], kern["K2b_flat"] = fk["K4_int8"], fk["K2b"]
    out["flat"]["leg_s"] = time.perf_counter() - t_leg
    del flat, calls, fk

    # ---- 4. the sharded IVF engine at ivf_8m's headline point: K2b --------
    t_leg = time.perf_counter()
    ivf, fit_s = fit_timed(lambda: SI.ShardedIVFIndex(
        mesh, target_cluster=256, iters=6, seed=0, refine=128, nprobe=2, win=128).fit(batch))
    wb = SI.ivf_window_budget_sharded(ivf.state, 2, 128)
    out["ivf"] = {"fit_s": fit_s, "k_clusters": int(ivf.state.centroids.shape[0]), "wb": wb,
                  "nprobe": 2, "win": 128,
                  "single_device": {
                      "recall_at_10": single["ivf_8m"].get("points", {}).get(
                          "headline", {}).get("recall_at_10"),
                      "qps": single["ivf_8m"].get("points", {}).get("headline", {}).get("qps"),
                      "build_s": single["ivf_8m"].get("build_s")}}
    got, sc, calls = sharded_leg(
        out, "ivf", lambda: ivf.query_device(q, k=10, query_ids=qids), (K2B,),
        ((IVF, (K2B,)),), nq, gt_ids, ids, sync)
    out["ivf"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    check(out["ivf"]["recall_at_10"] >= SHARDED_RECALL_MIN,
          f"sharded IVF recall@10 {out['ivf']['recall_at_10']} is below {SHARDED_RECALL_MIN}")
    merge_check("ivf", got, sc, SI.query_ivf_shards(
        ivf.state, q[:64], qids[:64], k=10, nprobe=2, win=128, wb=wb, refine=128), "finite")
    args, kw2 = calls[K2B][0]
    check(not kw2, f"unexpected K2b call on the sharded IVF path: {kw2}")
    kern["K2b_ivf"] = window_check(args, sync, median_ms, "sharded_8m's IVF shard 0")
    out["ivf"]["leg_s"] = time.perf_counter() - t_leg
    del ivf, calls, args
    torch.cuda.empty_cache()

    for rec in kern.values():
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    out["kernels"] = kern
    # ---- 5. two processes, four shards each, on this card -----------------
    out["two_process"] = two_process_leg(x8, ids, dev, sync)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def two_proc_engines(mesh, x_local, ids_local, q, qids, fit, sync):
    """The three engines of the two-process leg, fitted by `fit` (the
    one-process or the multi-process functions) over rows this process
    holds: the forest at the bench config (block mode), the flat engine
    (grouped), IVF at ivf_8m's headline point. → {engine: (ids, fit s,
    query s, launches)}."""
    import torch

    from similaritysearchbyrdf_tpu_torch import DenseBatch
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI

    conf = timing.bench_config().replace(vector_dim=x_local.shape[1])
    res = {}

    def run(name, build, query):
        sync()
        t0 = time.perf_counter()
        index = build()
        sync()
        t1 = time.perf_counter()
        reset_launches()
        got, _ = query(index)
        sync()
        res[name] = (got.cpu().numpy(), t1 - t0, time.perf_counter() - t1,
                     {k: v for k, v in read_launches().items() if v})
        del index
        torch.cuda.empty_cache()

    def forest():
        f = SF.ShardedRDFForest(conf, mesh)
        f.state = fit["forest"](conf, DenseBatch(ids_local, x_local), mesh)[0]
        return f

    def flat():
        f = SFL.ShardedFlatIndex(mesh)
        f.state = fit["flat"](x_local, ids_local, mesh)[0]
        return f

    def ivf():
        f = SI.ShardedIVFIndex(mesh, target_cluster=256, iters=6, seed=0, refine=128, nprobe=2,
                               win=128)
        f.state = fit["ivf"](x_local, ids_local, mesh, target_cluster=256, iters=6, seed=0)[0]
        return f

    run("forest", forest, lambda f: f.query_device(q, query_ids=qids, **QUERY_KW))
    run("flat", flat, lambda f: f.query_device(q, k=10, query_ids=qids))
    run("ivf", ivf, lambda f: f.query_device(q, k=10, query_ids=qids))
    return res


def two_process_leg(x8, ids, dev, sync) -> dict:
    """Two ranks on this card over gloo, 4 of the 8 shards each: each
    regenerates the corpus from its seed and fits the forest, flat and IVF
    engines on its own half of the first TWO_PROC_ROWS rows
    (`fit_*_distributed`); meanwhile this process fits the same rows on one
    8-shard mesh. Every rank's ids must equal this process's bit for bit
    (`tests/test_torch_multihost.py`'s contract)."""
    import os
    import tempfile

    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh

    rows = TWO_PROC_ROWS
    tmp = tempfile.mkdtemp(prefix="rdf_two_proc_")
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"), "--rank",
                               str(r), "--port", str(port), "--out", tmp, "--rows", str(rows)],
                              cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    logs = ["", ""]
    try:
        import torch

        mesh = make_forest_mesh(devices=[dev] * 8)
        ref = two_proc_engines(mesh, x8[:rows], torch.as_tensor(ids[:rows], device=dev),
                               x8[:1024], torch.as_tensor(ids[:1024], device=dev),
                               {"forest": SF.fit_sharded, "flat": SFL.fit_flat_sharded,
                                "ivf": SI.fit_ivf_sharded}, sync)
        ref_s = time.perf_counter() - t0
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    out = {"rows": rows, "ranks": 2, "shards_per_rank": 4, "backend": "gloo",
           "cuts": [f"the first {rows:,} of {x8.shape[0]:,} rows"],
           "device": str(dev), "wall_s": wall_s, "one_process_s": ref_s,
           "one_process": {k: {"fit_s": v[1], "query_s": v[2], "launches": v[3]}
                           for k, v in ref.items()}, "ranks_info": []}
    for r, p in enumerate(procs):
        res = os.path.join(tmp, f"rank{r}")
        check(os.path.exists(res + ".npz") and os.path.exists(res + ".json"),
              f"two-process leg: rank {r} exited {p.returncode} without its results:\n"
              f"{logs[r][-3000:]}")
        with np.load(res + ".npz") as z:
            got = {k: z[k] for k in z.files}
        with open(res + ".json") as f:
            info = json.load(f)
        # the collective probe runs after the results: its own outcome only
        info["exit_code"] = p.returncode
        if p.returncode:
            info["log_tail"] = logs[r][-1000:]
        if os.path.exists(res + "_probe.json"):
            with open(res + "_probe.json") as f:
                info["gloo_cuda_collectives"] = json.load(f)
        for name, (want, *_) in ref.items():
            same = bool(np.array_equal(got[name], want))
            check(same, f"two-process leg: rank {r}'s {name} ids differ from the one-process "
                        f"8-shard fit's ({int((got[name] != want).sum())} entries)")
        out["ranks_info"].append(info)
    out["ids_equal_bit_for_bit"] = True
    return out


def rank_worker(argv) -> int:
    """One rank of the two-process leg: `chip_smoke.py --rank R --port P
    --out DIR --rows N`. Joins a 2-rank gloo group on localhost, holds 4
    shards on cuda:0, regenerates the corpus and its ids from their seeds,
    keeps its half of the first N rows, fits and queries the three engines
    through the multi-process fits, writes its ids and a record, then finds
    which gloo collectives carry CUDA tensors."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    args = dict(zip(argv[0::2], argv[1::2]))
    rank, port, out, rows = (int(args["--rank"]), int(args["--port"]), args["--out"],
                             int(args["--rows"]))
    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 2
    from similaritysearchbyrdf_tpu_torch.ops.kernels import build
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_flat as SFL
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
    from similaritysearchbyrdf_tpu_torch.parallel import sharded_ivf as SI
    from similaritysearchbyrdf_tpu_torch.parallel.mesh import init_distributed, make_forest_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    init_distributed(f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    mesh = make_forest_mesh(devices=[dev] * 4)
    check(mesh.n_shards == 8 and mesh.first_shard == 4 * rank, f"rank {rank}: wrong mesh")
    t1 = time.perf_counter()
    x = deep_corpus(8_000_000, rows=rows)
    ids = sharded_ids(8_000_000)
    gen_s = time.perf_counter() - t1
    half = rows // 2
    lo, hi = rank * half, (rank + 1) * half
    x_local = torch.as_tensor(x[lo:hi], device=dev)
    q = torch.as_tensor(x[:1024], device=dev)
    qids = torch.as_tensor(ids[:1024], device=dev)
    ids_local = torch.as_tensor(ids[lo:hi], device=dev)
    del x
    res = two_proc_engines(mesh, x_local, ids_local, q, qids,
                           {"forest": SF.fit_sharded_distributed,
                            "flat": SFL.fit_flat_sharded_distributed,
                            "ivf": SI.fit_ivf_sharded_distributed},
                           lambda: torch.cuda.synchronize(dev))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **{k: v[0] for k, v in res.items()})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rows": hi - lo, "corpus_gen_s": gen_s, "join_s": t1 - t0,
                   "engines": {k: {"fit_s": v[1], "query_s": v[2], "launches": v[3]}
                               for k, v in res.items()}}, f)
    # which collectives gloo serves on CUDA tensors, and with the right
    # values: each op's own refusal is recorded
    base = torch.arange(8, dtype=torch.int64, device=dev)
    t = base + rank
    pair = torch.cat([base, base + 1])

    def scattered(k):            # rank `rank`'s part of `k` split in two
        return k[4 * rank:4 * rank + 4]

    def run_all_reduce():
        o = t.clone()
        return dist.all_reduce(o, async_op=True), lambda: o, 2 * base + 1

    def run_all_gather():
        o = [torch.empty_like(t) for _ in range(2)]
        return dist.all_gather(o, t, async_op=True), lambda: torch.cat(o), pair

    def run_all_gather_into_tensor():
        o = torch.empty(16, dtype=t.dtype, device=dev)
        return dist.all_gather_into_tensor(o, t, async_op=True), lambda: o, pair

    def run_broadcast():
        o = t.clone()
        return dist.broadcast(o, 0, async_op=True), lambda: o, base

    def run_reduce():
        o = t.clone()
        return dist.reduce(o, 0, async_op=True), lambda: o, 2 * base + 1 if rank == 0 else None

    def run_reduce_scatter_tensor():
        o = torch.empty(4, dtype=t.dtype, device=dev)
        return dist.reduce_scatter_tensor(o, t, async_op=True), lambda: o, scattered(2 * base + 1)

    def run_all_to_all_single():
        o = torch.empty_like(t)
        return (dist.all_to_all_single(o, t, async_op=True), lambda: o,
                torch.cat([scattered(base), scattered(base + 1)]))

    def run_gather():
        o = [torch.empty_like(t) for _ in range(2)] if rank == 0 else None
        return (dist.gather(t, o, 0, async_op=True), lambda: o and torch.cat(o),
                pair if rank == 0 else None)

    def run_scatter():
        o = torch.empty_like(t)
        src = [base * 10, base * 20] if rank == 0 else None
        return dist.scatter(o, src, 0, async_op=True), lambda: o, base * (10 + 10 * rank)

    probes = {}
    for name, op in (("all_reduce", run_all_reduce), ("all_gather", run_all_gather),
                     ("all_gather_into_tensor", run_all_gather_into_tensor),
                     ("broadcast", run_broadcast), ("reduce", run_reduce),
                     ("reduce_scatter_tensor", run_reduce_scatter_tensor),
                     ("all_to_all_single", run_all_to_all_single), ("gather", run_gather),
                     ("scatter", run_scatter)):
        try:
            work, got, want = op()
            work.wait(timeout=timedelta(seconds=30))
            probes[name] = ("ok" if want is None or torch.equal(got(), want)
                            else "served, wrong values")
        except Exception as e:                      # the backend's refusal, recorded
            probes[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    with open(os.path.join(out, f"rank{rank}_probe.json"), "w") as f:
        json.dump(probes, f)
    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_worker(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    from bench import make_data
    from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFForest
    from similaritysearchbyrdf_tpu_torch.index import forest as F
    from similaritysearchbyrdf_tpu_torch.ops.exact import exact_search
    from similaritysearchbyrdf_tpu_torch.ops.kernels import build
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_fold as K3
    from similaritysearchbyrdf_tpu_torch.ops.kernels import coarse_gather as K2
    from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel as K1
    from similaritysearchbyrdf_tpu_torch.ops.kernels import timing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)

    def sync():
        torch.cuda.synchronize(dev)

    def median_ms(fn, reps=20, warm=3):
        return timing.median_event_ms(fn, reps, warm)

    conf = timing.bench_config()
    x = make_data(seed=42)
    n = x.shape[0]
    ids = np.arange(n, dtype=np.int32)
    xd = torch.as_tensor(x, device=dev)
    qd = xd[:N_QUERY]
    qids = ids[:N_QUERY]

    # ---- phase 1: kernels against their plain versions --------------------
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    if build.last_build_log:
        print(build.last_build_log, file=sys.stderr, flush=True)

    forest = RDFForest(conf, device=dev).fit(DenseBatch(ids, xd))
    model = forest.state.model
    xb = xd[:1024].contiguous()
    k1 = hash_check(xb, model.proj, model.perm, True, sync, median_ms, "the bench query")
    # the fit's shape: chunks of fit_batch_size rows, no margins
    xf = xd[:conf.fit_batch_size].contiguous()
    k1_fit = kernel_times(lambda: K1.hash_dense_kernel(xf, model.proj, model.perm))
    k1_fit_plain_ms = median_ms(lambda: K1.hash_dense_plain(xf, model.proj, model.perm))

    # K2 on the real query path's blocks (B 1024, MB 512, bs 8) and tier
    k2 = block_kernel_check(*timing.block_operands(forest, xb), sync, median_ms)
    # K2 on bf16 tiers: the bench corpus fitted with coarse_dtype="bfloat16"
    # (cs 32), and with coarse_dim 100 as well (the identity basis, cs 128)
    k2_bf16 = {}
    for name, kw in (("cs32", {}), ("cs128", dict(coarse_dim=100))):
        fb = RDFForest(conf.replace(coarse_dtype="bfloat16", **kw), device=dev).fit(
            DenseBatch(ids, xd))
        check(fb.state.coarse_tier.dtype == torch.bfloat16, "the bf16 fit made no bf16 tier")
        k2_bf16[name] = block_kernel_check(*timing.block_operands(fb, xb), sync, median_ms)
        del fb
    emit({"phase": "kernels", "build_s": build_s,
          "K1": {**k1, "fit_shape_B": xf.shape[0], "fit_ms": k1_fit["ms"],
                 "fit_device_ms": k1_fit["device_ms"], "fit_plain_ms": k1_fit_plain_ms},
          "K2": k2, "K2_bf16_tier": k2_bf16})

    # ---- phase 2: the bench config, end to end ------------------------------
    gt, _ = exact_search(x, x[:N_QUERY], 10, exclude_self=True, device=dev)
    reset_launches()
    forest = RDFForest(conf, device=dev).fit(DenseBatch(ids, xd))
    got, scores = forest.query_device(qd, query_ids=qids, **QUERY_KW)
    sync()
    launches = {"hash_dense_kernel": K1.LAUNCHES, "coarse_block_scores_kernel": K2.LAUNCHES}
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    got_np = got.cpu().numpy()
    check(got_np.shape == (N_QUERY, 10) and bool(torch.isfinite(scores).all()),
          "query output has the wrong shape or non-finite scores")
    recall = recall_at(gt, got_np)
    check(abs(recall - JAX_CPU_RECALL) <= RECALL_TOL,
          f"recall@10 {recall} is not within {RECALL_TOL} of the JAX package's "
          f"{JAX_CPU_RECALL}")
    # the port's CPU path (the kernels' plain versions) on the same inputs
    cpu_forest = RDFForest(conf, device="cpu").fit(DenseBatch(ids, x))
    cpu_ids, _ = cpu_forest.query(x[:128], query_ids=qids[:128], **QUERY_KW)
    cpu_agree = float((cpu_ids == got_np[:128]).all(axis=1).mean())
    check(cpu_agree >= 0.99, f"GPU and CPU paths agree on only {cpu_agree} of queries")
    # the same in window mode (K2b and its plain version), reported by window_1m
    win_kw = dict(QUERY_KW, coarse_window=64, m_cap=32768)
    win_gpu, _ = forest.query(x[:128], query_ids=qids[:128], **win_kw)
    win_cpu, _ = cpu_forest.query(x[:128], query_ids=qids[:128], **win_kw)
    win_cpu_agree = float((win_cpu == win_gpu).all(axis=1).mean())
    check(win_cpu_agree >= 0.99,
          f"window mode: GPU and CPU paths agree on only {win_cpu_agree} of queries")

    nb_pad = forest.state.tables.bucket_keys.shape[1]
    fit_s = float("inf")
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        st = F.fit_dense(conf, DenseBatch(ids, xd), model=forest.model,
                         part_proj=forest.part_proj, nb_pad=nb_pad)
        sync()
        fit_s = min(fit_s, time.perf_counter() - t0)
    del st
    q_times = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        forest.query_device(qd, query_ids=qids, **QUERY_KW)
        sync()
        q_times.append(time.perf_counter() - t0)
    q_s = float(np.median(q_times[1:]))
    tier = forest.state.coarse_tier
    emit({"phase": "bench_20k", "n": n, "queries": N_QUERY, "recall_at_10": recall,
          "jax_cpu_recall_at_10": JAX_CPU_RECALL, "cpu_path_agreement": cpu_agree,
          "launches": launches, "qps": N_QUERY / q_s, "query_s": q_s,
          "build_vectors_per_sec": n / fit_s, "build_s": fit_s,
          "index_bytes_per_vector": forest.index_bytes_per_vector(),
          "coarse_tier_bytes_per_vector": tier.numel() * tier.element_size() / n})

    # ---- the flat engine on the bench corpus ---------------------------------
    flat_20k_phase(x, gt, dev, sync, median_ms)

    # ---- phase 3: a deployment-size corpus ----------------------------------
    del forest, cpu_forest
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    n_big = 1_000_000
    t0 = time.perf_counter()
    xl = clustered(n_big, 100, 20_000, 0.05)
    gen_s = time.perf_counter() - t0
    ids_l = np.arange(n_big, dtype=np.int32)
    xl_d = torch.as_tensor(xl, device=dev)
    gt_l, _ = exact_search(xl_d, xl[:N_QUERY], 10, exclude_self=True, device=dev)
    # a head tier for window_1m's pruning; block mode does not read it
    conf_l = conf.replace(coarse_head_pool=64)
    big = RDFForest(conf_l, device=dev).fit(DenseBatch(ids_l, xl_d))
    sync()
    t0 = time.perf_counter()
    big.fit(DenseBatch(ids_l, xl_d))
    sync()
    fit_l = time.perf_counter() - t0
    ql = xl_d[:N_QUERY]
    big.query_device(ql, query_ids=ids_l[:N_QUERY], **QUERY_KW)
    sync()
    t0 = time.perf_counter()
    got_l, sc_l = big.query_device(ql, query_ids=ids_l[:N_QUERY], **QUERY_KW)
    sync()
    q_l = time.perf_counter() - t0
    got_l = got_l.cpu().numpy()
    check(got_l.shape == (N_QUERY, 10) and bool(torch.isfinite(sc_l).all()),
          "1M query output has the wrong shape or non-finite scores")
    st = big.state
    recall_l = recall_at(gt_l, got_l)
    emit({"phase": "deploy_1m", "n": n_big, "dim": 100, "queries": N_QUERY,
          "corpus_gen_s": gen_s, "recall_at_10": recall_l,
          "qps": N_QUERY / q_l, "build_vectors_per_sec": n_big / fit_l, "build_s": fit_l,
          "index_bytes_per_vector": big.index_bytes_per_vector(),
          "corpus_bytes": st.corpus.numel() * 4,
          "coarse_tier_bytes": st.coarse_tier.numel(),
          "table_bytes": st.tables.index_bytes(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})

    # ---- phases 4 and 5: window mode on the 1M forest -----------------------
    k2b = window_kernel_phase(big, xl_d[:128].contiguous(), sync, median_ms)
    win = window_phase(big, conf_l, ql, ids_l[:N_QUERY], gt_l, recall_l, win_cpu_agree, sync)

    # ---- phases 12-14: the front ends, the mutable index, persistence at 1M ---
    del st
    torch.cuda.empty_cache()
    frontend_phase(big, conf_l, xl, xl_d, gt_l, sync, median_ms)
    dynamic_phase(big, conf_l, xl_d, sync, median_ms)

    # ---- phase 14: persistence at 1M ------------------------------------------
    persist = persist_phase(big, conf_l, xl, xl_d, gt_l, recall_l, sync, median_ms)
    del big, xl, ql
    torch.cuda.empty_cache()

    # ---- phase 10: the forest's last three options on the same 1M corpus -----
    options_phase(conf, xl_d, gt_l, recall_l, win["keep_0"]["recall_at_10"], sync, median_ms)
    del xl_d
    torch.cuda.empty_cache()

    # ---- phase 6: the folded tier on an 8M corpus ----------------------------
    k3, tk, launches_f, x8, gt8 = folded_phase(dev, sync, median_ms)
    torch.cuda.empty_cache()

    # ---- phases 8 and 9: the flat engine on the same 8M corpus ---------------
    k4, launches_flat, flat_bf16 = flat_8m_phase(x8, gt8, dev, sync, median_ms)
    torch.cuda.empty_cache()

    # ---- phase 11: the IVF engine on the same 8M corpus ----------------------
    ivf = ivf_phase(x8, gt8, sync, median_ms)
    torch.cuda.empty_cache()

    # ---- phase 16: the sharded engines on the same 8M corpus, 8 shards --------
    sharded = sharded_phase(x8, gt8, dev, sync, median_ms)
    del x8
    torch.cuda.empty_cache()

    # ---- phase 15: the sparse path at 1M x 4096 --------------------------------
    sparse = sparse_phase(dev, sync, median_ms)
    k4p = k4["int8_packed"]

    def at_sparse(rec, launches):
        """A kernel record of another path (its form, times and bound), with
        its launches on the call that gave its operands."""
        return {"shape": rec["shape"], "form": rec["form"], "launches": launches,
                **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "product_ms",
                                        "bound_ms", "bound_by", "max_abs_err") if k in rec}}

    sk_calls = sparse["calls"]
    tkf = ivf["TK_f32"]
    lib = {"library_ms": None}     # no single PyTorch call computes any of these functions
    # each kernel's launches on sharded_8m's four query paths
    sh_launches = {}
    for leg in ("folded", "block", "flat", "ivf"):
        for name, v in sharded[leg]["launches"].items():
            sh_launches[name] = sh_launches.get(name, 0) + v

    emit({"kernels": [
        {"name": "hash_dense_kernel", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("hash_dense_kernel", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/hash_kernel.cu",
         "replaces": "similaritysearchbyrdf_tpu/ops/pallas/hash_kernel.py:103",
         "launches": launches["hash_dense_kernel"], "max_abs_err": k1["max_margin_err"],
         "ms": k1["ms"], "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], **lib,
         "form": K1.kernel_form(x.shape[1]),
         "sparse_1m_fit": at_sparse(sparse["kernels"]["K1_fit"],
                                    sk_calls["fit"]["launches"]["hash_dense_kernel"]),
         "sparse_1m_query": at_sparse(sparse["kernels"]["K1_query"],
                                      sk_calls["steps0_rf2048"]["launches"]["hash_dense_kernel"])},
        {"name": "coarse_block_scores_kernel", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("coarse_block_scores_kernel", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/coarse_gather.cu",
         "replaces": "similaritysearchbyrdf_tpu/ops/pallas/coarse_gather.py:107",
         "launches": launches["coarse_block_scores_kernel"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "device_ms": k2["device_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], **lib, "form": k2["form"],
         "sparse_1m": at_sparse(
             sparse["kernels"]["K2"],
             sk_calls["steps0_rf2048"]["launches"]["coarse_block_scores_kernel"])},
        {"name": "coarse_window_scores_kernel", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("coarse_window_scores_kernel", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/coarse_gather.cu",
         "replaces": "similaritysearchbyrdf_tpu/ops/pallas/coarse_gather.py:544,569,590,626,647",
         "launches": win["launches"]["coarse_window_scores_kernel"],
         "max_abs_err": k2b["max_abs_err"], "ms": k2b["ms"],
         "device_ms": k2b["device_ms"], "plain_ms": k2b["plain_ms"],
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"], **lib, "form": k2b["form"],
         "sparse_1m": at_sparse(sparse["kernels"]["K2b"],
                                sk_calls["flat"]["launches"]["coarse_window_scores_kernel"]),
         "sparse_1m_sharded_shard0": at_sparse(
             sparse["sharded"]["kernels"]["K2b"],
             sk_calls["sharded_flat"]["launches"]["coarse_window_scores_kernel"]),
         "persist_1m_ivf": at_sparse(
             persist["kernels"]["K2b_ivf"],
             persist["calls"]["loaded ivf query"]["launches"]["coarse_window_scores_kernel"]),
         **{f"ivf_8m_{name}": at_sparse(pt["K2b"], pt["launches"]["coarse_window_scores_kernel"])
            for name, pt in ivf["points"].items()},
         "sharded_8m_flat_shard0": at_sparse(
             sharded["kernels"]["K2b_flat"],
             sharded["flat"]["launches"]["coarse_window_scores_kernel"]),
         "sharded_8m_ivf_shard0": at_sparse(
             sharded["kernels"]["K2b_ivf"],
             sharded["ivf"]["launches"]["coarse_window_scores_kernel"]),
         "flat_8m_bf16": at_sparse(flat_bf16["kernels"]["K2b"],
                                   flat_bf16["launches"]["coarse_window_scores_kernel"])},
        {"name": "coarse_rowmax_kernel", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("coarse_rowmax_kernel", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/coarse_fold.cu",
         "replaces": "similaritysearchbyrdf_tpu/ops/pallas/coarse_fold.py:253",
         "launches": launches_f["coarse_rowmax_kernel"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "device_ms": k3["device_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], **lib},
        {"name": "topk_select", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("topk_select", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/topk_select.cu",
         "replaces": "torch.sort prefixes of the folded query's selects (no TPU kernel)",
         "launches": launches_f["topk_select"],
         **{k: tk["group_select"][k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                                "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
         "stage2": {k: tk["stage2"][k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                                 "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}},
        {"name": "topk_select_f32", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("topk_select_f32", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/topk_select.cu",
         "replaces": "stable torch.sort prefixes of ops/rerank.top_sorted (no TPU kernel)",
         "launches": ivf["points"]["headline"]["launches"].get("topk_select_f32", 0),
         **{k: tkf["centroids"][k] for k in TK_F32_KEYS},
         "windows": {k: tkf["windows"][k] for k in TK_F32_KEYS}},
        {"name": "flat_groupmax_kernel", "route": "cuda",
         "sharded_8m_launches": sh_launches.get("flat_groupmax_kernel", 0),
         "source": "similaritysearchbyrdf_tpu_torch/csrc/flat_groupmax.cu",
         "replaces": "similaritysearchbyrdf_tpu/ops/pallas/flat_groupmax.py:191,247,401",
         "launches": launches_flat["flat_groupmax_kernel"], "max_abs_err": k4p["max_abs_err"],
         "ms": k4p["ms"], "device_ms": k4p["device_ms"], "plain_ms": k4p["plain_ms"],
         "bound_ms": k4p["bound_ms"],
         "bound_by": k4p["bound_by"], **lib, "form": k4p["form"],
         "sparse_1m": at_sparse(sparse["kernels"]["K4"],
                                sk_calls["flat"]["launches"]["flat_groupmax_kernel"]),
         "flat_8m_bf16": at_sparse(flat_bf16["kernels"]["K4_bf16"],
                                   flat_bf16["launches"]["flat_groupmax_kernel"])},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
