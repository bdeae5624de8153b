"""Experiment and evaluation harness: the reference's experiment suites as a
library.

Counterpart of `similaritysearchbyrdf_tpu/experiments/harness.py`. The
reference runs experiments as ScalaTest suites that print timings and
precision (`src/test/scala/mclab/Experiments/*`); each becomes a function
returning structured results:

  recall_per_step_sweep     <- `TestSingleRDFSuite.scala:103-122`
  per_query_latency         <- `TestSingleRDFSuite.scala:144-170`
  best_partition_search     <- `PartitionDistributionSuite.scala:76-166`
  gt_hamming_analysis       <- `AnalysisGroundTruthSuite.scala:60-100`
  best_hash_family_search   <- `BestHashFamilySuite.scala:10-39`

plus the exact ground truth, recall, error ratio and the recall-time curve.
Times are host-clock seconds around work that ends in a synchronise of the
forest's device. Functions without a forest run on `device` (default: the
first CUDA card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RDFConfig
from ..index.forest import RDFForest, query_dense, query_dense_many
from ..index.partitioner import (generate_partition_projections, partition_of_hash,
                                 save_partition_file)
from ..models.families import Device, generate_model, resolve_device
from ..ops.bitops import popcount
from ..ops.exact import exact_search
from ..ops.hashing import hash_dense
from ..utils.timing import synchronize
from ..vectors import DenseBatch


def exact_ground_truth(corpus, queries, k: int, exclude_self: bool = True,
                       device: Device = None) -> np.ndarray:
    """Exact inner-product top-k row indices i32[Q, k] (how the reference's
    ground-truth files were made offline). With `exclude_self` and no more
    queries than rows, query i skips row i. Ties go to the lower row, as
    the JAX package's `lax.top_k` gives them (`ops/exact`'s stable
    selection)."""
    self_mask = exclude_self and len(queries) <= len(corpus)
    ids, _ = exact_search(corpus, queries, k, exclude_self=self_mask, device=device)
    return ids.astype(np.int32)


def recall_at_k(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    hits = 0
    for i in range(gt.shape[0]):
        hits += len(set(gt[i].tolist()) & set(int(v) for v in ids[i] if v >= 0))
    return hits / (gt.shape[0] * k)


def error_ratio(found_scores: np.ndarray, gt_scores: np.ndarray) -> float:
    """Mean ratio of the returned neighbours' similarities to the true top-k
    similarities, rank by rank (1.0 = exact; `Vectors.KNNFromPython`,
    `Vector.scala:266-275`). A missing result (-inf) counts as 0."""
    fs = np.asarray(found_scores, dtype=np.float64)
    gs = np.asarray(gt_scores, dtype=np.float64)
    ratios = np.where(np.isfinite(fs) & (np.abs(gs) > 1e-12), fs / gs, 0.0)
    return float(np.clip(ratios, 0.0, None).mean())


def equal_up_to_ties(g_ids: np.ndarray, g_sc: np.ndarray, c_ids: np.ndarray,
                     c_sc: np.ndarray, tol: float) -> bool:
    """One query's top-k from two summation orders (say the card's kernels
    and their plain versions): the scores agree position by position within
    `tol`, and where the ids differ, the row one side ranks at a position
    sits on the other side at a score within `tol` of it (two near-tied rows
    in swapped order), or, absent there, within `tol` of the other side's
    last score (a near-tie at the cut)."""
    if not (np.abs(g_sc - c_sc) <= tol).all():
        return False
    for j in np.flatnonzero(g_ids != c_ids):
        pos = np.flatnonzero(c_ids == g_ids[j])
        other = c_sc[pos[0]] if pos.size else c_sc[-1]
        if abs(other - g_sc[j]) > tol:
            return False
    return True


@dataclasses.dataclass
class StepSweepResult:
    steps: int
    recall: float
    qps: float
    mean_candidates: float


def recall_per_step_sweep(forest: RDFForest, queries: np.ndarray, gt: np.ndarray,
                          steps_list: Sequence[int] = (0, 1, 2),
                          query_ids: Optional[np.ndarray] = None) -> List[StepSweepResult]:
    """Recall, qps and mean candidates per step count
    (`TestSingleRDFSuite.scala:103-122`). Candidates are counted by
    `query_dense` on the first query batch, no query excluded; the mean is
    taken in f32, as the JAX package's."""
    dev = forest.device
    conf = forest.conf
    b = min(len(queries), conf.query_batch_size)
    qb = torch.as_tensor(queries[:b], dtype=torch.float32).to(dev)
    out = []
    for steps in steps_list:
        synchronize(dev)
        t0 = time.perf_counter()
        ids, _ = forest.query(queries, steps=steps, query_ids=query_ids)
        dt = time.perf_counter() - t0
        _, _, ncand = query_dense(forest.state, qb,
                                  torch.full((b,), -1, dtype=torch.int32, device=dev),
                                  forest.layout, steps=steps, m_cap=conf.max_candidates,
                                  k=conf.top_k)
        out.append(StepSweepResult(steps=steps, recall=recall_at_k(ids, gt),
                                   qps=len(queries) / dt,
                                   mean_candidates=float(ncand.to(torch.float32).mean())))
    return out


def per_query_latency(forest: RDFForest, queries: np.ndarray, steps: int = 0,
                      repeats: int = 3) -> Dict[str, float]:
    """Mean per-query latency at the configured batch size
    (`TestSingleRDFSuite.scala:144-170`), after one warm-up query."""
    dev = forest.device
    forest.query(queries[:1], steps=steps)
    qd = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        forest.query_device(qd, steps=steps)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / repeats
    return {"total_s": dt, "per_query_ms": dt * 1000.0 / len(queries), "qps": len(queries) / dt}


def _same_partition_share(pc: torch.Tensor, pq: torch.Tensor, gt: torch.Tensor) -> float:
    """Share of (query, neighbour, table) triples whose neighbour lies in
    the query's partition, as an exact count over the triples."""
    same = pc[gt] == pq[:, None, :]
    return int(same.sum()) / same.numel()


def best_partition_search(conf: RDFConfig, corpus: np.ndarray, queries: np.ndarray,
                          gt: np.ndarray, n_candidates: int = 50, seed0: int = 0,
                          out_path: Optional[str] = None, device: Device = None
                          ) -> Tuple[int, np.ndarray]:
    """The partition chains (among `n_candidates` seeds) that put most
    ground-truth neighbours in their query's home partition, averaged over
    tables (`PartitionDistributionSuite.scala:76-166`) → (best seed, the
    candidates' scores). With `out_path`, the winner is written in the
    reference's partition checkpoint format, loadable through
    `conf.partition_family_file_path`."""
    dev = resolve_device(device)
    model = generate_model(conf, device=dev)
    hq = hash_dense(model, torch.as_tensor(queries, dtype=torch.float32).to(dev))
    hc = hash_dense(model, torch.as_tensor(corpus, dtype=torch.float32).to(dev))
    gt_d = torch.from_numpy(np.array(gt, dtype=np.int64)).to(dev)
    scores = np.zeros(n_candidates)
    for c in range(n_candidates):
        pp = generate_partition_projections(conf, seed=seed0 + 7717 * (c + 1), device=dev)
        scores[c] = _same_partition_share(partition_of_hash(hc, pp), partition_of_hash(hq, pp),
                                          gt_d)
    best_seed = seed0 + 7717 * (int(np.argmax(scores)) + 1)
    if out_path is not None:
        save_partition_file(generate_partition_projections(conf, seed=best_seed, device=dev),
                            out_path)
    return best_seed, scores


def gt_hamming_analysis(conf: RDFConfig, corpus: np.ndarray, queries: np.ndarray,
                        gt: np.ndarray, device: Device = None) -> Dict[str, float]:
    """Mean Hamming distance between query hashes and their ground-truth
    neighbours' against random pairs (`AnalysisGroundTruthSuite.scala:
    60-100`): whether a hash family is locality sensitive on a dataset. The
    random pairs are the JAX package's draw (`default_rng(0)`)."""
    dev = resolve_device(device)
    model = generate_model(conf, device=dev)
    hq = hash_dense(model, torch.as_tensor(queries, dtype=torch.float32).to(dev))
    hc = hash_dense(model, torch.as_tensor(corpus, dtype=torch.float32).to(dev))
    rand_idx = np.random.default_rng(0).integers(0, corpus.shape[0], size=gt.shape)

    def mean_hamming(idx: np.ndarray) -> float:
        rows = torch.from_numpy(np.array(idx, dtype=np.int64)).to(dev)
        d = popcount(hq[:, None, :] ^ hc[rows])
        return int(d.sum(dtype=torch.int64)) / d.numel()

    gt_h, rand_h = mean_hamming(gt), mean_hamming(rand_idx)
    return {"gt_mean_hamming": gt_h, "random_mean_hamming": rand_h,
            "separation": rand_h - gt_h}


def recall_time_curve(forest: RDFForest, queries: np.ndarray, gt: np.ndarray,
                      configs: Optional[Sequence[dict]] = None,
                      query_ids: Optional[np.ndarray] = None, reps: int = 3) -> List[dict]:
    """Recall@k against time: the DPF paper's Fig. 5 (time per 1,000
    queries vs recall). Each config is a dict of `RDFForest.query` keywords
    (steps, multiprobe, probe_mode, probe_budget, m_cap, coarse_refine) →
    one point per config: {config, qps, time_s_per_1000, recall}, timed over
    `reps` whole-set queries with the queries on the device, after a warm
    call."""
    if configs is None:
        configs = [
            {"steps": 0, "multiprobe": False},
            {"steps": 0, "probe_mode": "margin", "probe_budget": 4},
            {"steps": 0, "probe_mode": "margin", "probe_budget": 8},
            {"steps": 0},
            {"steps": 1},
            {"steps": 2},
        ]
    dev = forest.device
    conf = forest.conf
    nq = len(queries)
    qd = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    qid_d = (torch.as_tensor(query_ids, dtype=torch.int32).to(dev) if query_ids is not None
             else torch.full((nq,), -1, dtype=torch.int32, device=dev))
    points = []
    for cfg in configs:
        kw = dict(
            steps=cfg.get("steps", 0), m_cap=cfg.get("m_cap", conf.max_candidates),
            k=conf.top_k, multiprobe=cfg.get("multiprobe", True),
            exclude_self=query_ids is not None,
            probe_mode=cfg.get("probe_mode", "reference"),
            probe_budget=cfg.get("probe_budget", 8),
            coarse_refine=cfg.get("coarse_refine", conf.coarse_refine),
            coarse_window=conf.coarse_window,
        )
        ids_d, _, _ = query_dense_many(forest.state, qd, qid_d, forest.layout,
                                       chunk=conf.query_batch_size, **kw)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            query_dense_many(forest.state, qd, qid_d, forest.layout,
                             chunk=conf.query_batch_size, **kw)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / reps
        points.append({"config": dict(cfg), "qps": nq / dt, "time_s_per_1000": dt * 1000.0 / nq,
                       "recall": recall_at_k(ids_d.cpu().numpy(), gt)})
    return points


def best_hash_family_search(conf: RDFConfig, corpus_batch: DenseBatch, queries: np.ndarray,
                            gt: np.ndarray, restarts: int = 10, steps: int = 0,
                            device: Device = None) -> Tuple[RDFForest, float, List[float]]:
    """The best of `restarts` hash families by recall
    (`BestHashFamilySuite.scala:10-39`: 10 restarts, keep the best); the
    kept family exports with `models.families.save_model_file`."""
    dev = resolve_device(device)
    best_forest, best_recall, history = None, -1.0, []
    for r in range(restarts):
        forest = RDFForest(conf, seed=conf.seed + 1013 * r, device=dev).fit(corpus_batch)
        ids, _ = forest.query(queries, steps=steps)
        rec = recall_at_k(ids, gt)
        history.append(rec)
        if rec > best_recall:
            best_forest, best_recall = forest, rec
    return best_forest, best_recall, history
