"""The port's folded forest against the benchmark's plain folded reference.

`RDFForest` at the `dpf_deep96_folded` configuration (folded int8 tier,
K3 row maxima, packed group select, staged rerank), cut to a few thousand
rows of the configuration's own `hard_clustered` data with windows and
caps scaled to fit, answers every query with the ids of
`benchmark/reference/forest_folded.py` (torch and numpy, nothing of the
port): at steps 0 and 1, stage2 on and off, groups of 8 and 16 slots, and
at a cap wide enough for the group select's quantized values to tie. A
reference with a planted fault answers otherwise."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.engines import dpf_folded
from benchmark.lib import data
from benchmark.lib.runner import _deep_update
from benchmark.reference import forest_folded

ROOT = Path(__file__).resolve().parents[1]
BASE = json.loads((ROOT / "benchmark/configs/dpf_deep96_folded.json").read_text())
# 4,000 rows: buckets of at most 64 rows, 16 windows of 512 slots, 1,024
# slots to stage2's 32 ids (stage2 of the full size keeps 4,096 of 14,336)
TINY = {"rows": 4000, "queries": 64,
        "index": {"max_candidates": 8192, "coarse_refine": 1024, "coarse_stage2": 32,
                  "lsh_table": {"chain_length": 32, "bucket_overflow": 64}}}
# 128 windows and 512 slots kept: 8,192 groups, whose values the select
# quantizes to their top 19 bits, so groups tie at its cut
WIDE = {"rows": 6000, "index": {"max_candidates": 65536, "coarse_refine": 512,
                                "coarse_stage2": 0}, "query": {"steps": 1}}
SEED = 2**35 + 11
# both sides rerank the same rows with f32 products; the sums may run in
# another order, a few ulps of a score below 1
SCORE_ATOL = 1e-6


def config(*overs):
    cfg = _deep_update(BASE, TINY)
    for over in overs:
        cfg = _deep_update(cfg, over)
    return cfg


def port_answers(cfg, x, q):
    torch.set_num_threads(4)
    forest = dpf_folded.build(cfg, "cpu")
    dpf_folded.fit(forest, x)
    return dpf_folded.query(forest, cfg, q.numpy())


def case(steps, stage2, group):
    return config({"index": {"coarse_stage2": stage2, "coarse_group": group},
                   "query": {"steps": steps}})


@pytest.mark.parametrize("group", [8, 16])
@pytest.mark.parametrize("stage2", [0, 32])
@pytest.mark.parametrize("steps", [0, 1])
def test_port_equals_reference(steps, stage2, group):
    cfg = case(steps, stage2, group)
    x, q = data.make(cfg, SEED, "cpu")
    ids, scores = port_answers(cfg, x, q)
    ref_ids, ref_scores = forest_folded.answers(cfg, x, q, cfg["k"])
    assert np.array_equal(ids, ref_ids.numpy())
    np.testing.assert_allclose(scores, ref_scores.numpy(), rtol=0, atol=SCORE_ATOL)
    assert (ids >= 0).all()


def test_port_equals_reference_where_groups_tie():
    cfg = config(WIDE)
    x, q = data.make(cfg, SEED, "cpu")
    ids, _ = port_answers(cfg, x, q)
    ref_ids, _ = forest_folded.answers(cfg, x, q, cfg["k"])
    assert np.array_equal(ids, ref_ids.numpy())


class Stage2Skipped(forest_folded.FoldedForest):
    @staticmethod
    def _stage2(cand, sc, keep):
        return cand


class TiesReversed(forest_folded.FoldedForest):
    @staticmethod
    def _select(qv, m):
        return torch.sort(qv, dim=1, descending=True, stable=True)[1][:, :m]


@pytest.mark.parametrize("fault,over", [(Stage2Skipped, {"query": {"steps": 1}}),
                                        (TiesReversed, WIDE)])
def test_a_planted_fault_answers_otherwise(fault, over):
    cfg = config(over)
    x, q = data.make(cfg, SEED, "cpu")
    ids, _ = port_answers(cfg, x, q)
    broken = fault(cfg, x.device, forest_folded.Precision()).fit(x)
    bad_ids, _ = broken.query(q, cfg["k"])
    assert not np.array_equal(ids, bad_ids.numpy())
