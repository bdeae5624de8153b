"""Port vs JAX package: the experiment harness and the tracing spans.

Every harness function on the JAX package's own small config
(tests/test_experiments.py) and the same seeded corpus: equal ground-truth
ids, best seeds, concentration scores, Hamming means, histories and
recalls; times are only checked to be positive."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import similaritysearchbyrdf_tpu.config as jcfg
import similaritysearchbyrdf_tpu_torch.config as tcfg
from similaritysearchbyrdf_tpu.experiments import harness as jh
from similaritysearchbyrdf_tpu.index.forest import RDFForest as JForest
from similaritysearchbyrdf_tpu.vectors import DenseBatch as JBatch
from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFForest, query_dense
from similaritysearchbyrdf_tpu_torch.experiments import harness as th
from similaritysearchbyrdf_tpu_torch.index.partitioner import load_partition_file
from similaritysearchbyrdf_tpu_torch.models.families import load_model_file, save_model_file
from similaritysearchbyrdf_tpu_torch.utils import timing


def confs(**kw):
    base = dict(vector_dim=16, table_num=3, permutation_num=2, family_size=24,
                partition_bits=2, query_batch_size=16, max_candidates=2048, top_k=5,
                seed=31)
    base.update(kw)
    return (jcfg.RDFConfig(**base, lsh_table=jcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)),
            tcfg.RDFConfig(**base, lsh_table=tcfg.TableConfig(chain_length=10,
                                                              bucket_overflow=32)))


def data(seed, n=600, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(15, d))
    x = centers[rng.integers(0, 15, n)] + 0.08 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    jc, tc = confs()
    x = data(0)
    ids = np.arange(len(x), dtype=np.int32)
    jf = JForest(jc).fit(JBatch(ids, x))
    tf = RDFForest(tc, device="cpu").fit(DenseBatch(ids, x))
    gt = jh.exact_ground_truth(x, x[:32], 5)
    return jc, tc, x, ids, jf, tf, gt


@pytest.mark.parametrize("exclude_self", [True, False])
def test_exact_ground_truth_matches_jax(exclude_self):
    x = data(1)
    x[7] = x[3]                                   # an exact tie: the lower row first
    got = th.exact_ground_truth(x, x[:40], 10, exclude_self=exclude_self, device="cpu")
    want = np.asarray(jh.exact_ground_truth(x, x[:40], 10, exclude_self=exclude_self))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    more = th.exact_ground_truth(x[:20], x[:30], 5, device="cpu")     # Q > N: no mask
    assert np.array_equal(more, np.asarray(jh.exact_ground_truth(x[:20], x[:30], 5)))


def test_recall_and_error_ratio_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.integers(0, 50, size=(8, 5))
    ids = np.where(rng.random((8, 5)) < 0.2, -1, rng.integers(0, 50, size=(8, 5)))
    assert th.recall_at_k(ids, gt) == jh.recall_at_k(ids, gt)
    fs = rng.normal(size=(8, 5))
    fs[0, 0] = -np.inf
    gs = rng.normal(size=(8, 5))
    assert th.error_ratio(fs, gs) == jh.error_ratio(fs, gs)


_TIE_IDS = np.array([4, 9, 2, 7])
_TIE_SC = np.array([0.9, 0.8, 0.8, 0.5])


@pytest.mark.parametrize("ids, sc, want", [
    (_TIE_IDS, _TIE_SC, True),                                     # identical
    (np.array([4, 2, 9, 7]), _TIE_SC + [0, 1e-7, -1e-7, 0], True),   # a tie swapped
    (np.array([4, 9, 2, 8]), np.array([0.9, 0.8, 0.8, 0.5 + 1e-7]), True),  # a tie at the cut
    (np.array([4, 9, 7, 2]), _TIE_SC, False),                      # swapped across 0.3
    (np.array([4, 9, 2, 8]), np.array([0.9, 0.8, 0.8, 0.6]), False),  # a score apart
])
def test_equal_up_to_ties(ids, sc, want):
    """The tie rule the card tests and the smoke compare top-k lists by: ids
    may differ only between rows whose scores are within `tol`."""
    assert th.equal_up_to_ties(ids, sc, _TIE_IDS, _TIE_SC, 1e-6) is want
    assert th.equal_up_to_ties(_TIE_IDS, _TIE_SC, ids, sc, 1e-6) is want


def test_recall_per_step_sweep_matches_jax(world):
    jc, tc, x, ids, jf, tf, gt = world
    got = th.recall_per_step_sweep(tf, x[:32], gt, steps_list=(0, 1, 2), query_ids=ids[:32])
    want = jh.recall_per_step_sweep(jf, x[:32], gt, steps_list=(0, 1, 2), query_ids=ids[:32])
    for g, w in zip(got, want):
        assert (g.steps, g.recall, g.mean_candidates) == (w.steps, w.recall, w.mean_candidates)
        assert g.qps > 0
    assert got[2].mean_candidates >= got[0].mean_candidates


def test_query_dense_is_the_query_core(world):
    jc, tc, x, ids, jf, tf, gt = world
    q = torch.from_numpy(x[:16])
    got, _, total = query_dense(tf.state, q, torch.from_numpy(ids[:16]), tf.layout, steps=1,
                                m_cap=2048, k=5)
    want, _ = tf.query(x[:16], steps=1, query_ids=ids[:16])
    assert np.array_equal(got.numpy(), want) and (total > 0).all()


def test_latency_and_recall_time_curve(world):
    jc, tc, x, ids, jf, tf, gt = world
    lat = th.per_query_latency(tf, x[:16], repeats=2)
    assert lat["qps"] > 0 and lat["per_query_ms"] > 0
    cfgs = [{"steps": 0, "multiprobe": False}, {"steps": 1},
            {"steps": 0, "probe_mode": "margin", "probe_budget": 4}]
    got = th.recall_time_curve(tf, x[:32], gt, configs=cfgs, query_ids=ids[:32], reps=1)
    want = jh.recall_time_curve(jf, x[:32], gt, configs=cfgs, query_ids=ids[:32], reps=1)
    assert [p["recall"] for p in got] == [p["recall"] for p in want]
    assert [p["config"] for p in got] == cfgs and all(p["qps"] > 0 for p in got)
    assert len(th.recall_time_curve(tf, x[:16], gt[:16], reps=1)) == 6


def test_best_partition_search_matches_jax(world, tmp_path):
    jc, tc, x, ids, jf, tf, gt = world
    path = str(tmp_path / "best-partition")
    seed, scores = th.best_partition_search(tc, x, x[:32], gt, n_candidates=4,
                                            out_path=path, device="cpu")
    want_seed, want_scores = jh.best_partition_search(jc, x, x[:32], gt, n_candidates=4)
    assert seed == want_seed and np.array_equal(scores, want_scores)
    loaded = load_partition_file(path, tc, device="cpu")
    fresh = RDFForest(tc, seed=seed, device="cpu").part_proj
    assert torch.equal(loaded, fresh)


def test_gt_hamming_analysis_matches_jax(world):
    jc, tc, x, ids, jf, tf, gt = world
    got = th.gt_hamming_analysis(tc, x, x[:32], gt, device="cpu")
    assert got == jh.gt_hamming_analysis(jc, x, x[:32], gt)
    assert got["separation"] > 0


def test_best_hash_family_search_matches_jax(world, tmp_path):
    jc, tc, x, ids, jf, tf, gt = world
    best, rec, hist = th.best_hash_family_search(tc, DenseBatch(ids, x), x[:32], gt,
                                                 restarts=3, device="cpu")
    _, want_rec, want_hist = jh.best_hash_family_search(jc, JBatch(ids, x), x[:32], gt,
                                                        restarts=3)
    assert hist == want_hist and rec == want_rec == max(hist)
    path = str(tmp_path / "best-family")
    save_model_file(best.model, path)
    assert torch.equal(load_model_file(path, tc, device="cpu").proj.reshape(-1, 16)[:10],
                       best.model.proj[0, best.model.perm[0, 0].long()])


def test_tracer_spans(tmp_path):
    """Spans record under a profiler, by '/'-joined nested name, and land
    in `torch_profile`'s trace as `user_annotation` ranges."""
    tr = timing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("a"):
            with tr.span("b"):
                pass
            with tr.span("b"):
                pass
    rows = {r[0]: r for r in tr.summary()}
    assert set(rows) == {"a", "a/b"} and rows["a/b"][1] == 2
    assert rows["a"][2] >= rows["a/b"][2]
    assert "total_ms" in tr.report()
    tr.reset()
    assert tr.summary() == []
    assert timing.span.__self__ is timing.default_tracer
    with timing.torch_profile(str(tmp_path / "trace")):
        with timing.span("rdf.query"):
            torch.ones(8) @ torch.ones(8)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "rdf.query" and e.get("cat") == "user_annotation"
               for e in events)


def test_a_failed_sync_raises(monkeypatch):
    """A failed synchronise raises through the span it is in, and a span
    that fails inside still records and unwinds its name."""
    def lost(device=None):
        raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(torch.cuda, "synchronize", lost)
    tr = timing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="device lost"):
            with tr.span("x"):
                timing.synchronize(torch.device("cuda"))
        with pytest.raises(ValueError):
            with tr.span("y"):
                with tr.span("z"):
                    raise ValueError
        with tr.span("w"):
            pass
    assert set(tr.spans) == {"x", "y", "y/z", "w"}
