"""The port's tracing spans: on exactly while a torch.profiler session records.

Outside a profiler a span is the one shared null context and records
nothing. Under one it is a `record_function` range, a `user_annotation`
in the Chrome trace, nested in the spans open on its thread. One profiled
call of each benchmarked query path (`RDFForest.query` in window mode,
`IVFFlatIndex.query`) opens one `rdf.query`, one `rdf.chunk` per query
batch, the stage spans in order, and every `rdf.sync.<site>` span of its
host waits; its ids and scores equal an untraced call's bit for bit."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from similaritysearchbyrdf_tpu_torch import DenseBatch, IVFFlatIndex, RDFConfig, RDFForest
from similaritysearchbyrdf_tpu_torch.config import TableConfig
from similaritysearchbyrdf_tpu_torch.index import forest as forest_mod
from similaritysearchbyrdf_tpu_torch.utils import timing

N, D, NQ, BATCH = 3000, 32, 80, 32
CHUNKS = -(-NQ // BATCH)
STAGES = {"forest": ["rdf.hash", "rdf.candidates", "rdf.score", "rdf.select", "rdf.rerank"],
          "ivf": ["rdf.candidates", "rdf.score", "rdf.select", "rdf.rerank"]}
# each host wait a warm call makes: the upload (the IVF window budget's two
# offset copies a call), two answers; a cold forest call adds one fill of
# each probe constant (`forest.probe_constants`)
SYNCS = {"forest": {"rdf.sync.upload": 1, "rdf.sync.answers": 2},
         "ivf": {"rdf.sync.upload": 1, "rdf.sync.window_budget": 2, "rdf.sync.answers": 2}}
COLD = {"rdf.sync.patterns": 1, "rdf.sync.priority": 1}


def chrome_spans(prof, tmp_path):
    """The profiler's `user_annotation` events, by start time."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda e: (float(e["ts"]), -float(e["dur"])))


def inside(child, parent):
    t0, t1 = float(parent["ts"]), float(parent["ts"]) + float(parent["dur"])
    return (child["tid"] == parent["tid"] and t0 <= float(child["ts"])
            and float(child["ts"]) + float(child["dur"]) <= t1 + 1e-3)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(40, D))
    x = centers[rng.integers(0, 40, N)] + 0.1 * rng.normal(size=(N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(N, dtype=np.int32), x)
    conf = RDFConfig(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                     partition_bits=3, query_batch_size=BATCH, max_candidates=4096, top_k=10,
                     seed=91, coarse_dim=16, coarse_dtype="int8", coarse_refine=256,
                     coarse_window=64,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=64))
    forest = RDFForest(conf, device="cpu").fit(batch)
    ivf = IVFFlatIndex(target_cluster=64, nprobe=4, win=64, iters=3, query_batch=BATCH,
                       device="cpu").fit(batch)
    calls = {"forest": lambda q: forest.query(q, k=10, probe_mode="margin", probe_budget=8),
             "ivf": lambda q: ivf.query(q, k=10)}
    return calls, x[rng.integers(0, N, NQ)] + np.float32(0.01)


def test_span_off_is_the_shared_null_context(monkeypatch):
    def no_range(name):
        raise AssertionError("a span off opened a record_function range")

    monkeypatch.setattr(timing, "record_function", no_range)
    tr = timing.Tracer()
    assert tr.span("a") is timing.NULL_SPAN and timing.span("rdf.query") is timing.NULL_SPAN
    with tr.span("a"):
        with tr.span("b"):
            pass
    assert tr.spans == {} and tr.summary() == []


def test_span_off_records_nothing_in_a_query(engines):
    calls, q = engines
    timing.default_tracer.reset()
    for call in calls.values():
        call(q)
    assert timing.default_tracer.summary() == []


def test_span_is_a_user_annotation_inside_its_parent(tmp_path):
    tr = timing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(4) + 1
    inner = [e for e in prof.events() if e.name == "inner"]
    assert len(inner) == 1 and inner[0].cpu_parent.name == "outer"
    spans = {e["name"]: e for e in chrome_spans(prof, tmp_path)}
    assert inside(spans["inner"], spans["outer"])
    assert set(tr.spans) == {"outer", "outer/inner"}


def profiled_syncs(call, q, tmp_path):
    """The `rdf.sync.<site>` span counts of one profiled call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(q)
    names = [e["name"] for e in chrome_spans(prof, tmp_path)]
    return {n: names.count(n) for n in names if n.startswith("rdf.sync.")}


@pytest.mark.parametrize("engine", ["forest", "ivf"])
def test_a_profiled_query_opens_its_spans(engine, engines, tmp_path):
    calls, q = engines
    calls[engine](q)                        # warm: the forest's probe constants are cached
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls[engine](q)
    spans = [e for e in chrome_spans(prof, tmp_path) if e["name"].startswith("rdf.")]
    names = [e["name"] for e in spans]
    roots = [e for e in spans if e["name"] == "rdf.query"]
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    assert len(roots) == 1 and len(chunks) == CHUNKS
    assert all(inside(e, roots[0]) for e in spans)
    for c in chunks:
        stages = [e["name"] for e in spans
                  if e["name"] in STAGES[engine] and inside(e, c)]
        assert stages == STAGES[engine]
    syncs = {n: names.count(n) for n in names if n.startswith("rdf.sync.")}
    assert syncs == SYNCS[engine]
    for i, a in enumerate(spans):
        assert not any(b["name"] == a["name"] and inside(b, a) for b in spans[i + 1:]), a


def test_a_cold_forest_call_fills_each_probe_constant_once(engines, tmp_path, monkeypatch):
    calls, q = engines
    monkeypatch.setattr(forest_mod, "_PROBE_CONSTANTS", {})
    assert profiled_syncs(calls["forest"], q, tmp_path) == {**SYNCS["forest"], **COLD}
    assert profiled_syncs(calls["forest"], q, tmp_path) == SYNCS["forest"]


@pytest.mark.parametrize("engine", ["forest", "ivf"])
def test_profiled_answers_equal_untraced(engine, engines):
    calls, q = engines
    ids, scores = calls[engine](q)
    with profile(activities=[ProfilerActivity.CPU]):
        ids_t, scores_t = calls[engine](q)
    assert np.array_equal(ids, ids_t)
    assert np.array_equal(scores.view(np.uint32), scores_t.view(np.uint32))


FOLDED = ["rdf.hash", "rdf.candidates", "rdf.score", "rdf.select", "rdf.stage2", "rdf.rerank"]


@pytest.fixture(scope="module")
def folded():
    """A forest on its folded tier (K3's plain version, the packed group
    select) and a query call taking `stage2`."""
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(40, D))
    x = centers[rng.integers(0, 40, N)] + 0.1 * rng.normal(size=(N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    conf = RDFConfig(vector_dim=D, table_num=4, permutation_num=2, family_size=40,
                     partition_bits=3, query_batch_size=BATCH, max_candidates=4096, top_k=10,
                     seed=92, coarse_dim=16, coarse_dtype="int8", coarse_layout="folded",
                     coarse_window=128, coarse_group=8, coarse_rows_keep=0, coarse_refine=256,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=64))
    forest = RDFForest(conf, device="cpu").fit(DenseBatch(np.arange(N, dtype=np.int32), x))

    def call(q, stage2):
        return forest.query(q, k=10, steps=1, probe_mode="margin", probe_budget=8,
                            stage2=stage2)

    return call, x[rng.integers(0, N, NQ)] + np.float32(0.01)


@pytest.mark.parametrize("stage2", [64, 0])
def test_a_profiled_folded_query_opens_its_stage_spans(stage2, folded, tmp_path):
    """Each chunk opens the folded stages once, in order and disjoint;
    `rdf.stage2` only with the staged rerank; the call's waits are the
    lane path's."""
    call, q = folded
    call(q, stage2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(q, stage2)
    spans = [e for e in chrome_spans(prof, tmp_path) if e["name"].startswith("rdf.")]
    names = [e["name"] for e in spans]
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    want = [n for n in FOLDED if stage2 or n != "rdf.stage2"]
    assert len(chunks) == CHUNKS
    for c in chunks:
        stages = [e for e in spans if e["name"] in FOLDED and inside(e, c)]
        assert [e["name"] for e in stages] == want
        for a, b in zip(stages, stages[1:]):
            assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]) + 1e-3
    assert names.count("rdf.stage2") == (CHUNKS if stage2 else 0)
    syncs = {n: names.count(n) for n in names if n.startswith("rdf.sync.")}
    assert syncs == SYNCS["forest"]


def test_profiled_folded_answers_equal_untraced(folded):
    call, q = folded
    ids, scores = call(q, 64)
    with profile(activities=[ProfilerActivity.CPU]):
        ids_t, scores_t = call(q, 64)
    assert np.array_equal(ids, ids_t)
    assert np.array_equal(scores.view(np.uint32), scores_t.view(np.uint32))
