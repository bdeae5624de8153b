"""The quantized-flat engine's tracing spans.

One profiled `FlatIndex.query` opens one `rdf.query`, one `rdf.chunk` per
query batch and in each `rdf.score`, `rdf.select` and `rdf.rerank` once,
in that order, on each route (exact2, argpack, the scan), and its host
waits in `rdf.sync.upload` and `rdf.sync.answers`; its ids and scores
equal an untraced call's bit for bit. Where the argpack select takes its
two levels, each chunk's `rdf.select` holds one `rdf.sgtier` (K4's emitted
supergroup tier read in place of a reduce). An `IVFFlatIndex.query`, which calls
the flat engine's exact refine inside its own `rdf.rerank`, still opens
exactly one `rdf.rerank` per chunk."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from similaritysearchbyrdf_tpu_torch import DenseBatch, FlatIndex, IVFFlatIndex
from similaritysearchbyrdf_tpu_torch.ops import flat as flat_mod
from test_torch_spans import inside
from test_torch_spans import chrome_spans as all_spans

N, D, NQ, BATCH = 3000, 32, 80, 32
CHUNKS = -(-NQ // BATCH)
STAGES = ["rdf.score", "rdf.select", "rdf.rerank"]


def chrome_spans(prof, tmp_path):
    """The profiler's `rdf.*` spans, by start time."""
    return [e for e in all_spans(prof, tmp_path) if e["name"].startswith("rdf.")]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(40, D))
    x = centers[rng.integers(0, 40, N)] + 0.1 * rng.normal(size=(N, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return DenseBatch(np.arange(N, dtype=np.int32), x), x[rng.integers(0, N, NQ)] + np.float32(0.01)


@pytest.fixture(params=["exact2", "argpack", "scan"])
def flat_call(request, corpus, monkeypatch):
    batch, q = corpus
    if request.param == "argpack":
        monkeypatch.setattr(flat_mod, "_ARGPACK_MIN_ROWS", 1)
    mode = "scan" if request.param == "scan" else "grouped"
    index = FlatIndex(query_batch=BATCH, mode=mode, device="cpu").fit(batch)
    return lambda: index.query(q, k=10)


def test_a_profiled_flat_query_opens_its_spans(flat_call, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flat_call()
    spans = chrome_spans(prof, tmp_path)
    names = [e["name"] for e in spans]
    roots = [e for e in spans if e["name"] == "rdf.query"]
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    assert len(roots) == 1 and len(chunks) == CHUNKS
    assert all(inside(e, roots[0]) for e in spans)
    for c in chunks:
        stages = [e for e in spans if e["name"] in STAGES and inside(e, c)]
        assert [e["name"] for e in stages] == STAGES
        for a, b in zip(stages, stages[1:]):
            assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]) + 1e-3
    assert {n: names.count(n) for n in names if n.startswith("rdf.sync.")} == \
        {"rdf.sync.upload": 1, "rdf.sync.answers": 2}
    for i, a in enumerate(spans):
        assert not any(b["name"] == a["name"] and inside(b, a) for b in spans[i + 1:]), a


def test_profiled_flat_answers_equal_untraced(flat_call):
    ids, scores = flat_call()
    with profile(activities=[ProfilerActivity.CPU]):
        ids_t, scores_t = flat_call()
    assert np.array_equal(ids, ids_t)
    assert np.array_equal(scores.view(np.uint32), scores_t.view(np.uint32))


@pytest.fixture
def sgtier_index(monkeypatch):
    """An argpack index whose select takes two levels: 70,000 rows are NG
    1,152 groups, 36 supergroups of 32 >= 2 x refine 16."""
    rng = np.random.default_rng(9)
    n = 70_000
    x = rng.normal(size=(n, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    monkeypatch.setattr(flat_mod, "_ARGPACK_MIN_ROWS", 1)
    index = FlatIndex(refine=16, query_batch=BATCH, device="cpu").fit(
        DenseBatch(np.arange(n, dtype=np.int32), x))
    return index, x[rng.integers(0, n, NQ)] + np.float32(0.01)


def test_a_profiled_argpack_query_opens_sgtier_in_select(sgtier_index, tmp_path):
    index, q = sgtier_index
    ids, scores = index.query(q, k=10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids_t, scores_t = index.query(q, k=10)
    spans = chrome_spans(prof, tmp_path)
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    selects = [e for e in spans if e["name"] == "rdf.select"]
    tiers = [e for e in spans if e["name"] == "rdf.sgtier"]
    assert len(chunks) == len(selects) == len(tiers) == CHUNKS
    for c in chunks:
        sel = [s for s in selects if inside(s, c)]
        assert len(sel) == 1 and sum(inside(t, sel[0]) for t in tiers) == 1
    assert np.array_equal(ids, ids_t)
    assert np.array_equal(scores.view(np.uint32), scores_t.view(np.uint32))


def test_ivf_opens_one_rerank_a_chunk(corpus, tmp_path):
    batch, q = corpus
    ivf = IVFFlatIndex(target_cluster=64, nprobe=4, win=64, iters=3, query_batch=BATCH,
                       device="cpu").fit(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ivf.query(q, k=10)
    spans = chrome_spans(prof, tmp_path)
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    reranks = [e for e in spans if e["name"] == "rdf.rerank"]
    assert len(chunks) == CHUNKS and len(reranks) == CHUNKS
    assert all(sum(inside(r, c) for r in reranks) == 1 for c in chunks)
