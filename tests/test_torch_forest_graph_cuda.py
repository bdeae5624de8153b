"""The forest's chunk graphs on the card, at the dpf_glove100 benchmark's index
settings on a small corpus: a replayed chunk's ids, scores and candidate
counts equal the eager form's (`_query_chunk` with no chain) bit for bit
(with window pruning too), each key captures once, a partial last chunk
stays eager, a refit captures anew, and a traced call
attributes the replayed kernels to `rdf.candidates`; a folded tier at the
dpf_deep96_folded benchmark's settings replays bit-equal to its eager path
too, and its traced candidates hold the replays. Needs an NVIDIA GPU;
run on the card without the suite's conftest, which imports jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_forest_graph_cuda.py
"""

import gc
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig
from similaritysearchbyrdf_tpu_torch.index import chunk_graphs
from similaritysearchbyrdf_tpu_torch.index import forest as F
from similaritysearchbyrdf_tpu_torch.ops.kernels import hash_kernel


pytestmark = pytest.mark.cuda
CHUNK = 128
QUERY = dict(steps=0, probe_mode="margin", probe_budget=16)
KW = dict(m_cap=65536, k=10, coarse_refine=1024, coarse_window=-1, **QUERY)


def captured(owner):
    """How many keys of `owner` hold captured graphs."""
    return sum(g is not None for g in chunk_graphs._OWNERS.get(id(owner), {}).values())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def corpus(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(512, 100))
    x = centers[rng.integers(0, 512, n)] + 0.3 * rng.normal(size=(n, 100))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return DenseBatch(np.arange(n, dtype=np.int32), x), x[rng.integers(0, n, 8 * CHUNK)]


def fitted(dev, seed=1):
    batch, q = corpus(100_000, seed)
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     generate_by_pulling=True, is_orthogonal=True, partition_bits=3,
                     fit_batch_size=8192, query_batch_size=CHUNK, max_candidates=65536,
                     top_k=10, seed=31258, coarse_dim=32, coarse_dtype="int8",
                     coarse_refine=1024, coarse_window=-1,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=500))
    return RDFForest(conf, device=dev).fit(batch), torch.as_tensor(q, device=dev)


@pytest.fixture
def counted(monkeypatch):
    """The captures made, one entry each."""
    made = []
    real = F.ChainGraphs

    def capture(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(F, "ChainGraphs", capture)
    return made


def no_ids(n, dev):
    return torch.full((n,), -1, dtype=torch.int32, device=dev)


def eager(st, q, qi, layout, **kw):
    """The chunk query with every stage eager: `_query_chunk` with no chain."""
    o = F.QueryOptions(**kw)
    return F._query_chunk(st, q, qi, layout, o, F._coarse_plan(st, o), None)


def assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_replayed_chunks_equal_the_eager_path(dev, counted):
    forest, q = fitted(dev)
    st, qi = forest.state, no_ids(CHUNK, dev)
    chunks = [q[c:c + CHUNK] for c in range(0, 5 * CHUNK, CHUNK)]
    for i, c in enumerate(chunks + chunks[:1]):
        got = F.query_dense(st, c, qi, forest.layout, **KW)
        want = eager(st, c, qi, forest.layout, **KW)
        assert_same(got, want)
        assert len(counted) == (0 if i == 0 else 1)
    assert captured(st) == 1
    # a replayed chunk counts its K1 launch, as an eager one does
    before = hash_kernel.LAUNCHES
    F.query_dense(st, chunks[3], qi, forest.layout, **KW)
    assert hash_kernel.LAUNCHES == before + 1
    # the candidate counts outlive the chunk: a later replay leaves them
    total = F.query_dense(st, chunks[1], qi, forest.layout, **KW)[2]
    keep = total.clone()
    F.query_dense(st, chunks[2], qi, forest.layout, **KW)
    assert torch.equal(total, keep)


def test_pruned_windows_replay_equal_the_eager_path(dev, counted):
    batch, q = corpus(100_000, 3)
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     partition_bits=3, query_batch_size=CHUNK, max_candidates=65536, top_k=10,
                     seed=31258, coarse_dim=32, coarse_dtype="int8", coarse_refine=1024,
                     coarse_window=-1, coarse_head_pool=16, coarse_keep=256,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=500))
    forest = RDFForest(conf, device=dev).fit(batch)
    q = torch.as_tensor(q, device=dev)
    kw = dict(KW, window_keep=256, head_pool=16)
    for c in range(0, 4 * CHUNK, CHUNK):
        got = F.query_dense(forest.state, q[c:c + CHUNK], no_ids(CHUNK, dev), forest.layout, **kw)
        want = eager(forest.state, q[c:c + CHUNK], no_ids(CHUNK, dev), forest.layout, **kw)
        assert_same(got, want)
    assert len(counted) == 1


def test_each_key_captures_once_and_a_partial_chunk_stays_eager(dev, counted):
    forest, q = fitted(dev)
    st = forest.state
    q = q[:2 * CHUNK + 37]
    want = [eager(st, q[c:c + CHUNK], no_ids(q[c:c + CHUNK].shape[0], dev), forest.layout,
                  exclude_self=False, **KW)
            for c in range(0, q.shape[0], CHUNK)]
    for _ in range(3):
        ids, scores = forest.query_device(q, k=10, **QUERY)
        assert_same((ids, scores), [torch.cat([w[i] for w in want]) for i in range(2)])
    assert len(counted) == 1 and captured(st) == 1
    assert all(key[2][0] == CHUNK for key in chunk_graphs._OWNERS[id(st)])
    # another probe budget is another key: eager once, then its own capture
    for i in range(3):
        forest.query_device(q[:CHUNK], k=10, **{**QUERY, "probe_budget": 8})
        assert len(counted) == (1 if i == 0 else 2)


def test_a_refit_captures_anew(dev, counted):
    forest, q = fitted(dev)
    for _ in range(2):
        forest.query_device(q[:CHUNK], k=10, **QUERY)
    old = id(forest.state)
    batch, _ = corpus(60_000, 7)
    forest.fit(batch)
    gc.collect()
    assert old not in chunk_graphs._OWNERS and captured(forest.state) == 0
    want = eager(forest.state, q[:CHUNK], no_ids(CHUNK, dev), forest.layout,
                 exclude_self=False, **KW)
    for i in range(3):
        got = forest.query_device(q[:CHUNK], k=10, **QUERY)
        assert_same(got, want[:2])
        assert len(counted) == (1 if i == 0 else 2)
    assert counted[1] is not counted[0] and captured(forest.state) == 1


def test_a_traced_call_reads_the_replayed_kernels(dev, tmp_path):
    from benchmark.lib import cell, trace

    forest, q = fitted(dev)
    host_q = q.cpu().numpy()
    for _ in range(2):
        forest.query(host_q, k=10, **QUERY)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.SLICE):
            forest.query(host_q, k=10, **QUERY)
            torch.cuda.synchronize(dev)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window = trace.slice_range(events)
    ctx = types.SimpleNamespace(trace={"events": events, "window": window,
                                       "queries": host_q.shape[0], "records": {}})
    assert cell.reader("candidates_graph_share.batch").read(ctx) == 1.0
    replay_us = trace.range_device_us(events, "rdf.graph.replay", window)
    cand_us = cell.reader("candidates_us_per_query").read(ctx)
    launches = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")]
    print(f"\ngraph launches {len(launches)}, device us under the replays {replay_us:.1f}, "
          f"candidates us/query {cand_us:.3f}")
    assert replay_us > 0 and cand_us is not None
    assert cand_us * host_q.shape[0] > replay_us


FOLDED_KW = dict(steps=1, probe_mode="margin", probe_budget=16, m_cap=262_144, k=10,
                 coarse_refine=14_336, coarse_window=512, coarse_group=8, rows_keep=0,
                 stage2=4_096)


def folded_fitted(dev):
    """A folded tier at the dpf_deep96_folded benchmark's settings (cs 16,
    group 8, windows of 512, rows_keep 0, stage2 4,096 of 14,336, steps 1)."""
    batch, q = corpus(200_000, 5)
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     generate_by_pulling=True, is_orthogonal=True, partition_bits=3,
                     fit_batch_size=8192, query_batch_size=CHUNK, max_candidates=262_144,
                     top_k=10, seed=31258, coarse_dim=16, coarse_dtype="int8",
                     coarse_layout="folded", coarse_window=512, coarse_group=8,
                     coarse_rows_keep=0, coarse_refine=14_336, coarse_stage2=4_096,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=2000))
    return RDFForest(conf, device=dev).fit(batch), torch.as_tensor(q, device=dev)


def test_folded_chunks_replay_equal_the_eager_path(dev, counted, tmp_path):
    from benchmark.lib import cell, trace
    from similaritysearchbyrdf_tpu_torch.ops.kernels import topk_select

    forest, q = folded_fitted(dev)
    st, qi = forest.state, no_ids(CHUNK, dev)
    chunks = [q[c:c + CHUNK] for c in range(0, 4 * CHUNK, CHUNK)]
    for i, c in enumerate(chunks + chunks[:1]):
        before = topk_select.launches(topk_select.KEY_KINDS)
        got = F.query_dense(st, c, qi, forest.layout, **FOLDED_KW)
        assert topk_select.launches(topk_select.KEY_KINDS) == before + 2   # group select, stage2
        want = eager(st, c, qi, forest.layout, **FOLDED_KW)
        assert_same(got, want)
        assert len(counted) == (0 if i == 0 else 1)
    assert captured(st) == 1
    # a traced call reads the replayed hash and candidates in their spans
    query = {n: FOLDED_KW[n] for n in ("steps", "probe_mode", "probe_budget")}
    host_q = q[:4 * CHUNK].cpu().numpy()
    forest.query(host_q, k=10, **query)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.SLICE):
            forest.query(host_q, k=10, **query)
            torch.cuda.synchronize(dev)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window = trace.slice_range(events)
    ctx = types.SimpleNamespace(trace={"events": events, "window": window,
                                       "queries": host_q.shape[0], "records": {}})
    replay_us = trace.range_device_us(events, "rdf.graph.replay", window)
    cand_us = cell.reader("fold_candidates_us_per_query").read(ctx)
    print(f"\nfolded: device us under the replays {replay_us:.1f}, "
          f"candidates us/query {cand_us:.3f}")
    assert replay_us > 0 and cand_us is not None
    assert cand_us * host_q.shape[0] > replay_us
