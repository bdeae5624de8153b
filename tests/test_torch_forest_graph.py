"""The forest query's chunk graphs, on the CPU: the probe constants cached
per device equal the values the chunk used to build inline, the per-owner
bookkeeping of `index/chunk_graphs.py` captures on a key's second use only
and forgets an owner with it, a CPU query never captures, the chunk's chain
branch (driven by an eager stand-in for the graphs) answers and opens spans
as its eager form on the lane, pruned and folded tiers, and the config maps
to the query options as the forest and the sharded forest read it. The
graphs' own answers are held against the eager form on the card
(`test_torch_forest_graph_cuda.py`)."""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig
from similaritysearchbyrdf_tpu_torch.index import chunk_graphs
from similaritysearchbyrdf_tpu_torch.index import forest as F
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.index.partitioner import stepwise_patterns
from similaritysearchbyrdf_tpu_torch.parallel import sharded_forest as SF
from similaritysearchbyrdf_tpu_torch.parallel.mesh import make_forest_mesh


CONF = RDFConfig(vector_dim=24, table_num=4, permutation_num=2, family_size=40,
                 partition_bits=3, query_batch_size=16, max_candidates=32768, top_k=5,
                 seed=17, coarse_dim=16, coarse_dtype="int8", coarse_refine=128,
                 coarse_window=-1, lsh_table=TableConfig(chain_length=32, bucket_overflow=64))


def captured(owner):
    """How many keys of `owner` hold captured graphs."""
    return sum(g is not None for g in chunk_graphs._OWNERS.get(id(owner), {}).values())


def eager(st, q, qi, layout, **kw):
    """The chunk query with every stage eager: `_query_chunk` with no chain."""
    o = F.QueryOptions(**kw)
    return F._query_chunk(st, q, qi, layout, o, F._coarse_plan(st, o), None)


def fitted(conf, n=2000, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return RDFForest(conf, device="cpu").fit(DenseBatch(np.arange(n, dtype=np.int32), x)), x


def inline_constants(layout, steps, p, l, dev):
    """The chunk's constants as `probe_key_set` and `gather_blocks` built
    them inline before the cache."""
    patterns = torch.as_tensor(stepwise_patterns(layout.partition_bits, steps), device=dev)
    s = patterns.shape[0]
    dist = torch.as_tensor(
        [bin(int(x)).count("1") for x in stepwise_patterns(layout.partition_bits, steps)],
        device=dev)
    probe_rank = torch.roll(torch.arange(p, device=dev), -1)
    prio = (dist[:, None] * p + probe_rank[None, :]).reshape(-1).repeat(l)
    table_of = torch.arange(l, device=dev).repeat_interleave(s * p)
    return patterns, prio, table_of


@pytest.mark.parametrize("steps", [0, 1, 2])
@pytest.mark.parametrize("probe_mode", ["reference", "margin"])
def test_cached_constants_equal_the_inline_ones(steps, probe_mode, monkeypatch):
    monkeypatch.setattr(F, "_PROBE_CONSTANTS", {})
    layout = KeyLayout.from_config(CONF, CONF.lsh_table)
    l, dev = 8, torch.device("cpu")
    h = torch.randint(0, 2**32, (5, l), dtype=torch.int64)
    if probe_mode == "margin":
        margins = torch.rand((5, l, 32))
        probes, _ = F._probe_hashes_margin(h, margins, layout, 6)
    else:
        probes, _ = F._probe_hashes(h, layout, True)
    p = probes.shape[-1]
    got = F.probe_constants(dev, layout.partition_bits, steps, p, l)
    for a, b in zip(got, inline_constants(layout, steps, p, l, dev)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert F.probe_constants(dev, layout.partition_bits, steps, p, l) is got


class Owner:
    """A weak-referenceable stand-in for a forest state."""


def test_a_key_captures_on_its_second_use_only():
    owner, built = Owner(), []

    def build():
        built.append(object())
        return built[-1]

    assert chunk_graphs.chain_for(owner, ("a",), build) is None
    assert chunk_graphs.chain_for(owner, ("a",), build) is built[0]
    assert chunk_graphs.chain_for(owner, ("a",), build) is built[0]
    assert len(built) == 1 and captured(owner) == 1
    assert chunk_graphs.chain_for(owner, ("b",), build) is None
    assert len(built) == 1


def test_an_owner_keeps_at_most_max_keys_and_goes_with_its_graphs():
    owner = Owner()
    keys = [(i,) for i in range(chunk_graphs.MAX_KEYS + 2)]
    for _ in range(2):
        got = [chunk_graphs.chain_for(owner, k, object) for k in keys]
    assert all(g is not None for g in got[:chunk_graphs.MAX_KEYS])
    assert all(g is None for g in got[chunk_graphs.MAX_KEYS:])
    assert captured(owner) == chunk_graphs.MAX_KEYS
    ident = id(owner)
    del owner
    gc.collect()
    assert ident not in chunk_graphs._OWNERS


def test_a_cpu_query_never_captures():
    forest, x = fitted(CONF)
    q = x[:48] + np.float32(0.01)
    first = forest.query(q, probe_mode="margin", probe_budget=8)
    for _ in range(2):
        again = forest.query(q, probe_mode="margin", probe_budget=8)
        assert np.array_equal(first[0], again[0])
        assert np.array_equal(first[1].view(np.uint32), again[1].view(np.uint32))
    assert id(forest.state) not in chunk_graphs._OWNERS
    qd = torch.from_numpy(q[:16])
    qi = torch.full((16,), -1, dtype=torch.int32)
    kw = dict(m_cap=32768, k=5, probe_mode="margin", probe_budget=8, coarse_refine=128)
    for a, b in zip(F.query_dense(forest.state, qd, qi, forest.layout, **kw),
                    eager(forest.state, qd, qi, forest.layout, **kw)):
        assert torch.equal(a, b)


class EagerChain:
    """A stand-in for `ChainGraphs` whose two stages run eagerly, as its
    capture records them: the hash stage, then the lookup and flatten."""

    def __init__(self, st, layout, opts, plan):
        self.st, self.layout, self.opts, self.plan = st, layout, opts, plan

    def run_first(self, queries):
        self.first = F._hash_stage(self.st.model, self.layout, self.opts, queries)
        return self.first

    def run_second(self, home):
        h, probes, probe_valid = self.first
        o = self.opts
        return F.gather_blocks(self.st.tables, h, home, self.layout, o.steps, o.m_cap,
                               o.multiprobe, probes, probe_valid, window=self.plan.win,
                               align=self.plan.align)[:5]


def span_log(log):
    """A `span` that appends (depth, name) on every entry."""
    depth = [0]

    @contextlib.contextmanager
    def span(name):
        log.append((depth[0], name))
        depth[0] += 1
        try:
            yield
        finally:
            depth[0] -= 1

    return span


TIERS = {
    "lane": dict(),
    "pruned": dict(coarse_head_pool=16, coarse_keep=64),
    "folded": dict(coarse_layout="folded", max_candidates=4096, coarse_refine=512,
                   coarse_window=256, coarse_group=8, coarse_rows_keep=0, coarse_stage2=64),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_the_chain_branch_equals_the_eager_form(tier, monkeypatch):
    conf = CONF.replace(**TIERS[tier])
    forest, x = fitted(conf)
    st, layout = forest.state, forest.layout
    opts = F.query_options(conf, steps=1, probe_mode="margin", probe_budget=8)
    plan = F._coarse_plan(st, opts)
    assert plan.win > 0 and plan.prune == (tier == "pruned")
    assert plan.tier == ("folded" if tier == "folded" else "lane")
    qd = torch.from_numpy(x[:16] + np.float32(0.01))
    qi = torch.arange(16, dtype=torch.int32)
    F._query_chunk(st, qd, qi, layout, opts, plan, None)      # the probe constants' first use
    want_spans, got_spans = [], []
    monkeypatch.setattr(F, "span", span_log(want_spans))
    want = F._query_chunk(st, qd, qi, layout, opts, plan, None)
    monkeypatch.setattr(F, "span", span_log(got_spans))
    got = F._query_chunk(st, qd, qi, layout, opts, plan, EagerChain(st, layout, opts, plan))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert int((want[0] >= 0).sum()) > 0
    stages = ["rdf.hash", "rdf.candidates", "rdf.score", "rdf.select", "rdf.rerank"]
    if tier == "folded":
        stages.insert(4, "rdf.stage2")
    assert want_spans == [(0, name) for name in stages]
    cand = want_spans.index((0, "rdf.candidates"))
    assert got_spans == want_spans[:cand + 1] + [(1, "rdf.graph.replay")] + want_spans[cand + 1:]


OPTIONS_CONF = CONF.replace(top_k=7, max_candidates=16384, coarse_refine=300, coarse_window=128,
                            coarse_keep=9, coarse_head_pool=16, coarse_group=32,
                            coarse_rows_keep=2, coarse_select_mult=2, coarse_stage2=50)
# the config's options, as both surfaces passed them when no override is given
FROM_CONF = dict(k=7, m_cap=16384, coarse_refine=300, coarse_window=128, window_keep=9,
                 head_pool=16, coarse_group=32, rows_keep=2, select_mult=2, stage2=50)
PROBES = dict(steps=2, multiprobe=False, probe_mode="margin", probe_budget=5)
# (overrides, what they changed): 0 keeps the config's k, m_cap, coarse_refine,
# coarse_group and select_mult, and is a setting of the other four
OVERRIDES = {
    "absent": ({}, {}),
    "zero": (dict(k=0, m_cap=0, coarse_refine=0, coarse_window=0, window_keep=0,
                  coarse_group=0, rows_keep=0, select_mult=0, stage2=0),
             dict(coarse_window=0, window_keep=0, rows_keep=0, stage2=0)),
    "set": (dict(k=3, m_cap=8192, coarse_refine=96, coarse_window=256, window_keep=5,
                 coarse_group=16, rows_keep=1, select_mult=3, stage2=40),
            dict(k=3, m_cap=8192, coarse_refine=96, coarse_window=256, window_keep=5,
                 coarse_group=16, rows_keep=1, select_mult=3, stage2=40)),
}
# the overrides `ShardedRDFForest.query_kw` takes; the others are the config's
SHARDED = ("k", "window_keep", "rows_keep")


@pytest.mark.parametrize("surface", ["forest", "sharded"])
@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_the_config_maps_to_the_options_as_before(case, surface, monkeypatch):
    given, changed = OVERRIDES[case]
    if surface == "forest":
        seen = []

        def many(state, queries, query_ids, layout, chunk, opts):
            seen.append(opts)
            b = queries.shape[0]
            return (torch.zeros((b, opts.k), dtype=torch.int32), torch.zeros((b, opts.k)),
                    torch.zeros(b, dtype=torch.int64))

        monkeypatch.setattr(F, "_query_many", many)
        forest = RDFForest(OPTIONS_CONF, device="cpu")
        forest.state = "fitted"
        forest.query_device(np.zeros((3, 24), np.float32), query_ids=np.arange(3), **PROBES,
                            **given)
        (got,) = seen
        want = dict(FROM_CONF, **changed, exclude_self=True, **PROBES)
    else:
        forest = SF.ShardedRDFForest(OPTIONS_CONF, make_forest_mesh(devices=["cpu"] * 2))
        got = forest.query_kw(**PROBES, **{n: v for n, v in given.items() if n in SHARDED})
        want = dict(FROM_CONF, **{n: v for n, v in changed.items() if n in SHARDED},
                    exclude_self=True, **PROBES)
    assert got == F.QueryOptions(**want)
    assert dataclasses.asdict(got) == want
