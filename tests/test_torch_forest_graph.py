"""The forest query's chunk graphs, on the CPU: the probe constants cached
per device equal the values the chunk used to build inline, the per-owner
bookkeeping of `index/chunk_graphs.py` captures on a key's second use only
and forgets an owner with it, and a CPU query never captures. The graphs'
own answers are held against the eager path on the card
(`test_torch_forest_graph_cuda.py`)."""

import gc

import numpy as np
import pytest
import torch

from similaritysearchbyrdf_tpu_torch import DenseBatch, RDFConfig, RDFForest, TableConfig
from similaritysearchbyrdf_tpu_torch.index import chunk_graphs
from similaritysearchbyrdf_tpu_torch.index import forest as F
from similaritysearchbyrdf_tpu_torch.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu_torch.index.partitioner import stepwise_patterns


CONF = RDFConfig(vector_dim=24, table_num=4, permutation_num=2, family_size=40,
                 partition_bits=3, query_batch_size=16, max_candidates=32768, top_k=5,
                 seed=17, coarse_dim=16, coarse_dtype="int8", coarse_refine=128,
                 coarse_window=-1, lsh_table=TableConfig(chain_length=32, bucket_overflow=64))


def captured(owner):
    """How many keys of `owner` hold captured graphs."""
    return sum(g is not None for g in chunk_graphs._OWNERS.get(id(owner), {}).values())


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
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    forest = RDFForest(CONF, device="cpu").fit(DenseBatch(np.arange(2000, dtype=np.int32), x))
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
                    F._query_dense_eager(forest.state, qd, qi, forest.layout, **kw)):
        assert torch.equal(a, b)
