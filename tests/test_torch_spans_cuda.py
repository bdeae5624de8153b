"""Every host wait of the two benchmarked query paths lies in an `rdf.sync` span.

In a profiled 1,024-query call of `RDFForest.query` (window mode, margin
probes, the benchmark's dpf_glove100 settings) and of
`IVFFlatIndex.query` (its defaults) on the card, each synchronising CUDA
runtime call on the calling thread (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, a blocking `cudaMemcpy*`)
lies inside an `rdf.sync.<site>` span, so counting those spans misses no
wait; so do those of a cold forest call's chunk-graph capture. Prints the
counts it found. Needs an NVIDIA GPU; run on the card without the suite's
conftest, which imports jax:

    python -m pytest --noconftest -q -s -m cuda tests/test_torch_spans_cuda.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from similaritysearchbyrdf_tpu_torch import (DenseBatch, IVFFlatIndex, RDFConfig, RDFForest,
                                             TableConfig)

pytestmark = pytest.mark.cuda
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def data(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(512, d))
    x = centers[rng.integers(0, 512, n)] + 0.3 * rng.normal(size=(n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return DenseBatch(np.arange(n, dtype=np.int32), x), x[rng.integers(0, n, 1024)]


def forest_call(dev):
    batch, q = data(200_000, 100, 1)
    conf = RDFConfig(vector_dim=100, table_num=10, permutation_num=3, family_size=100,
                     generate_by_pulling=True, is_orthogonal=True, partition_bits=3,
                     fit_batch_size=8192, query_batch_size=128, max_candidates=65536,
                     top_k=10, seed=31258, coarse_dim=32, coarse_dtype="int8",
                     coarse_refine=1024, coarse_window=-1,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=500))
    forest = RDFForest(conf, device=dev).fit(batch)
    return lambda: forest.query(q, k=10, steps=0, probe_mode="margin", probe_budget=16)


def ivf_call(dev):
    batch, q = data(200_000, 96, 2)
    ivf = IVFFlatIndex(device=dev).fit(batch)
    return lambda: ivf.query(q, k=10)


def waits_outside_syncs(events):
    """(host waits of the call on its thread, rdf.sync spans, the waits
    outside them)."""
    x = [e for e in events if e.get("ph") == "X"]
    call = [e for e in x if e.get("cat") == "user_annotation" and e["name"] == "rdf.query"]
    assert len(call) == 1
    tid, t0 = call[0]["tid"], float(call[0]["ts"])
    t1 = t0 + float(call[0]["dur"])
    syncs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in x
             if e.get("cat") == "user_annotation" and e["name"].startswith("rdf.sync.")
             and e["tid"] == tid]
    waits = [e for e in x if e.get("cat") == "cuda_runtime" and e["tid"] == tid
             and t0 <= float(e["ts"]) <= t1
             and (e["name"] in WAITS
                  or (e["name"].startswith("cudaMemcpy") and "Async" not in e["name"]))]
    outside = [e for e in waits
               if not any(s0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= s1
                          for s0, s1 in syncs)]
    return waits, syncs, outside


@pytest.mark.parametrize("engine", ["forest", "ivf", "forest_capture"])
def test_every_host_wait_is_in_a_sync_span(engine, dev, tmp_path):
    """forest_capture profiles a cold forest's first call, whose second
    chunk captures the chunk graphs (`rdf.sync.graph_capture`)."""
    call = (ivf_call if engine == "ivf" else forest_call)(dev)
    if engine != "forest_capture":
        call()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    waits, syncs, outside = waits_outside_syncs(events)
    names = sorted({e["name"] for e in waits})
    print(f"\n{engine}: {len(waits)} host waits ({', '.join(names)}) in "
          f"{len(syncs)} rdf.sync spans; outside them: {len(outside)}")
    assert syncs and waits
    assert not outside, [(e["name"], innermost(events, e)) for e in outside[:10]]
    captures = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"] == "rdf.sync.graph_capture"]
    assert len(captures) == (engine == "forest_capture")


def innermost(events, wait):
    """The names of the host ranges open round `wait` on its thread,
    outermost first: where an unspanned wait comes from."""
    t = float(wait["ts"])
    open_ = [e for e in events if e.get("ph") == "X" and e.get("tid") == wait["tid"]
             and e.get("cat") in ("cpu_op", "user_annotation")
             and float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    return [e["name"] for e in sorted(open_, key=lambda e: float(e["ts"]))]


FOLDED = ["rdf.hash", "rdf.candidates", "rdf.score", "rdf.select", "rdf.stage2", "rdf.rerank"]


def folded_call(dev):
    """The dpf_deep96_folded benchmark's query options on 200,000 rows."""
    batch, q = data(200_000, 96, 3)
    conf = RDFConfig(vector_dim=96, table_num=10, permutation_num=3, family_size=100,
                     generate_by_pulling=True, is_orthogonal=True, partition_bits=3,
                     fit_batch_size=8192, query_batch_size=128, max_candidates=65536,
                     top_k=10, seed=31258, coarse_dim=16, coarse_dtype="int8",
                     coarse_layout="folded", coarse_window=512, coarse_group=8,
                     coarse_rows_keep=0, coarse_refine=4096, coarse_stage2=1024,
                     lsh_table=TableConfig(chain_length=32, bucket_overflow=2000))
    forest = RDFForest(conf, device=dev).fit(batch)
    return lambda: forest.query(q, k=10, steps=1, probe_mode="margin", probe_budget=16)


def test_folded_query_spans_on_the_card(dev, tmp_path):
    """A warm folded call through K3: each 128-query chunk opens the folded
    stages once and in order, and every host wait lies in an `rdf.sync`
    span."""
    call = folded_call(dev)
    call()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    waits, syncs, outside = waits_outside_syncs(events)
    assert syncs and not outside, [(e["name"], innermost(events, e)) for e in outside[:10]]
    spans = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("rdf.")), key=lambda e: float(e["ts"]))
    chunks = [e for e in spans if e["name"] == "rdf.chunk"]
    assert len(chunks) == 8
    for c in chunks:
        t0, t1 = float(c["ts"]), float(c["ts"]) + float(c["dur"])
        stages = [e["name"] for e in spans if e["name"] in FOLDED and e["tid"] == c["tid"]
                  and t0 <= float(e["ts"]) <= t1]
        assert stages == FOLDED
