"""The folded path's readers on made-up traces: device time inside each of
the folded stage spans, silence on a program without them, the K3 roofline
from recorded operands against a hand count, and the single cell's
dispatch reader."""

import types

import pytest
import torch

from benchmark.lib import cell, roofline, rowmax_work, trace

from test_bench_spans import ctx_of, read, span, two_calls
from test_bench_trace import kernel, launch

STAGES = ["rdf.hash", "rdf.candidates", "rdf.score", "rdf.select", "rdf.stage2", "rdf.rerank"]
READERS = {"fold_candidates_us_per_query": 10.0 + 20.0, "fold_score_us_per_query": 30.0,
           "fold_select_us_per_query": 40.0, "fold_stage2_us_per_query": 50.0,
           "fold_rerank_us_per_query": 60.0}


def folded_call(t0=0.0, names=STAGES):
    """One 400 us call of one chunk: each stage span launches one kernel of
    10, 20, ... 60 us, one after another; the answers' copy outside them."""
    ev = [span(trace.SLICE, t0, 400.0), span("rdf.query", t0, 390.0),
          span("rdf.chunk", t0 + 5.0, 300.0)]
    ts = t0 + 10.0
    for i, name in enumerate(names):
        dur = 10.0 * (i + 1)
        corr = 100 + i
        ev += [span(name, ts, 5.0), launch(ts + 1.0, corr), kernel(name, ts + 2.0, dur, corr)]
        ts += dur + 10.0
    ev += [span("rdf.sync.answers", t0 + 320.0, 20.0), launch(t0 + 321.0, 99),
           kernel("Memcpy DtoH", t0 + 330.0, 2.0, 99, cat="gpu_memcpy")]
    return ev


@pytest.mark.parametrize("name,us", sorted(READERS.items()))
def test_folded_stage_device_time_per_query(name, us):
    assert read(name, ctx_of(folded_call(), queries=4)) == pytest.approx(us / 4)


def test_folded_stages_sum_to_the_slice_less_the_copy():
    ctx = ctx_of(folded_call(), queries=4)
    total = sum(read(n, ctx) for n in READERS)
    busy = trace.busy_us(trace.device_events(ctx.trace["events"], ctx.trace["window"]))
    assert total * 4 == pytest.approx(busy - 2.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_folded_readers_silent_without_their_spans(name):
    """The parent's folded path opens `rdf.hash` alone: every folded
    reader, the candidates' too, reads nothing; so does a run without a
    trace."""
    parent = folded_call(names=["rdf.hash"])
    assert read(name, ctx_of(parent)) is None
    assert read(name, types.SimpleNamespace(trace=None)) is None


def folded_operands():
    """Two tables of 10 folded rows of 128 int8 lanes (cs 16, fold 8); one
    query, three windows of 4 rows: table 0 from row 2, table 0 from row 4
    (rows 4-5 shared), and a dead one."""
    folded = torch.zeros((2, 10, 128), dtype=torch.int8)
    qi8 = torch.zeros((1, 16), dtype=torch.int8)
    table = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    row_start = torch.tensor([[2, 4, -1]], dtype=torch.int32)
    return folded, qi8, table, row_start


def test_k3_work_by_hand():
    folded, qi8, table, row_start = folded_operands()
    got = rowmax_work.rowmax_work(folded, qi8, table, row_start, 4, 1, 3)
    # rows 2..7 of table 0: 6 x 128 B; qi8 16 B, table 12 B, row starts 12 B;
    # 3 windows x 4 rows x 4 B out; 2 ops a lane of the 2 live windows' 8 rows
    nbytes = 6 * 128 + 16 + 12 + 12 + 3 * 4 * 4
    ops = 2.0 * 2 * 4 * 128
    assert got == roofline.bound(nbytes, ops, "int8")
    assert got["bound_by"] == "bytes"
    assert rowmax_work.rowmax_work(folded, qi8, table, row_start, 4, 1, 3, True)["bytes"] == \
        nbytes + 3 * 4 * 4


def test_k3_roofline_from_recorded_calls():
    ops = folded_operands()
    ev = [span(trace.SLICE, 0.0, 100.0), span("bench.k3", 10.0, 5.0), launch(11.0, 1),
          kernel("k3", 20.0, 0.5, 1), span("bench.k3", 30.0, 5.0), launch(31.0, 2),
          kernel("k3", 40.0, 0.5, 2)]
    ctx = ctx_of(ev)
    ctx.trace["records"] = {"bench.k3": [(ops + (4, 1, 3), {}), (ops[:2], dict(
        table=ops[2], row_start=ops[3], wpr=4, rpg=1, mshift=3, emit2=False))]}
    one = rowmax_work.rowmax_work(*ops, 4, 1, 3)["bound_s"]
    assert read("k3_roofline", ctx) == pytest.approx(100.0 * 2 * one / 1e-6)
    ctx.trace["records"] = {}
    assert read("k3_roofline", ctx) is None


def test_dispatch_single_reads_as_batch():
    ctx = ctx_of(two_calls())
    assert read("dispatch_us_per_query.single", ctx) == read("dispatch_us_per_query.batch", ctx)
    assert read("dispatch_us_per_query.single", types.SimpleNamespace(trace=None)) is None


def test_k3_hook_wraps_the_forest_call():
    r = cell.reader("k3_roofline")
    assert r.HOOKS[0]["targets"] == [["similaritysearchbyrdf_tpu_torch.index.forest",
                                      "coarse_rowmax_kernel"]]
