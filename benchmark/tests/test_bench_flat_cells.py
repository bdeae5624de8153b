"""The cell `flat_deep96.batch` at a tiny size on the CPU through the
harness's whole run, correct for the port and not for the control or a
planted fault; the flat path's readers on made-up traces (silent without
a trace or without the program's spans, K4's roofline from a hand
count)."""

import time
import types

import pytest

from benchmark import control
from benchmark.lib import cell, groupmax_work, roofline, runner, trace
from benchmark.reference import flat as flat_reference
from similaritysearchbyrdf_tpu_torch.ops import flat as port_flat
from test_bench_faults import broken, engine_of
from test_bench_spans import ctx_of, read, span
from test_bench_trace import kernel, launch

# 40,000 rows take the exact2 route; ARGPACK forces the argpack route the
# full size takes, as the port's and the reference's threshold both say
CELL = "flat_deep96.batch"
TINY = {"rows": 40000, "queries": 64}
TRAFFIC = {"queries_per_call": 16, "warmup_calls": 1, "trace_calls": 2, "checked_answers": 48}
FLAT = ["k4_roofline", "flat_score_us_per_query", "flat_select_us_per_query",
        "flat_rerank_us_per_query"]


@pytest.fixture
def argpack(monkeypatch):
    monkeypatch.setattr(port_flat, "_ARGPACK_MIN_ROWS", 1 << 15)
    monkeypatch.setattr(flat_reference, "ARGPACK_MIN_ROWS", 1 << 15)


def run(bench, seed, engine=None, trace_on=False, device="cpu"):
    return runner.run_cell(bench, CELL, seed, 0.3, trace_on, device, time.perf_counter(),
                           overrides=TINY, traffic_overrides=TRAFFIC, engine=engine)


@pytest.mark.parametrize("route", ["exact2", "argpack"])
def test_port_is_correct(bench, route, request):
    if route == "argpack":
        request.getfixturevalue("argpack")
    r = run(bench, 2**33 + 25)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["check"]["missing_share"]["value"] == 0.0


def test_control_is_not_correct(bench):
    r = run(bench, 2**33 + 27, engine=control.control_engine(engine_of(bench, CELL)))
    assert not r["correct"], r["check"]


def test_fault_is_not_correct(bench):
    r = run(bench, 2**33 + 28, engine=broken(engine_of(bench, CELL), "answer_altered"))
    assert not r["correct"], r["check"]


def test_traced_run_reports_what_a_cpu_trace_holds(bench):
    """The flat readers need device time, which a CPU trace has none of:
    they stay silent."""
    r = run(bench, 2**33 + 29, trace_on=True)
    assert r["correct"]
    assert r["metrics"] == {}


def test_flat_cell_lists_the_flat_metrics(bench):
    assert {m["name"] for m in cell.metrics_of(bench, CELL, "per_layer")} == set(FLAT)


def test_k4_work_by_hand():
    # 3 queries, 10,000 rows of 70 columns: the sketch is 16,384 x 96 (rows
    # to a multiple of 8,192, columns of 32), 256 groups of 64 rows
    got = groupmax_work.groupmax_work(3, 10_000, 70)
    nbytes = 16_384 * 96 + 3 * 96 + 3 * 256 * 4
    ops = 2.0 * 3 * 16_384 * 96
    assert got == roofline.bound(nbytes, ops, "int8")
    assert got["bound_by"] == "bytes"
    full = groupmax_work.groupmax_work(1024, 9_990_000, 96)
    assert full["bound_by"] == "operations"
    assert full["ops"] == 2.0 * 1024 * 9_994_240 * 96
    assert full["bound_s"] == pytest.approx(full["ops"] / roofline.PEAK["int8"])


def flat_calls(names=("rdf.score", "rdf.select", "rdf.rerank")):
    """Two 100 us calls of one chunk each: the stage spans launch kernels of
    30, 20 and 10 us, one after another."""
    ev = [span(trace.SLICE, 0.0, 200.0)]
    corr = 0
    for t0 in (0.0, 100.0):
        ev += [span("rdf.query", t0, 95.0), span("rdf.chunk", t0 + 2.0, 80.0)]
        ts = t0 + 5.0
        for name, dur in zip(names, (30.0, 20.0, 10.0)):
            corr += 1
            ev += [span(name, ts, 4.0), launch(ts + 1.0, corr),
                   kernel(name, ts + 2.0, dur, corr)]
            ts += dur + 5.0
    return ev


def flat_ctx(events, per=4):
    ctx = ctx_of(events, queries=2 * per)
    ctx.traffic = {"queries_per_call": per}
    ctx.cfg = {"rows": 10_000, "dim": 70}
    return ctx


@pytest.mark.parametrize("name,us", [("flat_score_us_per_query", 30.0),
                                     ("flat_select_us_per_query", 20.0),
                                     ("flat_rerank_us_per_query", 10.0)])
def test_flat_stage_device_time_per_query(name, us):
    assert read(name, flat_ctx(flat_calls())) == pytest.approx(2 * us / 8)


def test_k4_roofline_from_the_score_spans():
    one = groupmax_work.groupmax_work(4, 10_000, 70)["bound_s"]
    assert read("k4_roofline", flat_ctx(flat_calls())) == pytest.approx(
        100.0 * 2 * one / 60e-6)


@pytest.mark.parametrize("name", FLAT)
def test_flat_readers_silent_without_their_spans(name):
    """The parent's flat path opens no stage span: every flat reader reads
    nothing; so does a run without a trace."""
    assert read(name, flat_ctx(flat_calls(names=("aten::a", "aten::b", "aten::c")))) is None
    assert read(name, types.SimpleNamespace(trace=None)) is None


def test_flat_reference_loads_nothing_of_the_port():
    from test_bench_imports import FORBIDDEN, loaded

    names = loaded("import benchmark.reference.flat")
    assert "similaritysearchbyrdf_tpu_torch" not in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.cuda
def test_tiny_cell_on_the_card(bench, cuda_device):
    """Through the kernels, a traced tiny run is correct and reads every
    per-layer metric the cell lists (`python -m pytest -m cuda
    benchmark/tests` on the GPU machine)."""
    traced = run(bench, 2**33 + 30, trace_on=True, device=cuda_device)
    assert traced["correct"], traced["check"]
    assert traced["device"]["platform"] == "gpu" and traced["device"]["busy_s"] > 0
    assert set(traced["metrics"]) == set(FLAT)
    assert 0 < traced["metrics"]["k4_roofline"]["value"] <= 100
