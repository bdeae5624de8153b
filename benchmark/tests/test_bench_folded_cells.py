"""The two cells added beside the first two, `dpf_deep96_folded.batch` and
`ivf_deep96.single`, at a tiny size on the CPU through the harness's whole
run: correct for the port, not correct for the control and for a planted
fault, and a traced run reports the per-layer metrics a CPU trace can
read."""

import time

import pytest

from benchmark import control
from benchmark.lib import cell, runner
from test_bench_faults import broken, engine_of

# the folded configuration cut as tests/test_torch_folded_reference.py cuts it
TINY = {
    "dpf_deep96_folded": {"rows": 4000, "queries": 64,
                          "index": {"max_candidates": 8192, "coarse_refine": 1024,
                                    "coarse_stage2": 32,
                                    "lsh_table": {"chain_length": 32, "bucket_overflow": 64}}},
    "ivf_deep96": {"rows": 6000, "queries": 64},
}
TRAFFIC = {"batch": {"queries_per_call": 16, "warmup_calls": 1, "trace_calls": 2,
                     "checked_answers": 48},
           "single": {"queries_per_call": 1, "warmup_calls": 2, "trace_calls": 4,
                      "checked_answers": 48}}
CELLS = ["dpf_deep96_folded.batch", "ivf_deep96.single"]


def run(bench, name, seed, engine=None, trace=False):
    spec = cell.workload(bench, name)
    return runner.run_cell(bench, name, seed, 0.3, trace, "cpu", time.perf_counter(),
                           overrides=TINY[spec["config"]],
                           traffic_overrides=TRAFFIC[spec["traffic"]], engine=engine)


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(bench, name):
    r = run(bench, name, 2**33 + 15)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["check"]["missing_share"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    r = run(bench, name, 2**33 + 16, engine=control.control_engine(engine_of(bench, name)))
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(bench, name):
    r = run(bench, name, 2**33 + 17, engine=broken(engine_of(bench, name), "answer_altered"))
    assert not r["correct"], r["check"]


def test_single_traffic_sends_one_query_a_call(bench):
    t = cell.traffic("single")
    assert t["queries_per_call"] == 1 and t["clients"] == 1 and t["loop"] == "closed"
    r = run(bench, "ivf_deep96.single", 2**33 + 18)
    assert r["attempted"] >= 2


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_what_a_cpu_trace_holds(bench, name):
    """The folded cell's stage and K3 readers need device time, which a CPU
    trace has none of: they stay silent. The single cell's dispatch reads
    host spans."""
    r = run(bench, name, 2**33 + 19, trace=True)
    assert r["correct"]
    want = {"ivf_deep96.single": {"dispatch_us_per_query.single"},
            "dpf_deep96_folded.batch": set()}[name]
    assert set(r["metrics"]) == want
    assert all(r["metrics"][m]["value"] > 0 for m in want)


def test_folded_reference_loads_nothing_of_the_port():
    from test_bench_imports import FORBIDDEN, loaded

    names = loaded("import benchmark.reference.forest_folded")
    assert "similaritysearchbyrdf_tpu_torch" not in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(bench, cuda_device, name):
    """Through the kernels, a traced tiny run is correct and reads every
    per-layer metric its cell lists (`python -m pytest -m cuda
    benchmark/tests` on the GPU machine)."""
    spec = cell.workload(bench, name)
    traced = runner.run_cell(bench, name, 2**33 + 20, 0.5, True, cuda_device,
                             time.perf_counter(), overrides=TINY[spec["config"]],
                             traffic_overrides=TRAFFIC[spec["traffic"]])
    assert traced["correct"], traced["check"]
    assert traced["device"]["platform"] == "gpu" and traced["device"]["busy_s"] > 0
    want = {m["name"] for m in cell.metrics_of(bench, name, "per_layer")}
    assert set(traced["metrics"]) == want
    if "k3_roofline" in want:
        assert 0 < traced["metrics"]["k3_roofline"]["value"] <= 100
