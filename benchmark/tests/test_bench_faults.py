"""`correct` on the harness's whole run at a tiny size on the CPU: true for
the port, false for the control (the reference one step of precision lower
in the program's place) and for each fault planted in the timed path."""

import types

import numpy as np
import pytest

from benchmark import control
from benchmark.lib import cell

CELLS = ["dpf_glove100.batch", "ivf_deep96.batch"]


def engine_of(bench, name):
    return cell.engine(cell.config(bench, cell.workload(bench, name)["config"]))


def broken(base, fault):
    """`base` with its query broken where the answer is produced."""

    def query(engine, cfg, queries):
        ids, scores = base.query(engine, cfg, queries)
        ids, scores = ids.copy(), scores.copy()
        if fault == "half_left_out":
            half = ids.shape[0] // 2             # the second half is never answered
            ids[half:], scores[half:] = -1, -np.inf
        elif fault == "answer_altered":
            ids[:, 0] = (ids[:, 0] + 1) % cfg["rows"]
        return ids, scores

    return types.SimpleNamespace(build=base.build, fit=base.fit, query=query,
                                 reference=base.reference, REF_BATCH=base.REF_BATCH)


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(bench, tiny_run, name):
    r = tiny_run(name, 2**33 + 5)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, tiny_run, name):
    r = tiny_run(name, 2**33 + 6, engine=control.control_engine(engine_of(bench, name)))
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(bench, tiny_run, name, fault):
    r = tiny_run(name, 2**33 + 7, engine=broken(engine_of(bench, name), fault))
    assert not r["correct"], r["check"]


def test_traced_run_reports_its_layer_metrics(bench, tiny_run):
    r = tiny_run("ivf_deep96.batch", 2**33 + 8, trace=True)
    assert r["correct"]
    assert "build_s" in r["metrics"] and "qps" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
