"""On the card: a tiny run of each cell through the kernels is correct, and
its traced run reads every per-layer metric it lists. Skipped without a
card (`python -m pytest -m cuda benchmark/tests` on the GPU machine)."""

import time

import pytest

from benchmark.lib import cell, runner
from conftest import TINY, tiny_traffic

CELLS = ["dpf_glove100.batch", "ivf_deep96.batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(bench, cuda_device, name):
    traced = runner.run_cell(bench, name, 2**33 + 9, 0.5, True, cuda_device, time.perf_counter(),
                             overrides=TINY[name.split(".")[0]],
                             traffic_overrides=tiny_traffic(name))
    assert traced["correct"], traced["check"]
    assert traced["device"]["platform"] == "gpu" and traced["device"]["busy_s"] > 0
    want = {m["name"] for m in cell.metrics_of(bench, name, "per_layer")}
    assert set(traced["metrics"]) == want
