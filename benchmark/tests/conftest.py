"""Shared fixtures of the benchmark's own tests (CPU unless marked `cuda`)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes of both configurations, and of the traffic, for runs on the CPU
TINY = {
    "dpf_glove100": {"rows": 3000, "queries": 64,
                     "index": {"query_batch_size": 16, "max_candidates": 32768,
                               "coarse_refine": 256}},
    "ivf_deep96": {"rows": 6000, "queries": 64},
}


def tiny_traffic(cell: str) -> dict:
    return {"queries_per_call": 16, "warmup_calls": 1, "trace_calls": 2,
            "checked_answers": 48}


@pytest.fixture(scope="session")
def bench():
    from benchmark.lib import cell

    return cell.benchmark()


@pytest.fixture
def tiny_run(bench):
    """Runs a cell at a tiny size on the CPU: (cell, seed, engine=None,
    trace=False) → the result dict."""
    from benchmark.lib import runner

    def run(cell, seed, engine=None, trace=False, seconds=0.3):
        cfg_name = cell.split(".")[0]
        return runner.run_cell(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                               overrides=TINY[cfg_name], traffic_overrides=tiny_traffic(cell),
                               engine=engine)

    return run


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
