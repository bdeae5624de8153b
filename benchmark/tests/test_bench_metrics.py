"""The end-to-end readers: the percentile is over all calls, failures count."""

import types

import numpy as np
import pytest

from benchmark.lib import cell, truth


def ctx(lat, answered=100, window_s=2.0):
    return types.SimpleNamespace(window={"latencies_s": lat, "answered": answered,
                                         "window_s": window_s})


def test_p95_over_all_calls():
    lat = [0.001 * i for i in range(1, 101)]           # 1 .. 100 ms
    got = cell.reader("latency_p95_ms").read(ctx(lat))
    assert got == pytest.approx(float(np.percentile(np.array(lat), 95)) * 1e3)
    assert got == pytest.approx(95.05)


def test_p95_takes_every_call_not_a_mean():
    lat = [0.010] * 90 + [0.100] * 10                  # a slow tail of 10 calls
    got = cell.reader("latency_p95_ms").read(ctx(lat))
    assert got == pytest.approx(100.0)


def test_failed_calls_count_as_infinite():
    lat = [0.010] * 90 + [float("inf")] * 10
    assert cell.reader("latency_p95_ms").read(ctx(lat)) == float("inf")


def test_qps_is_answers_over_window():
    assert cell.reader("qps").read(ctx([0.1], answered=1000, window_s=4.0)) == 250.0


def test_recall_over_every_answer():
    import torch

    ids = torch.tensor([[1, 2, 3], [4, 5, -1]])
    gt = torch.tensor([[3, 2, 9], [5, 4, 6]])
    assert truth.recall(ids, gt) == pytest.approx(4 / 6)


def test_exact_topk_is_exact():
    import torch

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1000, 16, generator=g)
    q = torch.randn(5, 16, generator=g)
    got = truth.exact_topk(x, q, 10, chunk=97)
    want = torch.topk(q @ x.T, 10, dim=1).indices
    assert torch.equal(got, want)

