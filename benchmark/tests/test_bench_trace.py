"""The trace arithmetic on made-up traces: busy and idle time, launches,
device time inside a host range, the breakdown, and the K2b roofline."""

import types

import pytest
import torch

from benchmark.lib import cell, roofline, trace


def host(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def launch(ts, corr, tid=1):
    return host("cudaLaunchKernel", ts, 1.0, tid, cat="cuda_runtime", correlation=corr)


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def made_up():
    """A 100 us slice: two kernels launched inside a `sel` range (10 + 20 us
    of device time), one outside it (5 us), a 4 us memcpy overlapping the
    last kernel by 2 us, one kernel partly past the slice's end."""
    return [
        host(trace.SLICE, 0.0, 100.0, cat="user_annotation"),
        host("aten::sort", 1.0, 30.0),
        host("sel", 2.0, 20.0, cat="user_annotation"),
        launch(3.0, 1), launch(5.0, 2),
        host("aten::add", 40.0, 5.0),
        launch(41.0, 3),
        kernel("sortA", 10.0, 10.0, 1),
        kernel("sortB", 30.0, 20.0, 2),
        kernel("add", 60.0, 5.0, 3),
        kernel("Memcpy DtoH", 63.0, 4.0, 3, cat="gpu_memcpy"),
        launch(90.0, 4),
        kernel("tail", 95.0, 20.0, 4),
    ]


def test_busy_idle_and_launches():
    ev = made_up()
    span = trace.slice_range(ev)
    assert span == (0.0, 100.0)
    dev = trace.device_events(ev, span)
    # 10 + 20 + (60..67: 7) + 5 clipped of the tail
    assert trace.busy_us(dev) == pytest.approx(42.0)
    assert trace.kernel_count(dev) == 4
    ctx = types.SimpleNamespace(trace={"events": ev, "window": span, "queries": 8})
    assert trace.idle_share(ctx) == pytest.approx(1 - 42.0 / 100.0)
    assert trace.launches_per_query(ctx) == pytest.approx(0.5)


def test_range_device_time():
    ev = made_up()
    assert trace.range_device_us(ev, "sel", (0.0, 100.0)) == pytest.approx(30.0)
    # a launch on another thread at the same time is not inside the range
    ev2 = ev + [launch(4.0, 9, tid=2), kernel("other", 70.0, 3.0, 9)]
    assert trace.range_device_us(ev2, "sel", (0.0, 100.0)) == pytest.approx(30.0)


def test_breakdown():
    ev = made_up()
    br = trace.breakdown(ev, (0.0, 100.0))
    ops = dict(br["device_ops"])
    assert ops["sortB"] == pytest.approx(20e-6) and ops["add"] == pytest.approx(5e-6)
    gaps = dict(br["idle_gaps"])
    # gaps: 0..10 (ended by sortA, launched inside aten::sort), 20..30 (sortB,
    # aten::sort), 50..60 (add, launched inside aten::add), 67..95 (tail, no op)
    assert gaps["aten::sort"] == pytest.approx(20e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["host"] == pytest.approx(28e-6)
    assert sum(v for _, v in br["idle_gaps"]) == pytest.approx(58e-6)


def test_window_scores_work():
    # one table of 64 rows x 8 columns int8; two queries, one window each
    tier = torch.zeros((1, 64, 8), dtype=torch.int8)
    q = torch.zeros((2, 8), dtype=torch.bfloat16)
    z = torch.zeros((2, 1), dtype=torch.int32)
    blk = torch.tensor([[0], [8]], dtype=torch.int32)
    start = torch.tensor([[2], [8]], dtype=torch.int32)       # query 0 reads rows 2..15
    end = torch.tensor([[16], [24]], dtype=torch.int32)       # query 1 reads rows 8..23
    live = torch.ones((2, 1), dtype=torch.bool)
    got = roofline.window_scores_work(tier, q, z, blk, start, end, live, 16)
    distinct = 22                                            # rows 2..23
    small = 2 * 8 * 2 + 4 * 2 * 4 + 2
    assert got["bytes"] == distinct * 8 + small + 2 * 16 * 4
    assert got["ops"] == 2.0 * (14 + 16) * 8
    assert got["bound_s"] == pytest.approx(got["bytes"] / roofline.PEAK["bytes"])


def test_k2b_roofline_reader():
    reader = cell.reader("k2b_roofline")
    tier = torch.zeros((1, 64, 8), dtype=torch.int8)
    args = (tier, torch.zeros((1, 8), dtype=torch.bfloat16), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
            torch.full((1, 1), 64, dtype=torch.int32), torch.ones((1, 1), dtype=torch.bool), 64)
    ev = made_up()
    for e in ev:
        if e.get("name") == "sel":
            e["name"] = "bench.k2b"
    ctx = types.SimpleNamespace(trace={"events": ev, "window": (0.0, 100.0), "queries": 1,
                                       "records": {"bench.k2b": [(args, {})]}})
    bound = roofline.window_scores_work(*args)["bound_s"]
    assert reader.read(ctx) == pytest.approx(100.0 * bound / 30e-6)
    ctx.trace["records"] = {}
    assert reader.read(ctx) is None


def test_readers_silent_without_a_trace():
    ctx = types.SimpleNamespace(trace=None)
    for name in ("launches_per_query.batch", "device_idle_share.batch", "select_us_per_query",
                 "k2b_roofline"):
        assert cell.reader(name).read(ctx) is None
