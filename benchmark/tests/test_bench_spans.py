"""The readers of the program's own spans (`rdf.*`, `utils/timing.py` of the
port) on made-up traces: device time inside the stage spans, host syncs
per call, idle gaps that begin inside a sync span, and the host's own time
of a call."""

import types

import pytest

from benchmark.lib import cell, trace

from test_bench_trace import host, kernel, launch, made_up


def span(name, ts, dur, tid=1):
    return host(name, ts, dur, tid, cat="user_annotation")


def two_calls():
    """A 200 us slice of two calls (8 queries), each an upload, a chunk of
    hash, candidates and rerank, and the answers' copy. Device: 10-20 and
    25-35 (hash, candidates), 45-55 (rerank), 70-72 (the copy), then the
    second call's 120-130, 160-170, 170-175, 176-178. Idle gaps: 0-10,
    20-25, 35-45, 55-70, 130-160 begin while the host dispatches; 72-120,
    175-176 and the tail 178-200 begin inside an `rdf.sync.answers`."""
    return [
        span(trace.SLICE, 0.0, 200.0),
        span("rdf.query", 0.0, 100.0),
        span("rdf.sync.upload", 1.0, 3.0),
        span("rdf.chunk", 5.0, 55.0),
        span("rdf.hash", 6.0, 14.0), launch(7.0, 1),
        span("rdf.candidates", 20.0, 20.0), launch(21.0, 2),
        span("rdf.rerank", 40.0, 15.0), launch(41.0, 3),
        span("rdf.sync.answers", 60.0, 30.0), launch(61.0, 4),
        kernel("k1", 10.0, 10.0, 1), kernel("cand", 25.0, 10.0, 2),
        kernel("rerank", 45.0, 10.0, 3), kernel("Memcpy DtoH", 70.0, 2.0, 4, cat="gpu_memcpy"),
        span("rdf.query", 100.0, 90.0),
        span("rdf.sync.upload", 101.0, 3.0),
        span("rdf.chunk", 105.0, 45.0),
        span("rdf.hash", 106.0, 4.0), launch(107.0, 5),
        span("rdf.candidates", 110.0, 30.0), launch(111.0, 6),
        span("rdf.rerank", 140.0, 10.0), launch(141.0, 7),
        span("rdf.sync.answers", 150.0, 35.0), launch(151.0, 8),
        kernel("k1", 120.0, 10.0, 5), kernel("cand", 160.0, 10.0, 6),
        kernel("rerank", 170.0, 5.0, 7), kernel("Memcpy DtoH", 176.0, 2.0, 8, cat="gpu_memcpy"),
        # a call after the slice: not counted
        span("rdf.query", 300.0, 50.0), span("rdf.sync.upload", 301.0, 3.0),
    ]


def ctx_of(events, queries=8):
    return types.SimpleNamespace(trace={"events": events, "window": trace.slice_range(events),
                                        "queries": queries, "records": {}})


def read(name, ctx):
    return cell.reader(name).read(ctx)


def test_stage_device_time_per_query():
    ctx = ctx_of(two_calls())
    # K1 and candidates: 10 + 10 + 10 + 10 us over 8 queries
    assert read("candidates_us_per_query", ctx) == pytest.approx(40.0 / 8)
    assert read("rerank_us_per_query", ctx) == pytest.approx(15.0 / 8)


def test_host_syncs_per_call():
    # two calls in the slice, each an upload and an answers' copy
    assert read("host_syncs_per_call.batch", ctx_of(two_calls())) == 2.0


def test_sync_idle_share():
    ctx = ctx_of(two_calls())
    got = read("sync_idle_share.batch", ctx)
    # 72-120, 175-176 and 178-200 begin inside a sync; 130-160 (dispatch) does not
    assert got == pytest.approx((48.0 + 1.0 + 22.0) / 200.0)
    busy = 10 + 10 + 10 + 2 + 10 + 10 + 5 + 2
    assert trace.idle_share(ctx) == pytest.approx(1 - busy / 200.0)
    assert got <= trace.idle_share(ctx)


def test_dispatch_subtracts_the_sync_children():
    ctx = ctx_of(two_calls())
    # (100 - 3 - 30) + (90 - 3 - 35) host us over 8 queries
    assert read("dispatch_us_per_query.batch", ctx) == pytest.approx((67.0 + 52.0) / 8)
    # a sync on another thread inside the call is not the call's child
    ev = two_calls() + [span("rdf.sync.upload", 10.0, 5.0, tid=2)]
    assert read("dispatch_us_per_query.batch", ctx_of(ev)) == pytest.approx((67.0 + 52.0) / 8)


SPAN_READERS = ("candidates_us_per_query", "rerank_us_per_query", "host_syncs_per_call.batch",
                "sync_idle_share.batch", "dispatch_us_per_query.batch")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_silent_without_spans(name):
    """A program without the spans (the parent of this change) reads
    nothing, and so does a run without a trace."""
    assert read(name, ctx_of(made_up())) is None
    assert read(name, types.SimpleNamespace(trace=None)) is None
