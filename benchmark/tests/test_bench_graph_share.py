"""The reader of the forest's chunk-graph replays, `candidates_graph_share.batch`,
on made-up traces: every chunk replayed, some, and none."""

import types

import pytest

from benchmark.lib import trace

from test_bench_spans import ctx_of, read, span, two_calls


def replayed(chunks):
    """A 100 us slice of `chunks` chunks of 10 us each, each with an
    `rdf.candidates` span, which holds an `rdf.graph.replay` where
    `chunks[i]` is true."""
    ev = [span(trace.SLICE, 0.0, 100.0), span("rdf.query", 0.0, 100.0)]
    for i, replay in enumerate(chunks):
        t0 = 10.0 * i
        ev += [span("rdf.chunk", t0, 10.0), span("rdf.candidates", t0 + 2.0, 5.0)]
        if replay:
            ev.append(span("rdf.graph.replay", t0 + 3.0, 2.0))
    return ev


def test_every_chunk_replayed():
    assert read("candidates_graph_share.batch", ctx_of(replayed([True] * 8))) == 1.0


def test_some_chunks_replayed():
    ctx = ctx_of(replayed([False, True, True, True]))
    assert read("candidates_graph_share.batch", ctx) == pytest.approx(0.75)
    # a replay on another thread is not the stage's own
    ev = replayed([False, True]) + [span("rdf.graph.replay", 3.0, 2.0, tid=2)]
    assert read("candidates_graph_share.batch", ctx_of(ev)) == pytest.approx(0.5)


def test_no_replay_reads_nothing():
    # the stage spans without a replay (a program without the graphs), and a
    # slice without the stage spans, read nothing
    assert read("candidates_graph_share.batch", ctx_of(replayed([False] * 4))) is None
    assert read("candidates_graph_share.batch", ctx_of(two_calls()[:1])) is None
    assert read("candidates_graph_share.batch", types.SimpleNamespace(trace=None)) is None
