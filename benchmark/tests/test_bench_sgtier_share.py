"""The reader of the flat select's emitted-tier use, `flat_sgtier_share.batch`,
on made-up traces: every select reading the tier, some, and none."""

import types

import pytest

from benchmark.lib import trace

from test_bench_spans import ctx_of, read, span


def selects(tiers):
    """A 100 us slice of `len(tiers)` flat chunks of 10 us each, each with an
    `rdf.select` span, which holds an `rdf.sgtier` where `tiers[i]` is true."""
    ev = [span(trace.SLICE, 0.0, 100.0), span("rdf.query", 0.0, 100.0)]
    for i, tier in enumerate(tiers):
        t0 = 10.0 * i
        ev += [span("rdf.chunk", t0, 10.0), span("rdf.score", t0 + 1.0, 3.0),
               span("rdf.select", t0 + 4.0, 4.0)]
        if tier:
            ev.append(span("rdf.sgtier", t0 + 4.5, 1.0))
    return ev


def test_every_select_reads_the_tier():
    assert read("flat_sgtier_share.batch", ctx_of(selects([True] * 8))) == 1.0


def test_some_selects_read_the_tier():
    ctx = ctx_of(selects([False, True, True, True]))
    assert read("flat_sgtier_share.batch", ctx) == pytest.approx(0.75)
    # a tier span on another thread, or inside the score span, is not the select's
    ev = selects([False, True]) + [span("rdf.sgtier", 4.5, 1.0, tid=2),
                                   span("rdf.sgtier", 11.5, 1.0)]
    assert read("flat_sgtier_share.batch", ctx_of(ev)) == pytest.approx(0.5)


def test_no_tier_reads_nothing():
    # the select spans without a tier (a program that does not emit it), a
    # slice without select spans, and a run without a trace read nothing
    assert read("flat_sgtier_share.batch", ctx_of(selects([False] * 4))) is None
    no_select = [e for e in selects([True] * 2) if e["name"] != "rdf.select"]
    assert read("flat_sgtier_share.batch", ctx_of(no_select)) is None
    assert read("flat_sgtier_share.batch", types.SimpleNamespace(trace=None)) is None
