"""rerank_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.rerank` spans (`utils/timing.py`): the
forest's exact re-score and top-k, IVF's exact refine."""

from benchmark.lib import trace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = trace.range_device_us(t["events"], "rdf.rerank", t["window"])
    return us / t["queries"] if us > 0 else None
