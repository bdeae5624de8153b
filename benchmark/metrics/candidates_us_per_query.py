"""candidates_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.hash` and `rdf.candidates` spans
(`utils/timing.py`): the forest's K1, probe bits, partitions, bucket
lookup, dedup and priority sorts and flatten; IVF's centroid scores,
cluster select and window flatten. The spans do not overlap."""

from benchmark.lib import trace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = sum(trace.range_device_us(t["events"], name, t["window"])
             for name in ("rdf.hash", "rdf.candidates"))
    return us / t["queries"] if us > 0 else None
