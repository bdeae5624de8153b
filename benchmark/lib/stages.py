"""Device time inside the program's own stage spans (`rdf.*`, the port's
`utils/timing.py`), for the readers of one path's stages."""

from __future__ import annotations

from typing import Iterable, Optional

from . import trace


def span_names(events, window) -> set:
    """The names of the host spans that start inside `window`."""
    lo, hi = window
    return {e.get("name") for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and lo <= float(e["ts"]) <= hi}


def us_per_query(ctx, names: Iterable[str]) -> Optional[float]:
    """Device microseconds per query of the kernels launched inside the
    spans `names` over the traced slice; None without a trace, where any
    of the spans is missing from it (a program that does not open them),
    or where they launched nothing."""
    t = ctx.trace
    names = tuple(names)
    if t is None or not set(names) <= span_names(t["events"], t["window"]):
        return None
    us = sum(trace.range_device_us(t["events"], n, t["window"]) for n in names)
    return us / t["queries"] if us > 0 else None
