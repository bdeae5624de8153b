"""latency_p95_ms: the 95th percentile, linear between ranks, of every
call's time in the window, a failed call counting as infinite (host clock;
a call runs from the call until its ids and scores are on the host)."""

import math


def percentile(values, p: float) -> float:
    s = sorted(values)
    if not s:
        return float("nan")
    h = (len(s) - 1) * p / 100.0
    lo = math.floor(h)
    if lo + 1 >= len(s):
        return s[lo]
    if math.isinf(s[lo + 1]):
        return float("inf")
    return s[lo] + (h - lo) * (s[lo + 1] - s[lo])


def read(ctx):
    lat = ctx.window["latencies_s"]
    return percentile(lat, 95.0) * 1e3 if lat else None
