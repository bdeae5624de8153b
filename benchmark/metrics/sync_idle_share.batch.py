"""sync_idle_share.batch: the share of the traced slice in device-idle gaps
that begin inside one of the program's `rdf.sync.<site>` spans
(`utils/timing.py`): the queue drained while the host waited on a copy.
The gaps are `device_idle_share.batch`'s (between the device events of the
slice, and from the last to the slice's end), so this is at most that
share; the rest of the idle time began while the host was dispatching."""

from bisect import bisect_right

from benchmark.lib import trace

SYNC = "rdf.sync."


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    lo, hi = t["window"]
    waits = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in t["events"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(SYNC))
    dev = sorted(trace.device_events(t["events"], t["window"]), key=lambda e: float(e["ts"]))
    if not waits or not dev or hi <= lo:
        return None
    ends, reach = [], float("-inf")          # the latest end of the waits so far
    for _, t1 in waits:
        reach = max(reach, t1)
        ends.append(reach)

    def waiting(at):
        i = bisect_right(waits, (at, float("inf"))) - 1
        return i >= 0 and at <= ends[i]

    idle, end = 0.0, lo
    for e in dev:
        t0 = float(e["ts"])
        if t0 > end and waiting(end):
            idle += t0 - end
        end = max(end, t0 + float(e["dur"]))
    if hi > end and waiting(end):
        idle += hi - end
    return idle / (hi - lo)
