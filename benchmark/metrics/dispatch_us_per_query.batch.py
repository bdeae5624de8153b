"""dispatch_us_per_query.batch: host microseconds per query inside the
program's `rdf.query` spans (one a call, `utils/timing.py`) that start in
the traced slice, less the host microseconds of the `rdf.sync.<site>` spans
inside them on the same thread: the host's own time of a call, spent
dispatching rather than waiting for the device."""

SYNC = "rdf.sync."


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    lo, hi = t["window"]
    spans = [(e.get("name", ""), e.get("tid"), float(e["ts"]), float(e.get("dur", 0.0)))
             for e in t["events"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("rdf.")]
    calls = [s for s in spans if s[0] == "rdf.query" and lo <= s[2] <= hi]
    if not calls:
        return None
    own = 0.0
    for _, tid, t0, dur in calls:
        own += dur - sum(d for n, td, s0, d in spans
                         if n.startswith(SYNC) and td == tid and t0 <= s0 <= t0 + dur)
    return own / t["queries"]
