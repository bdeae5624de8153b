"""host_syncs_per_call.batch: the program's `rdf.sync.<site>` spans (one a
host wait: a copy between host and device, `utils/timing.py`) that start in
the traced slice, over the `rdf.query` spans (calls) that start in it."""

SYNC = "rdf.sync."


def _starts(t, match):
    lo, hi = t["window"]
    return sum(1 for e in t["events"]
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and match(e.get("name", "")) and lo <= float(e["ts"]) <= hi)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    calls = _starts(t, lambda n: n == "rdf.query")
    return _starts(t, lambda n: n.startswith(SYNC)) / calls if calls else None
