"""candidates_graph_share.batch: of the program's `rdf.candidates` spans
(`utils/timing.py`) that start in the traced slice, the share holding an
`rdf.graph.replay` span on the same thread: the forest chunks whose hash
and candidates stages ran as CUDA graph replays rather than eager launches.
None where the slice has no `rdf.candidates` span, or no replay at all (a
program without the chunk graphs)."""

CANDIDATES = "rdf.candidates"
REPLAY = "rdf.graph.replay"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    lo, hi = t["window"]
    spans = [(e["name"], e.get("tid"), float(e["ts"]), float(e.get("dur", 0.0)))
             for e in t["events"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in (CANDIDATES, REPLAY) and lo <= float(e["ts"]) <= hi]
    stages = [s for s in spans if s[0] == CANDIDATES]
    replays = [s for s in spans if s[0] == REPLAY]
    if not stages or not replays:
        return None
    held = sum(1 for _, tid, t0, dur in stages
               if any(rt == tid and t0 <= r0 <= t0 + dur for _, rt, r0, _ in replays))
    return held / len(stages)
