"""flat_sgtier_share.batch: of the program's `rdf.select` spans
(`utils/timing.py`) that start in the traced slice, the share holding an
`rdf.sgtier` span on the same thread: the flat engine's argpack selects
whose level 1 read the supergroup maxima K4 emitted (`ops/flat.py`
`select_packed_rows`) rather than a reduce over the [B, NG] key slab.
None where the slice has no `rdf.select` span, or no `rdf.sgtier` at all
(a program that does not emit the tier)."""

SELECT = "rdf.select"
TIER = "rdf.sgtier"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    lo, hi = t["window"]
    spans = [(e["name"], e.get("tid"), float(e["ts"]), float(e.get("dur", 0.0)))
             for e in t["events"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") in (SELECT, TIER) and lo <= float(e["ts"]) <= hi]
    selects = [s for s in spans if s[0] == SELECT]
    tiers = [s for s in spans if s[0] == TIER]
    if not selects or not tiers:
        return None
    held = sum(1 for _, tid, t0, dur in selects
               if any(tt == tid and t0 <= r0 <= t0 + dur for _, tt, r0, _ in tiers))
    return held / len(selects)
