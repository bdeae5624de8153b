"""k4_roofline: the flat engine's scoring stage's share (%) of K4's
roofline over the traced slice: the least time of the work the traced
calls define (`lib/groupmax_work.groupmax_work`: 2 x queries x padded rows
x padded columns int8 products over the int8 peak, or the sketch read
once, the int8 queries and the int32 group keys over the memory rate,
whichever is larger; counted from the configuration and the traffic) over
the device time of the kernels launched inside the program's `rdf.score`
spans (`ops/flat.py`: the int8 query, K4, the dead-group mask). None where
the program does not open the span."""

from benchmark.lib import groupmax_work, trace


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = trace.range_device_us(t["events"], "rdf.score", t["window"]) * 1e-6
    if device_s <= 0:
        return None
    per = ctx.traffic["queries_per_call"]
    calls = t["queries"] // per
    bound_s = calls * groupmax_work.groupmax_work(per, ctx.cfg["rows"],
                                                  ctx.cfg["dim"])["bound_s"]
    return 100.0 * bound_s / device_s
