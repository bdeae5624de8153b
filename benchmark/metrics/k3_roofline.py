"""k3_roofline: the folded row-max kernel K3's share (%) of its roofline
over the traced slice: the least time of the work every call's operands
define (`lib/rowmax_work.rowmax_work`: distinct folded rows of live
windows, small inputs and int32 outputs over the memory rate, or the int8
products over the int8 peak) over the device time of the kernels launched
inside the wrapper `ops/kernels/coarse_fold.coarse_rowmax_kernel` as the
forest module calls it. Counted from the operands, not from kernel names."""

from benchmark.lib import rowmax_work, trace

PORT = "similaritysearchbyrdf_tpu_torch"
NAME = "coarse_rowmax_kernel"
ARGS = ("folded", "qi8", "table", "row_start", "wpr", "rpg", "mshift", "emit2")
HOOKS = [{"range": "bench.k3", "record": True, "targets": [[f"{PORT}.index.forest", NAME]]}]


def read(ctx):
    t = ctx.trace
    calls = t["records"].get("bench.k3") if t is not None else None
    if not calls:
        return None
    device_s = trace.range_device_us(t["events"], "bench.k3", t["window"]) * 1e-6
    if device_s <= 0:
        return None
    bound_s = sum(rowmax_work.rowmax_work(**dict(zip(ARGS, args), **kw))["bound_s"]
                  for args, kw in calls)
    return 100.0 * bound_s / device_s
