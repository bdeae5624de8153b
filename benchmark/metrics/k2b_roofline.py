"""k2b_roofline: the coarse window-score kernel K2b's share (%) of its
roofline over the traced slice: the least time of the work every call's
operands define (`lib/roofline.window_scores_work`: distinct tier rows,
small inputs and scores over the memory rate, or the products over the
bf16 peak) over the device time of the kernels launched inside the
wrapper `ops/kernels/coarse_gather.coarse_window_scores_kernel`, wherever
the program's modules call it. Counted from the operands, not from kernel
names, so any kernel behind the wrapper reads the same work."""

from benchmark.lib import roofline, trace

PORT = "similaritysearchbyrdf_tpu_torch"
NAME = "coarse_window_scores_kernel"
ARGS = ("tier", "q_low", "table", "blk_start", "start", "end", "live", "win")
HOOKS = [{"range": "bench.k2b", "record": True,
          "targets": [[f"{PORT}.index.forest", NAME], [f"{PORT}.ops.ivf", NAME],
                      [f"{PORT}.ops.flat", NAME]]}]


def read(ctx):
    t = ctx.trace
    calls = t["records"].get("bench.k2b") if t is not None else None
    if not calls:
        return None
    device_s = trace.range_device_us(t["events"], "bench.k2b", t["window"]) * 1e-6
    if device_s <= 0:
        return None
    bound_s = 0.0
    for args, kw in calls:
        ops = dict(zip(ARGS, args), **kw)
        bound_s += roofline.window_scores_work(*(ops[a] for a in ARGS))["bound_s"]
    return 100.0 * bound_s / device_s
