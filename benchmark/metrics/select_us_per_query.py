"""select_us_per_query: device microseconds per query of the kernels launched
inside `ops/rerank.top_sorted` (the stable sorts of every select: the
forest's top-m2 and dedup, IVF's centroid and window selects, the refine's
top-k), wherever the program's modules call it."""

from benchmark.lib import trace

PORT = "similaritysearchbyrdf_tpu_torch"
HOOKS = [{"range": "bench.select",
          "targets": [[f"{PORT}.ops.rerank", "top_sorted"], [f"{PORT}.ops.ivf", "top_sorted"],
                      [f"{PORT}.ops.flat", "top_sorted"]]}]


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = trace.range_device_us(t["events"], "bench.select", t["window"])
    return us / t["queries"] if us > 0 else None
