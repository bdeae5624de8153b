"""fold_candidates_us_per_query: device microseconds per query of the
kernels launched inside the program's `rdf.hash` and `rdf.candidates`
spans on the folded forest path (`index/forest.py` `_query_groupmax`):
K1 and the probe bits, partitions, bucket lookup, dedup and priority
sorts, flatten, window starts and liveness. None where the program does
not open both spans."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.hash", "rdf.candidates"))
