"""flat_score_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.score` spans on the flat path
(`ops/flat.py` `flat_topk_grouped`): the int8 query, K4 (each 64-row
group's best row packed into an int32 key) and the dead-group mask. None
where the program does not open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.score",))
