"""fold_score_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.score` spans on the folded forest path
(`index/forest.py` `_query_groupmax`): the int8 query, K3, the row mask
and the group max. None where the program does not open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.score",))
