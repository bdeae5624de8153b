"""fold_rerank_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.rerank` spans on the folded forest path
(`index/forest.py` `_query_groupmax`): the exact f32 re-score and top-k.
None where the program does not open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.rerank",))
