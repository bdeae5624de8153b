"""flat_rerank_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.rerank` spans on the flat path
(`ops/flat.py` `flat_topk_grouped`): the exact f32 re-score of the 128
candidate rows and their top-10 (`_exact_refine`, whose `top_sorted` is
the top-k kernel's f32 form on the card). None where the program does not
open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.rerank",))
