"""flat_select_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.select` spans on the flat path
(`ops/flat.py` `flat_topk_grouped`): the argpack select
(`select_packed_rows`: the supergroup maxima, then two stable sorts of
keys, 1,024 x 4,880 and 1,024 x 4,096 at Deep-10M). None where the
program does not open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.select",))
