"""fold_stage2_us_per_query: device microseconds per query of the kernels
launched inside the program's `rdf.stage2` spans on the folded forest path
(`index/forest.py` `_stage2`): the staged int8 re-score of the selected
groups' slots, the id dedup and the select of the best unique ids. None
where the program does not open the span."""

from benchmark.lib import stages


def read(ctx):
    return stages.us_per_query(ctx, ("rdf.stage2",))
