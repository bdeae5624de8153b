"""dispatch_us_per_query.single: the reading of
`dispatch_us_per_query.batch` (host microseconds per query inside the
program's `rdf.query` spans, less their `rdf.sync.<site>` children) on
the single-query cells, where a call is one query."""

from benchmark.lib import cell


def read(ctx):
    return cell.reader("dispatch_us_per_query.batch").read(ctx)
