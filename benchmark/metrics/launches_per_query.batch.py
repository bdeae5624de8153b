"""launches_per_query.batch: CUDA kernels in the traced slice per query."""

from benchmark.lib.trace import launches_per_query as read  # noqa: F401
